"""Multi-GPU execution over torch.distributed: the (dp, pp, tp, sp) mesh,
tensor-parallel slicing, context-parallel attention, pipeline stages and
the collectives (counterpart of quickvideo_tpu/parallel/)."""
