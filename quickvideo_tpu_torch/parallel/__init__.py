"""Multi-GPU execution over torch.distributed: the (dp, pp, tp, sp) mesh,
tensor-parallel slicing, context-parallel attention and the collectives
(counterpart of quickvideo_tpu/parallel/, without pipeline parallelism)."""
