"""quickvideo_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of
quickvideo_tpu.

The JAX package stays the reference; this package mirrors its layout
(ops/, models/qwen25_vl/, prefill/, engines/, video/, utils/, api.py) and
imports neither jax nor any module of the JAX package: what it needs of
that package's jax-free modules (config.py, models/qwen25_vl/config.py,
tokenization.py, video/{preprocess, quickdecode, reader, cv2_reader}.py)
it keeps as copies, which tests/test_torch_copies.py pins to the
originals. Kernels are hand-written CUDA C++ for sm_90a under csrc/,
built at first use by _build.py.
"""
