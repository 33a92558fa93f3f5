"""quickvideo_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of
quickvideo_tpu.

The JAX package stays the reference; this package mirrors its layout
(ops/, models/qwen25_vl/, prefill/, engines/, video/, serving/, utils/,
api.py, lvu_cli.py) and imports neither jax nor any module of the JAX
package: what it needs of that package's jax-free modules (config.py,
models/qwen25_vl/config.py, tokenization.py, video/{preprocess,
quickdecode, reader, cv2_reader, frame_cache}.py, evaluation/qa.py) it
keeps as copies, which tests/test_torch_copies.py pins to the originals.
Kernels are hand-written CUDA C++ for sm_90a under csrc/, built at first
use by _build.py.

Public API as the JAX package's: `LVU`, `LVUConfig`, `LVULayerConfig`.
"""

from quickvideo_tpu_torch.config import LVUConfig, LVULayerConfig

__version__ = "0.1.0"

__all__ = ["LVU", "LVUConfig", "LVULayerConfig"]


def __getattr__(name):
    # LVU pulls in torch and the model stack: keep `import
    # quickvideo_tpu_torch` cheap for config-only users (CLI help)
    if name == "LVU":
        from quickvideo_tpu_torch.api import LVU

        return LVU
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
