"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, all started together; the objects are linked
into ONE shared library with a plain C interface, loaded with `ctypes`. No
PyTorch headers are included, so a cold build takes seconds, not the minutes
that `torch.utils.cpp_extension.load` needs.

The library lands in `quickvideo_tpu_torch/build/` (git-ignored) under a name
keyed by a hash of the sources and flags: an edited kernel rebuilds, an
unchanged one is reused. Nothing here runs at import time; the first kernel
launch calls `library()`. A failed build raises — there is no fallback.

Every C entry point returns `cudaGetLastError()` after its launches; `check`
turns a non-zero code into a RuntimeError with CUDA's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the library's entry points (csrc/*.cu). Every pointer and
# the stream are c_void_p: a bare Python int would be passed as a 32-bit int.
SIGNATURES = {
    # B1's prefill kernels: q, qs, k, ksc, v, vsc, o, lse, part_o,
    # part_ml; strides (q_sh, q_st, k_sh, k_st, v_sh, v_st, o_sh, o_st,
    # lse_sh, lse_st, ks_sh, vs_sh); hq, hkv, g, length, cap, n_split,
    # past, with_lse, out_f32; scale; stream
    "qv_flash_prefill": [_P] * 10 + [_L] * 12 + [_I] * 9 + [_F, _P],
    # B1's decode kernel: as qv_flash_prefill
    "qv_flash_decode": [_P] * 10 + [_L] * 12 + [_I] * 9 + [_F, _P],
    # kernel index; out: registers, local bytes, static and dynamic smem
    "qv_flash_kernel_info": [_I] + [_P] * 4,
    # q, k, v, o, cos, sin (bf16 tables); row strides (q, k, v, o,
    # cos/sin); s, nh, span (<= 64); scale; stream
    "qv_vision_attention": (
        [_P] * 6 + [_L] * 5 + [_I] * 3 + [_F, _P]
    ),
    # q, k, v, o, valid (or null); row strides (q, k, v, o); s, nh, span;
    # scale; stream
    "qv_block_diag_attention": [_P] * 5 + [_L] * 4 + [_I] * 3 + [_F, _P],
    # q, k, cos, sin, q out, k out; row strides (q, k, cos/sin, q out,
    # k out); s, nh; stream
    "qv_vision_rotary": [_P] * 6 + [_L] * 5 + [_I] * 2 + [_P],
    # kernel index; out: registers, local bytes, static and dynamic smem
    "qv_vision_kernel_info": [_I] + [_P] * 4,
    # x, ln_w, w, sc, b, xq, xs, out; s, c, n; eps; grid; stream
    "qv_ln_gemm_bias": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # x, ln_w, w, sc, b, xq, xs, q, s; rows, c, np; eps; chunk, cluster,
    # nch, stages; stream
    "qv_ln_dual_gemm_silu_quant": [_P] * 9 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    # xq, xs, w, sc, b, q, s; rows, c, np, chunk, cluster, nch, stages;
    # stream
    "qv_dual_gemm_silu_quant": [_P] * 7 + [_I] * 7 + [_P],
    # kernel index; out: registers, local bytes, static and dynamic smem
    "qv_fused_kernel_info": [_I] + [_P] * 4,
    # chunk, cluster, nch, stages; out: resident clusters
    "qv_fused_max_clusters": [_I] * 4 + [_P],
    # the language model's int8 glue (csrc/int8_glue.cu). x, row stride,
    # ln_w, xq, xs; m, c; eps; stream
    "qv_rms_quantize": [_P, _L, _P, _P, _P, _I, _I, _F, _P],
    # x, row stride, xq, xs; m, c; stream
    "qv_quantize_rows": [_P, _L, _P, _P, _I, _I, _P],
    # acc, row stride, xs, sc, bias (or null), residual (or null), its row
    # stride, out; m, n; stream
    "qv_rescale": [_P, _L, _P, _P, _P, _P, _L, _P, _I, _I, _P],
    # g, row stride, u, row stride, xs, sc_g, sc_u, mq, ms; m, n; stream
    "qv_swiglu_quantize": [_P, _L, _P, _L] + [_P] * 5 + [_I, _I, _P],
    # kernel index; out: registers, local bytes, static and dynamic smem
    "qv_glue_kernel_info": [_I] + [_P] * 4,
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "quickvideo_tpu_torch are built from source at first use"
    )


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the build directory (skipped when the library
    for this source hash exists): one nvcc per source in parallel, then one
    link. Returns the library path. Raises on any compiler error, with the
    compiler's output in the message."""
    out = BUILD_DIR / f"libqv_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for cu in sorted(SRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp, cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", obj,
                   str(cu)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, _, proc in procs]
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}"
                )
            if verbose and log:
                print(log)
        # link under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a half-written library in place
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *[obj for _, obj, _ in procs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(lib, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.qv_error_string.argtypes = [ctypes.c_int]
            lib.qv_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().qv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
