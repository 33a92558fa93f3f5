"""Published H100 peaks and the roofline arithmetic (a frozen copy of
chip_smoke.py's `bound` and `flash_bound`).

A kernel's bound is the larger of its bytes (each input read once, each
output written once) over the memory rate and its operations over the
peak rate of their type. Peaks of one H100 SXM: NVIDIA's data sheet,
dense, at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def bound(nbytes: float, ops: dict):
    """(bound ms, "bytes" or "operations") for `nbytes` moved and `ops`
    operations by type ("bf16", "int8")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"
    )


def peak_seconds(ops: dict) -> float:
    """The least time the card's peaks allow for `ops` by type."""
    return sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items())


def flash_bound(g, length, variant="bf16", causal=True, out_bytes=2,
                with_lse=False, hq=28, hkv=4, d=128):
    """B1's bound: q (bf16) read, the attended slots' K and V (and scales)
    read, out (and lse) written; QK and PV over the attended (row, slot)
    pairs, QK at the int8 rate on the int8-QK route."""
    n = length + g if causal else length
    pairs = g * length + (g * (g + 1) // 2 if causal else 0)
    k_b, v_b = {"bf16": (2 * d, 2 * d), "int8": (d + 4, d + 4),
                "int8k": (d + 4, 2 * d)}[variant]
    moved = (hq * g * d * 2 + hkv * n * (k_b + v_b) + hq * g * d * out_bytes
             + (hq * g * 4 if with_lse else 0))
    prod = 2 * hq * d * pairs
    ops = ({"bf16": 2 * prod} if variant == "bf16"
           else {"int8": prod, "bf16": prod})
    return bound(moved, ops)


def int8_gemm_bound(rows: int, k: int, n: int, in_bytes: int = 2,
                    out_bytes: float = 2):
    """An int8 product of `rows` activation rows (read in `in_bytes` a
    value) against a (k, n) int8 weight with f32 scales, `out_bytes` a
    value written."""
    moved = rows * k * in_bytes + k * n + 4 * n + rows * n * out_bytes
    return bound(moved, {"int8": 2 * rows * k * n})
