"""The launch plans of kernels B3, B4 and B6 (ops/fused_vision_mlp.py:
`b3_grid`, `mlp_plan`, `mlp_smem`, `cta_chunks`), which fix the kernels'
grid, cluster, ring depth and shared memory from the shape alone, the
width check, and a model in plain torch of how B4/B6's cluster splits a
row band's columns and rebuilds each row's scale from the CTAs' maxima.
The kernels themselves are held against the plain version on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
from quickvideo_tpu_torch.ops.quantization import quantize_act

SMS = 132
NP_7B = 3456  # the 7B's intermediate width 3420, padded to PAD


@pytest.mark.parametrize("s_len,n,want", [
    (14400, 3840, SMS),  # 113 x 15 tiles: one CTA per SM walks them
    (250, 3840, 30),     # 2 x 15 tiles
    (90, 480, 2),        # 1 x 2, the second column tile ragged
    (1, 8, 1),
])
def test_b3_grid_is_one_cta_per_sm_or_per_tile(s_len, n, want):
    assert fm.b3_grid(s_len, n, SMS) == want


def test_mlp_smem_counts_ring_slices_maxima_and_barriers():
    # 72-column chunks: 3 stages of (128 + 144) rows x 128 B, 3 slices of
    # 128 x 72 f32, 2 x 128 f32, 6 barriers, 1 KB slack
    assert fm.mlp_smem(72, 3, 3) == (1024 + 3 * 272 * 128 + 3 * 128 * 72 * 4
                                     + 2 * 128 * 4 + 6 * 8)
    assert fm.mlp_smem(64, 4, 2) == (1024 + 4 * 256 * 128 + 2 * 128 * 64 * 4
                                     + 2 * 128 * 4 + 8 * 8)


def test_mlp_plan_at_the_7b_width():
    # 48 chunks of 72 over a non-portable cluster of 16 CTAs, 3 apiece
    assert fm.mlp_plan(NP_7B) == fm.MlpPlan(72, 16, 3, 3, 217_136)


@pytest.mark.parametrize("n_pad", [64, 256, 832, 2048, NP_7B, 4096])
def test_mlp_plan_is_the_smallest_cluster_that_fits(n_pad):
    plan = fm.mlp_plan(n_pad)
    assert n_pad % plan.chunk == 0 and plan.chunk in fm.CHUNKS
    m = n_pad // plan.chunk
    assert plan.cluster in fm.CLUSTERS
    assert plan.cluster * plan.nch >= m  # every chunk has a CTA
    assert plan.smem == fm.mlp_smem(plan.chunk, plan.stages,
                                    plan.nch) <= fm.SMEM_MAX
    assert fm.MIN_STAGES <= plan.stages <= fm.MAX_STAGES
    if plan.stages < fm.MAX_STAGES:  # as deep as shared memory allows
        assert fm.mlp_smem(plan.chunk, plan.stages + 1,
                           plan.nch) > fm.SMEM_MAX
    for c in (c for c in fm.CLUSTERS if c < plan.cluster):
        # no smaller cluster holds its slices
        assert fm.mlp_smem(plan.chunk, fm.MIN_STAGES,
                           -(-m // c)) > fm.SMEM_MAX


@pytest.mark.parametrize("n_pad,chunk", [
    (NP_7B, 72),  # 48 slots of 72 columns against 64 of 64 (54 used)
    (2304, 72),   # 2 x 16 slots of 72 against 3 x 12 of 64
    (256, 64),    # 72 does not divide it
    (832, 64),
])
def test_mlp_plan_takes_the_chunk_with_the_least_slot_work(n_pad, chunk):
    assert fm.mlp_plan(n_pad).chunk == chunk


@pytest.mark.parametrize("n_pad", [
    0, 100, 3420,  # not a multiple of PAD
    4160,          # wider than 16 CTAs x 4 slices of 64
    5184,          # wider than 16 CTAs x 3 slices of 72
])
def test_mlp_plan_rejects_what_the_kernel_does_not_take(n_pad):
    with pytest.raises(ValueError, match="no B4/B6 plan|wider"):
        fm.mlp_plan(n_pad)


@pytest.mark.parametrize("n_pad", [64, 256, 832, 2048, NP_7B, 4096])
def test_cta_chunks_cover_every_chunk_once(n_pad):
    plan = fm.mlp_plan(n_pad)
    seen = [c for r in range(plan.cluster)
            for c in fm.cta_chunks(r, plan, n_pad)]
    assert sorted(seen) == list(range(n_pad // plan.chunk))


@pytest.mark.parametrize("c", [32, 1280, 3072, 3200, 5120])
def test_width_check_takes_any_multiple_of_32(c):
    fm._check_width(c)  # K streams through the ring: no upper bound


@pytest.mark.parametrize("c", [0, -32, 48, 1290])
def test_width_check_rejects_other_widths(c):
    with pytest.raises(ValueError, match="multiple of 32"):
        fm._check_width(c)


@pytest.mark.parametrize("n_pad", [256, 832, 2048, NP_7B])
def test_cluster_requantize_model_equals_the_plain_epilogue(n_pad):
    """B4/B6's epilogue as the cluster computes it: each CTA forms
    silu(g) * u for its chunks and its rows' |max|; every CTA takes the max
    over the cluster's maxima and quantizes its own chunks. Bit-equal to
    the plain version's row-wide requantize."""
    plan = fm.mlp_plan(n_pad)
    rng = np.random.default_rng(n_pad)
    y = torch.from_numpy(rng.standard_normal((40, 2 * n_pad)) * 3.0)
    y = y.to(torch.bfloat16)
    y[5] = 0  # a row of zeros: the 1e-8 floor
    q_ref, s_ref = fm._silu_quant_plain(y)
    g, u = y[:, :n_pad].float(), y[:, n_pad:].float()
    m = g * torch.sigmoid(g) * u
    w = plan.chunk
    cols = {r: torch.cat([torch.arange(c * w, (c + 1) * w) for c in
                          fm.cta_chunks(r, plan, n_pad)] or
                         [torch.zeros(0, dtype=torch.long)])
            for r in range(plan.cluster)}
    maxima = torch.stack([m[:, cols[r]].abs().amax(1) if
                          len(cols[r]) else torch.zeros(len(m), dtype=m.dtype)
                          for r in range(plan.cluster)], 1)
    s = quantize_act(torch.stack([maxima.amax(1), -maxima.amax(1)], 1))[1]
    assert torch.equal(s, s_ref)
    q = torch.empty_like(q_ref)
    for r in range(plan.cluster):
        q[:, cols[r]] = torch.round(m[:, cols[r]] / s).clamp(-127, 127).to(
            torch.int8)
    assert torch.equal(q, q_ref)
