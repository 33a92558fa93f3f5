"""Kernel B1's launch plan (ops/flash_attention.py::_plan), which picks the
kernel, its grid and its split-K from the shape alone, and the key tiles
each CTA walks (`cta_key_tiles`, the kernels' arithmetic). At the 7B's GQA
ratio (Hq = 28, Hkv = 4, rep = 7) on an H100's 132 SMs; the kernels
themselves are held against the plain version on the card in
test_torch_cuda.py.
"""

import pytest

from quickvideo_tpu_torch.ops.flash_attention import (
    KEY_TILE,
    MIN_SPLIT_TILES,
    PREFILL_ROWS,
    _plan,
    cta_key_tiles,
)

HQ, HKV, REP, SMS = 28, 4, 7, 132


def _ranges(plan, g, length, cap, causal):
    """(first key, end key) of every CTA of one kv head, in launch order."""
    out = []
    for split in range(plan.n_split):
        for block in range(-(-g * REP // plan.rows)):
            kb0, kb1 = cta_key_tiles(plan, g, REP, length, cap, causal,
                                     block, split)
            out.append((kb0 * KEY_TILE, kb1 * KEY_TILE, block, split))
    return out


@pytest.mark.parametrize("g,length,cap,causal,kernel", [
    (1, 4000, 8192, True, "bf16_small"),  # decode
    (1, 57344, 65536, True, "bf16_small"),  # decode at the headline's occupancy
    (20, 0, 4096, False, "bf16_small"),  # query-based group 0
    (20, 3607, 8192, True, "bf16_small"),  # a 20-token final prefill
    (27, 0, 4096, True, "bf16_small"),  # 189 packed rows: below one tile
    (28, 0, 4096, True, "bf16_prefill"),  # 196 packed rows: one tile
    (37, 3607, 8192, True, "bf16_prefill"),  # final prefill
    (37, 57344, 65536, True, "bf16_prefill"),
    (3600, 1807, 16384, True, "bf16_prefill"),  # 64-frame group step
    (3600, 53744, 65536, True, "bf16_prefill"),  # headline's last step
    (3620, 1807, 16384, False, "bf16_prefill"),  # query-based past partial
])
def test_plan_picks_the_kernel_by_packed_rows(g, length, cap, causal,
                                              kernel):
    plan = _plan(g, HQ, HKV, length, cap, causal, SMS)
    assert plan.kernel == kernel
    assert (g * REP >= PREFILL_ROWS) == (kernel == "bf16_prefill")
    for variant in ("int8", "int8k"):
        assert _plan(g, HQ, HKV, length, cap, causal, SMS,
                     variant).kernel == "int8"


@pytest.mark.parametrize("g,length,cap,causal", [
    (1, 4000, 8192, True), (1, 57344, 65536, True), (1, 122880, 131072, True),
    (20, 0, 4096, False), (37, 3607, 8192, True), (37, 57344, 65536, True),
    (100, 1000, 4096, True), (3600, 1807, 16384, True), (3600, 0, 8192, True),
    (3600, 53744, 65536, True), (3620, 53744, 65536, False),
    (28, 0, 4096, True),
])
def test_split_k_fills_the_card_and_keeps_four_tiles(g, length, cap, causal):
    """Split-K engages exactly when the CTAs do not fill the SMs (one
    prefill CTA per SM; the 64-row kernels aim at two waves of three per
    SM), and every split keeps at least MIN_SPLIT_TILES key tiles."""
    plan = _plan(g, HQ, HKV, length, cap, causal, SMS)
    blocks = -(-g * REP // plan.rows)
    assert plan.grid == ((HKV, blocks, plan.n_split)
                         if plan.kernel == "bf16_prefill"
                         else (blocks, HKV, plan.n_split))
    ctas = blocks * HKV
    key_tiles = -(-min(length + g if causal else length, cap) // KEY_TILE)
    assert (plan.n_split > 1) == (
        ctas < SMS and key_tiles >= 2 * MIN_SPLIT_TILES)
    if plan.n_split > 1:
        assert -(-key_tiles // plan.n_split) >= MIN_SPLIT_TILES
        fill = SMS if plan.kernel == "bf16_prefill" else 2 * SMS
        assert ctas * plan.n_split >= fill or (
            plan.n_split == key_tiles // MIN_SPLIT_TILES)


def test_final_prefill_of_the_headline_splits_on_the_prefill_kernel():
    plan = _plan(37, HQ, HKV, 57344, 65536, True, SMS)
    assert plan.kernel == "bf16_prefill" and plan.n_split > 1
    assert plan.grid[0] * plan.grid[1] * plan.n_split >= SMS


@pytest.mark.parametrize("g,length,cap", [
    (3600, 1807, 16384), (3600, 53744, 65536), (3600, 0, 8192),
    (100, 1000, 4096), (37, 57344, 65536),
])
def test_unified_launches_the_longest_key_range_first(g, length, cap):
    plan = _plan(g, HQ, HKV, length, cap, True, SMS)
    first = [r for r in _ranges(plan, g, length, cap, True) if r[3] == 0]
    ends = [end for _, end, _, _ in first]
    assert first[0][2] == 0 and ends[0] == max(ends)
    assert ends == sorted(ends, reverse=True)


@pytest.mark.parametrize("g,length,cap,causal", [
    (3600, 1807, 16384, True), (3600, 53744, 65536, True),
    (3620, 1807, 16384, False), (37, 57344, 65536, True),
    (20, 0, 4096, False), (1, 57344, 65536, True), (100, 1000, 4096, True),
    (3599, 60000, 65536, False),
])
def test_no_cta_reads_past_its_reach(g, length, cap, causal):
    """Every CTA's tiles end within the tile that holds min(reach, cap) - 1
    (the TMA map zero-fills the rest of that tile), splits partition the
    range, and together the CTAs cover every slot some row attends."""
    plan = _plan(g, HQ, HKV, length, cap, causal, SMS)
    reach = min(length + g if causal else length, cap)
    last_tile_end = -(-reach // KEY_TILE) * KEY_TILE
    rows = g * REP
    for block in range(-(-rows // plan.rows)):
        tiles = [cta_key_tiles(plan, g, REP, length, cap, causal, block, z)
                 for z in range(plan.n_split)]
        assert tiles[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        end = tiles[-1][1] * KEY_TILE
        assert end <= last_tile_end
        rb = (-(-rows // plan.rows) - 1 - block
              if plan.kernel == "bf16_prefill" else block)
        pos_hi = (min((rb + 1) * plan.rows, rows) - 1) // REP
        need = length + pos_hi + 1 if causal else length
        assert end == -(-min(need, cap) // KEY_TILE) * KEY_TILE
