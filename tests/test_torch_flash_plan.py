"""Kernel B1's launch plan (ops/flash_attention.py::_plan), which picks the
kernel, its grid and its split-K from the shape alone, and the key tiles
each CTA walks (`cta_key_tiles`, the kernels' arithmetic). At the 7B's GQA
ratio (Hq = 28, Hkv = 4, rep = 7) on an H100's 132 SMs, for every cache
variant; and a model, in plain torch, of how the decode kernel combines
its partial softmax states (four warps per tile in the kernel, then the
splits in flash_merge_kernel).
The kernels themselves are held against the plain version on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.ops.flash_attention import (
    DECODE_ROWS,
    KEY_TILE,
    MIN_SPLIT_TILES,
    PREFILL_ROWS,
    _plan,
    cta_key_tiles,
)

HQ, HKV, REP, SMS = 28, 4, 7, 132
VARIANTS = ("bf16", "int8", "int8k")
PREFILL = {"bf16": "bf16_prefill", "int8": "int8_prefill",
           "int8k": "int8_prefill"}


def _ranges(plan, g, length, cap, causal):
    """(first key, end key) of every CTA of one kv head, in launch order."""
    out = []
    for split in range(plan.n_split):
        for block in range(-(-g * REP // plan.rows)):
            kb0, kb1 = cta_key_tiles(plan, g, REP, length, cap, causal,
                                     block, split)
            out.append((kb0 * KEY_TILE, kb1 * KEY_TILE, block, split))
    return out


@pytest.mark.parametrize("g,length,cap,causal,prefill", [
    (1, 4000, 8192, True, False),  # decode
    (1, 57344, 65536, True, False),  # decode at the headline's occupancy
    (1, 122880, 131072, True, False),  # hour-scale decode
    (20, 0, 4096, False, False),  # query-based group 0
    (20, 3607, 8192, True, False),  # a 20-token final prefill
    (27, 0, 4096, True, False),  # 189 packed rows: below one tile
    (28, 0, 4096, True, True),  # 196 packed rows: one tile
    (37, 3607, 8192, True, True),  # final prefill
    (37, 57344, 65536, True, True),
    (3600, 1807, 16384, True, True),  # 64-frame group step
    (3600, 53744, 65536, True, True),  # headline's last step
    (3620, 1807, 16384, False, True),  # query-based past partial
])
def test_plan_picks_the_kernel_by_packed_rows(g, length, cap, causal,
                                              prefill):
    """Every cache variant: a prefill kernel (bf16's, or the int8-QK one
    for int8 and int8k) from one full row tile of packed rows, the decode
    kernel below."""
    assert (g * REP >= PREFILL_ROWS) == prefill
    for variant in VARIANTS:
        plan = _plan(g, HQ, HKV, length, cap, causal, SMS, variant)
        assert plan.kernel == (PREFILL[variant] if prefill else "decode")
        assert plan.rows == (PREFILL_ROWS if prefill else DECODE_ROWS)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hq,hkv", [(28, 4), (16, 16), (32, 16)])
def test_plan_switches_kernels_at_one_prefill_row_tile(variant, hq, hkv):
    """Exactly at PREFILL_ROWS packed rows (191 / 192 where the GQA ratio
    allows it: rep 1 and 2; 189 / 196 at the 7B's rep 7)."""
    rep = hq // hkv
    below = (PREFILL_ROWS - 1) // rep  # the most rows under one tile
    above = -(-PREFILL_ROWS // rep)
    assert below * rep < PREFILL_ROWS <= above * rep
    for g, kernel in ((below, "decode"), (above, PREFILL[variant])):
        for causal in (True, False):
            plan = _plan(g, hq, hkv, 1000, 4096, causal, SMS, variant)
            assert plan.kernel == kernel
    if rep <= 2:
        assert below * rep == PREFILL_ROWS - rep and above * rep == PREFILL_ROWS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("g,length,cap,causal", [
    (1, 4000, 8192, True), (1, 57344, 65536, True), (1, 122880, 131072, True),
    (20, 0, 4096, False), (20, 57344, 65536, False), (27, 3607, 8192, True),
    (37, 3607, 8192, True), (37, 57344, 65536, True),
    (100, 1000, 4096, True), (3600, 1807, 16384, True), (3600, 0, 8192, True),
    (3600, 53744, 65536, True), (3620, 53744, 65536, False),
    (28, 0, 4096, True), (1, 100, 4096, True),
])
def test_split_k_fills_the_card_and_keeps_four_tiles(variant, g, length,
                                                     cap, causal):
    """Split-K engages exactly when the CTAs (one per SM, every kernel) do
    not fill the SMs, and every split keeps at least MIN_SPLIT_TILES key
    tiles."""
    plan = _plan(g, HQ, HKV, length, cap, causal, SMS, variant)
    blocks = -(-g * REP // plan.rows)
    assert plan.grid == (HKV, blocks, plan.n_split)
    ctas = blocks * HKV
    fill = SMS
    key_tiles = -(-min(length + g if causal else length, cap) // KEY_TILE)
    assert (plan.n_split > 1) == (
        ctas < fill and key_tiles >= 2 * MIN_SPLIT_TILES)
    if plan.n_split > 1:
        assert -(-key_tiles // plan.n_split) >= MIN_SPLIT_TILES
        assert ctas * plan.n_split >= fill or (
            plan.n_split == key_tiles // MIN_SPLIT_TILES)


def test_final_prefill_of_the_headline_splits_on_the_prefill_kernel():
    plan = _plan(37, HQ, HKV, 57344, 65536, True, SMS)
    assert plan.kernel == "bf16_prefill" and plan.n_split > 1
    assert plan.grid[0] * plan.grid[1] * plan.n_split >= SMS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("g,length,cap", [
    (3600, 1807, 16384), (3600, 53744, 65536), (3600, 0, 8192),
    (100, 1000, 4096), (37, 57344, 65536), (27, 3607, 8192), (20, 0, 4096),
])
def test_unified_launches_the_longest_key_range_first(variant, g, length,
                                                      cap):
    plan = _plan(g, HQ, HKV, length, cap, True, SMS, variant)
    first = [r for r in _ranges(plan, g, length, cap, True) if r[3] == 0]
    ends = [end for _, end, _, _ in first]
    assert first[0][2] == 0 and ends[0] == max(ends)
    assert ends == sorted(ends, reverse=True)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("g,length,cap,causal", [
    (3600, 1807, 16384, True), (3600, 53744, 65536, True),
    (3620, 1807, 16384, False), (37, 57344, 65536, True),
    (20, 0, 4096, False), (20, 1807, 4096, False), (1, 57344, 65536, True),
    (1, 122880, 131072, True), (1, 4000, 4001, True), (27, 3607, 8192, True),
    (100, 1000, 4096, True), (3599, 60000, 65536, False),
])
def test_no_cta_reads_past_its_reach(variant, g, length, cap, causal):
    """Every CTA's tiles end within the tile that holds min(reach, cap) - 1
    (the TMA map ends at the reach and zero-fills the rest of that tile),
    splits partition the range, and together the CTAs cover every slot
    some row attends."""
    plan = _plan(g, HQ, HKV, length, cap, causal, SMS, variant)
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
        rb = -(-rows // plan.rows) - 1 - block
        pos_hi = (min((rb + 1) * plan.rows, rows) - 1) // REP
        need = length + pos_hi + 1 if causal else length
        assert end == -(-min(need, cap) // KEY_TILE) * KEY_TILE


# -- the decode kernel's combination of partial softmax states --------------

LN2 = float(np.log(2.0))


def _online(s, v):
    """One warp's online softmax over its keys, tile by tile of 16, in log2
    units, as the kernel runs it: (running max m, sum l, unnormalized O)."""
    rows = s.shape[0]
    m = torch.full((rows,), float("-inf"), dtype=torch.float64)
    l = torch.zeros(rows, dtype=torch.float64)
    o = torch.zeros(rows, v.shape[1], dtype=torch.float64)
    for k0 in range(0, s.shape[1], 16):
        st, vt = s[:, k0:k0 + 16], v[k0:k0 + 16]
        m_new = torch.maximum(m, st.amax(dim=1))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(st - m_use[:, None])
        l = l * alpha + p.sum(dim=1)
        o = o * alpha[:, None] + p @ vt
        m = m_new
    return m, l, o


def _combine(parts):
    """(m, l, o) partials combined at their common max; a partial whose max
    is -inf (no key seen) weighs 0."""
    ms = torch.stack([m for m, _, _ in parts])
    mx = ms.amax(dim=0)
    w = torch.where(torch.isinf(mx), torch.zeros_like(mx)[None],
                    torch.exp2(ms - mx[None]))
    l = sum(w[i] * parts[i][1] for i in range(len(parts)))
    o = sum(w[i][:, None] * parts[i][2] for i in range(len(parts)))
    return mx, l, o


def _decode_model(s, v, n_split):
    """The decode kernel on one row block: splits of whole 64-key tiles
    (cta_key_tiles' chunks, empty trailing splits included); in each, four
    warps take 16 keys of every tile and combine at their common max into
    the split's (m, l, o); then every split's, at theirs."""
    nkb = -(-s.shape[1] // KEY_TILE)
    chunk = -(-nkb // n_split)
    splits = []
    for z in range(n_split):
        kb0 = min(nkb, z * chunk)
        kb1 = min(nkb, kb0 + chunk)
        warps = []
        for w in range(4):
            cols = [kb * KEY_TILE + 16 * w + j for kb in range(kb0, kb1)
                    for j in range(16)]
            cols = torch.tensor(cols, dtype=torch.long)
            warps.append(_online(s[:, cols], v[cols]))
        splits.append(_combine(warps))
    m, l, o = _combine(splits)
    out = torch.where(l[:, None] > 0, o / l.clamp(min=1e-300)[:, None],
                      torch.zeros_like(o))
    lse = torch.where(l > 0, m * LN2 + torch.log(l.clamp(min=1e-300)),
                      torch.full_like(l, -1e30))
    return out, lse, splits


def _merge_kernel_formula(splits):
    """flash_merge_kernel: m = max over splits, weights 2^(m_z - m), out =
    sum(o_z w) / sum(l_z w), lse = m ln 2 + ln l (-1e30 where l = 0)."""
    m = torch.stack([p[0] for p in splits]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(splits[0][2])
    for mz, lz, oz in splits:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp2(mz - m))
        l = l + lz * w
        acc = acc + oz * w[:, None]
    out = torch.where(l[:, None] > 0, acc / l.clamp(min=1e-300)[:, None],
                      torch.zeros_like(acc))
    lse = torch.where(l > 0, m * LN2 + torch.log(l.clamp(min=1e-300)),
                      torch.full_like(l, -1e30))
    return out, lse


@pytest.mark.parametrize("n_keys,n_split,masked", [
    (4000, 1, 0), (4000, 16, 0), (57344 // 16, 14, 3), (300, 3, 7),
    (1000, 5, 16),
])
def test_decode_merge_model_equals_the_merge_kernel_formula(n_keys, n_split,
                                                            masked):
    """The decode kernel's two-stage combination (warps, then splits) gives
    flash_merge_kernel's formula on the same split partials, and both give
    the softmax attention of the whole row (f64 here: only the order of
    the sums differs). Rows see a causal-like prefix: the last `masked`
    rows see nothing past key 100, and row 15 none (all -inf)."""
    rng = np.random.default_rng(n_keys + n_split)
    rows = DECODE_ROWS
    s = torch.from_numpy(rng.standard_normal((rows, n_keys)) * 3)
    v = torch.from_numpy(rng.standard_normal((n_keys, 128)))
    for r in range(rows - masked, rows):
        s[r, 100:] = float("-inf")
    s[rows - 1, :] = float("-inf")
    pad = -(-n_keys // KEY_TILE) * KEY_TILE - n_keys  # zero-filled, masked
    s = torch.cat([s, torch.full((rows, pad), float("-inf"),
                                 dtype=s.dtype)], dim=1)
    v = torch.cat([v, torch.zeros(pad, 128, dtype=v.dtype)])
    out, lse, splits = _decode_model(s, v, n_split)
    ref_out, ref_lse = _merge_kernel_formula(splits)
    torch.testing.assert_close(out, ref_out, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-12, atol=1e-12)
    seen = ~torch.isinf(s).all(dim=1)
    p = torch.softmax(s[seen] * LN2, dim=1)
    torch.testing.assert_close(out[seen], p @ v, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(
        lse[seen], torch.logsumexp(s[seen] * LN2, dim=1), rtol=1e-10,
        atol=1e-10)
    assert not out[~seen].any() and bool((lse[~seen] == -1e30).all())
