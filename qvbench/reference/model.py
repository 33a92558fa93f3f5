"""Qwen2.5-VL with grouped prefill and key-norm pruning, in plain PyTorch.

Float32 throughout, TF32 off. It follows the published model (Hugging
Face's Qwen2_5_VLForConditionalGeneration) and the grouped-prefill
method the program serves:

  vision     yuv420 frames (limited-range BT.601, chroma repeated) to RGB,
             CLIP normalization, 2 x 14 x 14 patches in merge-unit order,
             the patch embedding, blocks of RMSNorm, attention with the 2D
             rotary (within each 112-pixel window, within each frame in the
             full-attention blocks) and a gated SiLU MLP, then the merger
             (RMSNorm, 2 x 2 patches concatenated, Linear, exact GELU,
             Linear)
  language   the chat sequence's multimodal rotary positions (3D for the
             video: time, height, width); the video's merged tokens in
             place of its placeholders; per group of frames one step
             through every layer, whose rows attend the layer's retained
             past and themselves causally, after which the layer keeps the
             `keep` rows of the group with the smallest key norm (the L2
             norm of the row's rotary keys over every kv head), its
             earlier rows' keys and values untouched; then the question's
             rows and the served tokens through every layer, causally over
             everything retained, and their logits

`Weights` gives every product's weight in float32 under a precision:
"bf16" (the weights as drawn), "int8" or "int4" (symmetric, one scale per
output channel, the embedding one per row: a configuration served with
int8 weights, and the control below it).

Where the caller passes the program's retained sets, the reference keeps
those rows instead of its own choice, after judging them by its own norms
(`judge`): a tie at the boundary, which rounding decides, then costs the
comparison of the later logits nothing.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qvbench.template import prefix_ids, request_ids

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
QMAX = {"int8": 127.0, "int4": 7.0}
ROW_CHUNK = 1024


def strict_f32() -> None:
    """Float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(w: torch.Tensor, qmax: float, axis: int) -> torch.Tensor:
    """Symmetric quantization of `w` with one scale per slice along every
    axis but `axis` (the contraction), in float32, dequantized."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True).clamp(min=1e-8)
    sc = amax / torch.tensor(qmax, device=w.device)
    return torch.round(wf / sc).clamp_(-qmax, qmax) * sc


class Weights:
    """The benchmark's weight tree read in float32 under `precision`."""

    def __init__(self, tree: dict, spec, precision: str = "bf16"):
        if precision not in ("bf16", "int8", "int4"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tree, self.spec, self.precision = tree, spec, precision

    def _get(self, path):
        node = self.tree
        for key in path:
            node = node[key]
        return node

    def mat(self, *path) -> torch.Tensor:
        """A matrix (in, out) for x @ w."""
        w = self._get(path)
        if self.precision == "bf16":
            return w.float()
        return fake_quant(w, QMAX[self.precision], axis=0)

    def vec(self, *path) -> torch.Tensor:
        return self._get(path).float()

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self._get(("language", "embed")).index_select(0, ids)
        if self.precision == "bf16":
            return rows.float()
        return fake_quant(rows, QMAX[self.precision], axis=1)

    def lm_head(self) -> torch.Tensor:
        return self.mat("language", "lm_head")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


# -- vision ---------------------------------------------------------------


def yuv420_to_rgb(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(T, h*w*3/2) uint8 yuv420p -> (T, 3, h, w) float32 in 0..255."""
    t, n = frames.shape[0], h * w
    y = frames[:, :n].reshape(t, h, w).float()
    u = frames[:, n : n + n // 4].reshape(t, h // 2, w // 2).float() - 128.0
    v = frames[:, n + n // 4 :].reshape(t, h // 2, w // 2).float() - 128.0
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    c = (y - 16.0) * (255.0 / 219.0)
    r = c + (255.0 / 224.0) * 1.402 * v
    g = (c - (255.0 / 224.0) * 1.772 * (0.114 / 0.587) * u
         - (255.0 / 224.0) * 1.402 * (0.299 / 0.587) * v)
    b = c + (255.0 / 224.0) * 1.772 * u
    return torch.stack([r, g, b], 1).clamp(0.0, 255.0)


class VisionGrid:
    """Patches of a (t, gh, gw) grid in merge-unit order: their (h, w)
    positions, attention windows and frames."""

    def __init__(self, spec, t: int, gh: int, gw: int, device):
        v = spec.vision
        m = v.merge
        lh, lw = gh // m, gw // m
        ti, i, j, a, b = np.meshgrid(np.arange(t), np.arange(lh),
                                     np.arange(lw), np.arange(m), np.arange(m),
                                     indexing="ij")
        hpos, wpos = (i * m + a).reshape(-1), (j * m + b).reshape(-1)
        edge = v.window // m // v.patch
        win = (ti * 10_000 + (i // edge) * 100 + j // edge).reshape(-1)
        self.t, self.hw = t, gh * gw
        self.window = torch.as_tensor(win[: self.hw], device=device)
        dim = v.head_dim // 2
        inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
        rot = np.concatenate([hpos[:, None] * inv, wpos[:, None] * inv], 1)
        emb = np.concatenate([rot, rot], 1)
        self.cos = torch.as_tensor(np.cos(emb), dtype=torch.float32,
                                   device=device)
        self.sin = torch.as_tensor(np.sin(emb), dtype=torch.float32,
                                   device=device)


def patchify(rgb: torch.Tensor, spec) -> torch.Tensor:
    """(T, 3, H, W) 0..255 -> (S, 3 * tp * p * p) normalized patches in
    merge-unit order, each (channel, time, row, column)."""
    v = spec.vision
    mean = torch.tensor(CLIP_MEAN, device=rgb.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=rgb.device).view(1, 3, 1, 1)
    x = (rgb / 255.0 - mean) / std
    if x.shape[0] % v.temporal_patch:
        pad = v.temporal_patch - x.shape[0] % v.temporal_patch
        x = torch.cat([x, x[-1:].expand(pad, -1, -1, -1)])
    tt, c, hh, ww = x.shape
    p, m, tp = v.patch, v.merge, v.temporal_patch
    gt, gh, gw = tt // tp, hh // p, ww // p
    x = x.reshape(gt, tp, c, gh // m, m, p, gw // m, m, p)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, c * tp * p * p)


def vision_tower(wts: Weights, spec, frames: torch.Tensor, h: int,
                 w: int) -> torch.Tensor:
    """One group's yuv420 frames -> (tokens, out_hidden) merged tokens, in
    the order of the sequence's placeholders (time, row, column)."""
    v = spec.vision
    x = patchify(yuv420_to_rgb(frames, h, w), spec)
    grid = VisionGrid(spec, x.shape[0] // ((h // v.patch) * (w // v.patch)),
                      h // v.patch, w // v.patch, x.device)
    x = x @ wts.mat("vision", "patch_embed")
    s, c = x.shape
    nh, hd = v.heads, v.head_dim
    same_window = grid.window[:, None] == grid.window[None, :]
    for bi in range(v.depth):
        p = ("vision", "blocks", bi)
        hx = rms_norm(x, wts.vec(*p, "ln1"), v.eps)
        qkv = hx @ wts.mat(*p, "wqkv") + wts.vec(*p, "bqkv")
        q, k, vv = (qkv[:, i * c : (i + 1) * c].view(s, nh, hd)
                    for i in range(3))
        cos, sin = grid.cos[:, None], grid.sin[:, None]
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        out = torch.empty_like(q)
        for ti in range(grid.t):
            rows = slice(ti * grid.hw, (ti + 1) * grid.hw)
            sc = torch.einsum("qhd,khd->hqk", q[rows], k[rows]) / math.sqrt(hd)
            if bi not in v.fullatt:
                sc = sc.masked_fill(~same_window, float("-inf"))
            out[rows] = torch.einsum("hqk,khd->qhd", sc.softmax(-1), vv[rows])
        x = x + out.reshape(s, c) @ wts.mat(*p, "wo") + wts.vec(*p, "bo")
        hx = rms_norm(x, wts.vec(*p, "ln2"), v.eps)
        g = hx @ wts.mat(*p, "wg") + wts.vec(*p, "bg")
        u = hx @ wts.mat(*p, "wu") + wts.vec(*p, "bu")
        x = x + (F.silu(g) * u) @ wts.mat(*p, "wd") + wts.vec(*p, "bd")
    mp = ("vision", "merger")
    x = rms_norm(x, wts.vec(*mp, "ln_q"), v.eps).reshape(s // v.merge ** 2, -1)
    x = F.gelu(x @ wts.mat(*mp, "w1") + wts.vec(*mp, "b1"))
    return x @ wts.mat(*mp, "w2") + wts.vec(*mp, "b2")


# -- positions ----------------------------------------------------------


def rope_positions(spec, ids: np.ndarray, grid_thw, second_per_grid: float,
                   extra: int) -> np.ndarray:
    """(3, len(ids) + extra) multimodal positions of a sequence with one
    video (Hugging Face's get_rope_index for Qwen2.5-VL), then `extra`
    text positions after it."""
    t, h, w = grid_thw
    gh, gw = h // spec.vision.merge, w // spec.vision.merge
    first = int(np.nonzero(ids == spec.video_token_id)[0][0])
    pre = np.arange(first)
    tt = (np.arange(t) * second_per_grid
          * spec.vision.tokens_per_second).astype(np.int64)
    vid = np.stack([np.repeat(tt, gh * gw),
                    np.tile(np.repeat(np.arange(gh), gw), t),
                    np.tile(np.arange(gw), t * gh)]) + first
    n_after = len(ids) - first - t * gh * gw + extra
    after = np.arange(n_after) + vid.max() + 1
    return np.concatenate([np.stack([pre] * 3), vid,
                           np.stack([after] * 3)], 1)


def mrope_tables(spec, pos: np.ndarray, device):
    """(L, head_dim) cos and sin: frequency i of each half takes the time,
    height or width position by mrope_section."""
    t = spec.text
    d = t.head_dim
    inv = 1.0 / (t.rope_theta ** (np.arange(0, d, 2) / d))
    axis = np.concatenate([[a] * n for a, n in
                           zip((0, 1, 2), t.mrope_section)])
    ang = pos[axis].T.astype(np.float64) * inv[None, :]
    emb = np.concatenate([ang, ang], 1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f(np.cos(emb)), f(np.sin(emb))


# -- language -------------------------------------------------------------


def judge(norms: torch.Tensor, kept: torch.Tensor, k: int):
    """A kept set against the k rows of smallest `norms`: (rows kept that
    the reference's own choice drops, the largest relative distance by
    which a kept row's norm lies above the k-th smallest or a dropped
    row's below the (k+1)-th). A set of the wrong size, with repeated
    rows or rows out of range reads (k, inf)."""
    g = norms.shape[0]
    kept = kept.to(norms.device, torch.int64)
    if (kept.numel() != k or kept.unique().numel() != k
            or int(kept.min()) < 0 or int(kept.max()) >= g):
        return k, math.inf
    mask = torch.zeros(g, dtype=torch.bool, device=norms.device)
    mask[kept] = True
    own = torch.zeros_like(mask)
    own[own_choice(norms, k)] = True
    off = int((mask & ~own).sum())
    srt = torch.sort(norms).values
    over = ((norms[mask] - srt[k - 1]).clamp(min=0).max() / srt[k - 1]
            if k else norms.new_zeros(()))
    under = ((srt[k] - norms[~mask]).clamp(min=0).max() / srt[k]
             if k < g else norms.new_zeros(()))
    return off, float(torch.maximum(over, under))


def own_choice(norms: torch.Tensor, k: int) -> torch.Tensor:
    """The k rows of smallest norm, ascending (ties: the earlier row)."""
    return torch.sort(torch.sort(norms, stable=True).indices[:k]).values


class Language:
    """The decoder with one retained cache a layer."""

    def __init__(self, wts: Weights, spec, capacity: int, device):
        t = spec.text
        self.wts, self.spec, self.t = wts, spec, t
        shape = (t.layers, t.kv_heads, capacity, t.head_dim)
        self.k = torch.zeros(shape, device=device)
        self.v = torch.zeros(shape, device=device)
        self.length = [0] * t.layers

    def _attend(self, li: int, q, k, v) -> torch.Tensor:
        """q (Hq, G, D) rows over the layer's past and, causally, the new
        k / v (Hkv, G, D) -> (G, Hq * D)."""
        t = self.t
        rep, g, past = t.heads // t.kv_heads, q.shape[1], self.length[li]
        out = torch.empty(g, t.heads, t.head_dim, device=q.device)
        q = q * (1.0 / math.sqrt(t.head_dim))
        ahead = torch.ones(g, g, dtype=torch.bool, device=q.device).triu_(1)
        for h in range(t.kv_heads):
            keys = torch.cat([self.k[li, h, :past], k[h]])
            vals = torch.cat([self.v[li, h, :past], v[h]])
            qh = q[h * rep : (h + 1) * rep]
            for r0 in range(0, g, ROW_CHUNK):
                r1 = min(g, r0 + ROW_CHUNK)
                sc = qh[:, r0:r1] @ keys.T
                sc[..., past:].masked_fill_(ahead[r0:r1], float("-inf"))
                o = torch.softmax(sc, -1) @ vals
                out[r0:r1, h * rep : (h + 1) * rep] = o.transpose(0, 1)
                del sc
        return out.reshape(g, -1)

    def step(self, x, cos, sin, keep: int,
             retained: Optional[Sequence[torch.Tensor]] = None):
        """Rows `x` (G, C) through every layer; each layer then keeps `keep`
        of them (all where keep == G) by key norm, or the rows `retained`
        names for it after judging them. Returns (x, per-layer kept rows,
        per-layer (rows off, norm excess, rows kept): `judge`)."""
        t, w = self.t, self.wts
        g = x.shape[0]
        kept_rows, verdicts = [], []
        for li in range(t.layers):
            p = ("language", "layers", li)
            hx = rms_norm(x, w.vec(*p, "ln1"), t.eps)
            q = (hx @ w.mat(*p, "wq") + w.vec(*p, "bq")).view(g, -1, t.head_dim)
            k = (hx @ w.mat(*p, "wk") + w.vec(*p, "bk")).view(g, -1, t.head_dim)
            v = (hx @ w.mat(*p, "wv") + w.vec(*p, "bv")).view(g, -1, t.head_dim)
            q = q * cos[:, None] + rotate_half(q) * sin[:, None]
            k = k * cos[:, None] + rotate_half(k) * sin[:, None]
            q, k, v = (a.transpose(0, 1) for a in (q, k, v))
            x = x + self._attend(li, q, k, v) @ w.mat(*p, "wo")
            if keep < g:
                norms = k.transpose(0, 1).reshape(g, -1).norm(dim=-1)
                if retained is None:
                    rows, verdict = own_choice(norms, keep), (0, 0.0, keep)
                else:
                    rows = retained[li].to(x.device, torch.int64)
                    verdict = judge(norms, rows, keep) + (keep,)
                    if not math.isfinite(verdict[1]):
                        rows = own_choice(norms, keep)
                k, v = k[:, rows], v[:, rows]
            else:
                rows, verdict = None, (0, 0.0, 0)
            n = k.shape[1]
            a = self.length[li]
            self.k[li, :, a : a + n] = k
            self.v[li, :, a : a + n] = v
            self.length[li] += n
            kept_rows.append(rows)
            verdicts.append(verdict)
            hx = rms_norm(x, w.vec(*p, "ln2"), t.eps)
            x = x + (F.silu(hx @ w.mat(*p, "wg")) * (hx @ w.mat(*p, "wu"))
                     ) @ w.mat(*p, "wd")
        return x, kept_rows, verdicts

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, self.wts.vec("language", "norm"), self.t.eps)
        return h @ self.wts.lm_head()


class Result:
    """What the reference made of one request: the logits at each served
    position (n, V), each (group, layer)'s kept rows and judgement, and
    the per-layer cache lengths."""

    def __init__(self, logits, kept, verdicts, lengths):
        self.logits, self.kept = logits, kept
        self.verdicts, self.lengths = verdicts, lengths


def run_request(wts: Weights, spec, mix, pool, video: int, question: str,
                served: Sequence[int], device,
                retained: Optional[List[Sequence[torch.Tensor]]] = None
                ) -> Result:
    """One request of `mix` through the reference: its video (`video` of
    the frame `pool`), its question, then the `served` tokens fed back
    (teacher forcing). `retained[g][l]`: the rows the judged program kept,
    or None for the reference's own choice."""
    strict_f32()
    v, t = spec.vision, spec.text
    h, w = int(mix.video["height"]), int(mix.video["width"])
    fps = float(mix.video["fps"])
    counts = mix.group_frames(spec)
    tokens = mix.group_tokens(spec)
    ids = request_ids(spec, question, sum(tokens))
    t_total = sum(-(-c // v.temporal_patch) for c in counts)
    served = [int(s) for s in served]
    pos = rope_positions(spec, ids, (t_total, h // v.patch, w // v.patch),
                         v.temporal_patch / fps, len(served))
    cos, sin = mrope_tables(spec, pos, device)
    rows = mix.group_rows(spec, question)
    capacity = sum(mix.keep(r) for r in rows) + len(ids) - sum(rows) + len(
        served) + max(rows)
    lang = Language(wts, spec, capacity, device)
    ids_t = torch.as_tensor(ids, device=device)
    start, frame0, kept, verdicts = 0, 0, [], []
    clock = {"vision": 0.0, "groups": 0.0}
    shape = (h * w * 3 // 2,)
    for gi, (cnt, n_rows) in enumerate(zip(counts, rows)):
        px = torch.as_tensor(pool.frames(video, range(frame0, frame0 + cnt),
                                         shape), device=device)
        frame0 += cnt
        t0 = _now(device)
        vis = vision_tower(wts, spec, px, h, w)
        t1 = _now(device)
        clock["vision"] += t1 - t0
        g_ids = ids_t[start : start + n_rows]
        x = wts.embed(g_ids)
        is_vid = g_ids == spec.video_token_id
        x[is_vid] = vis
        x, k_rows, verdict = lang.step(
            x, cos[start : start + n_rows], sin[start : start + n_rows],
            mix.keep(n_rows), None if retained is None else retained[gi])
        kept.append(k_rows)
        verdicts.append(verdict)
        start += n_rows
        clock["groups"] += _now(device) - t1
    tail = torch.cat([ids_t[start:], torch.as_tensor(
        served[:-1], dtype=torch.int64, device=device)])
    x = wts.embed(tail)
    end = start + len(tail)
    x, _, _ = lang.step(x, cos[start:end], sin[start:end], len(tail))
    logits = lang.logits(x[len(ids) - start - 1 :])
    res = Result(logits, kept, verdicts, list(lang.length))
    res.clock = clock
    return res


def _now(device) -> float:
    import time

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def expected_lengths(spec, mix, question: str, n_served: int) -> List[int]:
    """Per-layer cache lengths a request leaves: every group's kept rows,
    the question's rows and every served token but the last."""
    rows = mix.group_rows(spec, question)
    tail = len(request_ids(spec, question, 0)) - len(prefix_ids(spec))
    n = sum(mix.keep(r) for r in rows) + tail + max(0, n_served - 1)
    return [n] * spec.text.layers
