#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (quickvideo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and `nvcc`; imports nothing of
JAX. It fails (non-zero exit, no result line) without CUDA and outside a
checkout of the repository. Phases:

  1. the card's name and power limit; build of the kernels from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     production head dims and the main path's shapes, with times, the
     bound (the card's peaks) and, where one PyTorch call computes the
     same function, that call's time: B1 (each cache on its prefill
     kernel, bf16 or int8-QK, or the decode kernel by shape, timed on the
     device, up to the 1024-frame headline's last group step and
     hour-scale decode, with SDPA's device time at decode; its lse
     output and pure-past mode on
     every cache, out and lse apart, beside aten's memory-efficient SDPA
     with its lse on bf16 operands; one SDPA call at the headline's last
     group step, 53,744 slots, pure past and unified causal; the
     registers, spills and shared memory of every B1 instantiation), B2
     and B5 (short-span kernel up to 64-row spans, wgmma
     long-span kernel above; the 420x420 group's window buckets and
     frames, a 476x644 image's buckets and frame, ragged column validity,
     a 2304-row span), the vision rotary pass, the registers, spills and
     shared memory of each vision kernel, and the int8 vision kernels B3,
     B4, B6 at the 7B tower's widths at S = 14,400, 250 and 90 over five
     seeds each (device time by launch part, prologue and GEMM, at 14,400
     and 250; registers and spills; resident clusters of the B4/B6 plan;
     torch._int_mm on the products alone as a yardstick); a failed
     B3/B4/B6 check prints its worst rows and reruns both sides (ROADMAP
     C12);
  3. the main path at the full width and depth of qwen25-vl-7b (bf16
     random weights): three `generate` requests through LVU / LVUEngine on
     64 seeded 420x420 yuv420 frames, groups of 32, key_norms_small at
     top_p=0.5; launch counts (B1's per kernel: every group step on the
     prefill kernel, every decode step on the decode one), cache lengths
     and per-span timings;
     then, only where the CPU decoder library is built, one request through
     `LVU.generate(question, video_path)` on an encoded clip;
  3b. the same three requests with int8 weights (param_dtype="int8"): B1-B4
     launch counts, cache lengths, spans, peak memory, and the rel. L2
     between the int8 and bf16 final-prefill logits of one request
     (printed, not asserted);
  3c. the same three requests with bf16 weights and an int8 KV cache
     (kv_cache_dtype="int8", then "int8k"): launch counts per B1 variant,
     cache lengths and dtypes, spans, peak memory, kv_cache_bytes, and the
     rel. L2 against the bf16-KV logits (printed, not asserted); then one
     request with int8 weights, kv_cache_dtype="auto" and
     kv_cache_capacity=131072, which must resolve to an int8 cache;
  3d. one 7B request per entry of MODE_REQUESTS on the bf16 weights of
     phase 3 (salient_tokens with bf16 and int8 KV, query-based, a linear
     decay with the cascade, query-based with int8 KV and a decay and with
     int8k KV and do_top_k_for_query): B1 launches per variant, mode and
     kernel,
     cache lengths per layer against the config's rules, spans, peak
     memory;
  3e. the head-major vision route (kernel B5): the 64-frame request under
     QV_VISION_2D=0 with bf16 and with int8 weights (B2, B3, B4 launch 0
     times), 66 frames by default (the 1-temporal-patch last group takes
     B5), an image alone through `LVU.chat`, and an image before the
     video: B2/B5 launches against the JAX package's route rule, cache
     lengths, spans, peak memory, and the rel. L2 of the QV_VISION_2D=0
     logits against phase 3's (printed, not asserted);
  3f. the rest of the LVU API on the 7B (bf16 weights of phase 3, seeded
     64-frame videos through a seeded reader in place of the decoder): a
     chat session (LVU.start_chat: a first ask, two follow-ups of 26 and 56
     rows, save, LVU.resume_chat, a fourth turn that must equal the live
     session's; the first follow-up's final-prefill logits against the
     whole history from scratch), LVU.loglikelihood_multi over 4 options
     against each option's own LVU.loglikelihood, LVU.generate with
     do_sample (top_k=1 equals greedy, a seed repeats, streamed chunks),
     BatchedQAEngine over 4 questions against their own requests, and a
     narrow safetensors checkpoint directory through LVU with bf16 and
     int8 weights against the same weights passed as params=; B1 launches
     per kernel on each path against the rows its launches run, walls,
     decode ms/token, peak memory;
  3g. the front end on the 7B (bf16 weights of phase 3, seeded videos):
     the HTTP server started in this process on port 0 (a burst of 4
     /v1/generate questions served as one micro-batch against 4 direct
     LVU.generate calls; two sessions with one resident, the first spilled
     to disk and resumed against a session that never spilled;
     /v1/chat/completions with a video_url part; an SSE stream on each of
     the three streaming routes against the unstreamed answer; a 400 and a
     413), the CLI in this process (one --json question with int8 weights
     from the seed, against the direct call's answer and cache_length;
     --interactive with --session_file, saved and resumed), and the disk
     frame cache (save_video_cache: the second request draws no frame from
     the reader and gives the first one's tokens); answers spell their
     token ids; walls, launches, the batch histogram, frame_fetch spans;
  3h. the on-device resize: one 64-frame request from 480 x 854 sources
     resized in the decoder, and resized on the card (resize_on_device) in
     yuv420 and in RGB: launches, cache lengths, the vision span and the
     bytes sent to the card; lanczos3_resize on the card against its CPU
     run;
  3i. tensor and context parallelism over torch.distributed (phase 2
     also holds B1 at a tp rank's head counts): two rank
     processes share the card over gloo: B1 pure past + lse on each
     rank's window of a split cache at its local length (empty windows
     included), merged over the ranks, and the in-group partial, against
     their plain versions; phase 3's request 0 at the 7B's full width and
     depth under tp=2, sp=2 (bf16 and int8 KV) and tp=2 with int8 weights
     (each rank drawing its shard from the same seed): tokens and
     final-prefill logits against the single-rank run of phase 3, the
     ranks' agreement, cache lengths per layer, B1 launches per rank by
     kernel and mode, spans, peak memory per rank (walls are gloo on one
     card); then NCCL at world size 1;
  3j. pipeline parallelism over torch.distributed: two rank processes
     share the card over gloo, pp = 2 (14 layers per stage, each rank
     drawing its stage's weights from the same seed), phase 3's request 0
     at the 7B's full width and depth with bf16 weights, an int8 KV cache
     and int8 weights, and on the first also decode sampled on the card, a
     streamed request and 4 scored continuations: tokens and final-prefill
     logits against the single-rank run of phase 3 (bit for bit, limit
     1e-6 rel. L2), cache_length, kv_cache_bytes and the per-layer
     lengths gathered over the stages, each stage's retained sets, B1
     launches per stage (half of one rank's) and their sum, resident and
     peak memory per rank, each stage's group step alone, request walls
     and decode ms/token beside one rank's;
  3k. the HTTP server on a mesh (run after 3h, on phase 3's bf16 weights
     for one rank's answers): two rank processes share the card over
     gloo, each building the 7B on the mesh and calling make_http_server;
     rank 0 serves over HTTP, rank 1 follows its jobs. tp = 2: a burst of
     4 /v1/generate questions served as one micro-batch on both ranks
     against the mesh's 4 direct LVU.generate calls (and B1 launches per
     rank against the same BatchedQAEngine call made directly), two
     sessions with one resident (the first spilled to one .npz, resumed,
     against a session that never spilled), /v1/chat/completions with a
     video_url part, an SSE stream against the unstreamed answer, and a
     request after an idle gap beyond the lowered control timeout; pp =
     2: the burst served one by one, its answers one rank's bit for bit,
     B1 launches per stage as the 4 direct calls', a stream, and
     /v1/sessions refused with the JAX message on both ranks; walls,
     resident and peak memory per rank, the batch histogram; every rank
     exits 0 after the leader's shutdown;
  3l. the other two model sizes on the one card (phase 2 also holds B1 at
     their 8 q heads per kv head: 64 / 8, 32 / 4, 16 / 2):
     qwen25-vl-3b at full width and depth, and qwen25-vl-72b at full width
     and 8 of its 80 layers, each with bf16 weights, int8 weights and an
     int8 KV cache: phase 3's request 0 twice, the second timed and
     counted: B1 launches per variant, mode and kernel, cache lengths per
     layer, the cache "auto" resolved to, tokens and finite logits, init
     wall, resident and peak memory;
  3m. the preset path as bench.py builds it: an LVU of a preset name with
     no checkpoint holds the JAX package's deterministic weights, made on
     the card from their indices (the 7B with int8 weights, bench.py's
     configuration, then the 7B and the 3B with bf16 weights, full size):
     every leaf equal bit for bit to the JAX leaf computed whole on the
     card (the JAX formula over a flat int32 iota), and at sampled blocks
     to the index function's on the CPU; every leaf's dtype, shape and
     strides those of the seeded path's, so its bytes too; and phase 3's
     request 0 twice, counted as in 3l;
  4. the same prefill on the card and (plain versions) on the CPU for a
     narrow config with production head dims, with bf16 and with int8
     weights, with an int8 KV cache, with salient_tokens and query-based
     pruning, under QV_VISION_2D=0 with bf16 and int8 weights, with an
     image, and with 480 x 854 frames resized on the device, and for a
     narrow config at 8 q heads per kv head with the 72B's text eps and
     tokens_per_second: final-prefill logits agree, and the retained index
     sets of the pruned runs; and the first narrow model on the preset
     path's deterministic weights, bf16 and int8, made on each side.

Every phase but 3m (and 3m's own layout check) builds its preset LVUs on
init_params' seeded normals (`_seeded_weights`), on which their limits
were set; the port's preset path itself gives the JAX package's
deterministic weights.

QV_VISION_2D is set only around the phases that force the route.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

runs phase 1, then one warm 7B request (request 0 of phase 3) with bf16
weights, with int8 weights, with bf16 weights and an int8 KV cache, with
bf16 weights and salient_tokens, then query-based, pruning, and with bf16
weights on the head-major vision route (QV_VISION_2D=0) under
torch.profiler, and prints the wall time, the busy share of the card,
the spans, kernel time by kind and the top kernels. It prints no result
line.

    python3 chip_smoke.py --compare-b1 [--root DIR]

runs phase 1, then prints B1's device time, bound share and error
against the plain version at the main path's decode and int8 prefill
shapes (SDPA's device time at decode, the split-K merge's part) and
every B1 instantiation's registers and spills.
With --root it times the package of another checkout, such as an
unpacked older commit, for a before-and-after in one call. It prints no
result line.

    python3 chip_smoke.py --mesh-cards [--mesh-runs TAGS] [--one-card]

runs phase 1 (every card's name and power limit), then phase 3i's
collective, CP kernel and tp checks and its 7B requests (tp, sp, tp x sp,
int8 KV, int8 weights) and phase 3j's pipeline requests (pp = 2 on two
cards; on four: pp = 4, pp 2 x tp 2, pp = 4 with int8 weights, and pp = 2
in two dp replicas) with NCCL, one rank per card, on a machine of 2 or 4
cards, against one rank's request on card 0 (timed on its second run);
on four also the 72B at 8 of its 80 layers (tp = 2 and tp = 4 against
the same 8 on card 0, pp 2 x tp 2 against tp = 2 bit for bit, with a
bf16 and an int8 cache). TAGS picks runs of CARD_MESH_RUNS, TAGGED_RUNS
(made only so: the 72B at 16 layers over tp = 2; at its 80 layers tp = 4
with "auto" and with bf16 KV, pp 2 x tp 2 against tp = 4 with each, int8
weights over tp = 2 on two cards, and tp = 4 on the preset path's own
weights, 72b_tp4_fast: each rank's part at sampled blocks, the int32
iota's wrapped indices among them, and its parameter bytes against
72b_tp4's) and CARD_SERVE_RUNS, e.g.
--mesh-runs 72b_tp4,72b_tp4_bf16kv,72b_tp2_int8w,72b_serve_tp4; `serve`
stands for every server run: phase 3k's checks over NCCL, tp = 2 and pp
= 2 on two cards; on four dp 2 x tp 2, dp 2 x pp 2, pp 2 x tp 2 and the
72B over tp = 4. With --one-card the tagged mesh runs of up to 4 ranks
run as gloo ranks sharing card 0 (e.g. --mesh-runs
72b8_tp2,72b8_tp4,72b8_pp2_tp2 on one H100). It exits non-zero where a
check failed and prints no result line.

    python3 chip_smoke.py --compare-fused [--root DIR]

runs phase 1, then prints B3, B4 and B6's device time by launch part
(prologue, GEMM, and a requantize launch where the tree has one), bound
share and error against the plain version at S = 14,400 and 250, and
(without --root) the kernels' registers, spills and resident clusters;
--root as for --compare-b1. It prints no result line.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Tolerance of kernel vs plain, elementwise |kernel - plain| <= KERNEL_ATOL
# + KERNEL_RTOL * |plain|. Both read the same bf16 operands; the plain
# version computes in f32 and rounds once to bf16, the kernel also rounds
# the softmax weights to bf16 before the PV product. The outputs are bf16,
# whose spacing is 2^-7 relative: a rounding that lands one step apart
# costs up to 7.8e-3 * |out|, and rows that see few keys (early causal rows,
# 4-row spans) have outputs as large as the largest N(0, 1) values. The
# margin above one step covers the rounded weights and summation order.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
# card (bf16 activations) vs CPU (f32 activations, same bf16-rounded
# weights): ~4e-3 relative per bf16 rounding, through the vision stem, 2
# vision blocks, the merger, 2 decoder layers and the head
LOGITS_REL_L2 = 5e-2
# the same with int8 weights: every act-quantized product re-quantizes
# activations that differ by bf16 rounding, flipping some int8 codes (the
# CPU's plain versions give 1.9e-2 for bf16 vs f32 activations)
INT8_LOGITS_REL_L2 = 6e-2
# the same with an int8 KV cache (bf16 weights): both sides quantize K, V
# and q at the same rounding points, from activations that differ by bf16
# rounding, which flips some codes; the CPU's plain versions give 5.3e-3
# for bf16 vs f32 activations with int8 KV against 5.1e-3 with bf16 KV, so
# the bf16 tolerance holds
INT8_KV_LOGITS_REL_L2 = LOGITS_REL_L2
# B3/B4/B6 kernel vs plain: quickvideo_tpu_torch/testing.py states and
# applies the rule (FUSED_*)
# card vs CPU with an attention-statistics or query-based predictor at
# top_p 0.5: the scores behind the retained set come from bf16 attention on
# the card and f32 on the CPU, and a retained index that flips swaps a key
# for another where a key-norm order rarely moves. The CPU's plain versions
# give rel. L2 5.9e-3 (salient_tokens) and 8.3e-3 (query_attention_weights)
# for bf16 vs f32 activations, with 99.4-100% of each (group, layer)'s
# retained indices agreeing; the card rounds at other points than the CPU's
# bf16 path, so the unpruned budget is doubled and each set must agree on at
# least RETAINED_AGREE of its indices
PRUNED_LOGITS_REL_L2 = 2 * LOGITS_REL_L2
RETAINED_AGREE = 0.9
# card vs CPU on the preset path's deterministic weights (phase 4's narrow
# model at 7 q heads per kv head, made on each side from their indices):
# the CPU's plain versions give 9.4e-3 with bf16 weights (6.7e-3 to
# 1.01e-2 over five other request seeds) and 5.9e-3 with int8 weights for
# bf16 vs f32 activations, against 5.6e-3 on the seeded normals, so the
# bf16 budget holds with a margin of 5
FAST_LOGITS_REL_L2 = LOGITS_REL_L2

# the on-device resize on the card vs its own f32 run on the CPU, on the
# 0..255 scale: two f32 products over 10-18 taps each, differing only in
# summation order (TF32 stays off)
RESIZE_ATOL = 1e-3

# B1's lse (f32, natural log), kernel vs plain: both take the same f32
# scores (exact products of the bf16 or int8 operands) and differ in
# summation order and exp2 / log rounding, ~1e-6 of an lse of magnitude
# <= 20; two orders of margin
LSE_ATOL = 1e-4
# B1's kernels in a profile: the decode and prefill kernels and the split-K
# merge (and, on an older tree, its small-G and int8-QK kernels)
B1_NAMES = ("flash_",)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# a kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}

REQUEST_FRAMES = 64
FRAME_HW = 420  # 30 x 30 patches: ragged 64/48/36-patch window buckets
GROUP_FRAMES = 32
# a 480x640 photo after smart_resize: 34 x 46 patches, window buckets of
# 64/48/16/12 rows and one 1564-row frame, which the JAX package's tiling
# rule sends to the head-major route (kernel B5)
IMAGE_HW = (476, 644)
# phase 3h's sources: a 480p video's frames, which the plan resizes
RESIZE_SOURCE_HW = (480, 854)


def log(msg):
    print(msg, flush=True)


def _gpu_lines() -> list:
    """nvidia-smi's "name, power.limit" line of every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()


def _gpu_line() -> str:
    return _gpu_lines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: dict):
    """(bound ms, "bytes" or "operations") for `nbytes` moved and
    `ops` operations by type ("bf16", "int8")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"
    )


def nbytes(*objs) -> int:
    """Bytes of the tensors in nested tuples, lists and dicts."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


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


def sdpa_ms(q, k, v, length, causal=True, reps=5, device=False):
    """One PyTorch call computing B1's output on bf16 operands:
    scaled_dot_product_attention with an explicit mask and enable_gqa
    (timed for comparison only; the port never calls it). device=True:
    the device time of all the call's kernels (torch.profiler), else CUDA
    events around the calls."""
    import torch
    import torch.nn.functional as F

    g = q.shape[1]
    n = length + g if causal else length
    rows = torch.arange(g, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    mask = cols <= rows + length if causal else cols < length
    qb, kb, vb = q[None], k[None, :, :n], v[None, :, :n]

    def call():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask,
                                              enable_gqa=True)

    return _device_ms(call, ("",), reps) if device else _time_ms(call, reps)


def sdpa_lse_ms(q, k, v, length, causal=True, reps=5):
    """One PyTorch call computing B1's output and its lse on bf16
    operands: aten's memory-efficient attention with compute_log_sumexp,
    the kv heads repeated over their q heads outside the call (GQA), a
    bias for the unified causal offset (none for pure past); timed by
    CUDA events for comparison only (the port never calls it); a refusal
    of the call is printed and gives no time. Returns
    (ms, out, lse): (Hq, G, D) and (Hq, G), or (None, None, None) over an
    empty past."""
    import torch

    hq, g, _ = q.shape
    n = length + g if causal else length
    if n == 0:
        return None, None, None
    rep = hq // k.shape[0]
    kb = k[:, :n].repeat_interleave(rep, 0)[None]
    vb = v[:, :n].repeat_interleave(rep, 0)[None]
    qb = q[None]
    bias = None
    if causal:  # its rows padded to 16 elements, as the kernel asks
        pad = -(-n // 16) * 16
        rows = torch.arange(g, device=q.device)[:, None]
        cols = torch.arange(pad, device=q.device)[None, :]
        bias = torch.zeros(g, pad, dtype=q.dtype, device=q.device)
        bias.masked_fill_(cols > rows + length, float("-inf"))
        # one row per q head, as the kernel asks (a broadcast view)
        bias = bias[None, None, :, :n].expand(1, hq, g, n)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qb, kb, vb, bias, True)

    try:
        out, lse = call()[:2]
    except RuntimeError as e:  # a yardstick: its absence fails nothing
        log(f"memory-efficient SDPA refused G={g} n={n}: {e}")
        return None, None, None
    return _time_ms(call, reps), out[0], lse[0, :, :g]


def _device_ms(fn, names, reps: int, tries: int = 3) -> float:
    """Device time per call of fn of the kernels whose names hold one of
    `names`, from torch.profiler: the kernels alone, without the host's
    launch gaps that _time_ms sees when a call is host-bound. The
    profiler's device trace can come back without those kernels (fewer
    than one per call); it is then taken again, and after `tries` such traces the calls are timed
    by CUDA events instead (_time_ms), with a line saying so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and any(n in e.name for n in names)]
        if len(us) >= reps and sum(us) > 0:  # each call launches one or more
            return sum(us) / 1e3 / reps
    log(f"torch.profiler recorded no device kernel named {names} in "
        f"{tries} traces: timed by CUDA events around the calls instead")
    return _time_ms(fn, reps)


# -- phase 2: kernels vs plain --------------------------------------------


def _compare(got, ref):
    """(max abs error, within the stated tolerance and finite)."""
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    within = bool(torch.isfinite(got).all() and (diff <= bound).all())
    return diff.max().item(), within


# the 3B's and the 72B's GQA ratio, 8 q heads per kv head: the 72B on one
# card (64 / 8), a 72B tp = 2 rank (32 / 4), the 3B and a 72B tp = 4 rank
# (16 / 2)
REP8_HEADS = ((64, 8), (32, 4), (16, 2))
# B1 at rep 8: the 64-frame request's second group step (G = 3600, 28,800
# packed rows, 150 row blocks per kv head) at every head count; at 16 / 2
# G = 1 (decode), 23 (184 rows: the decode kernel's largest), 24 (192:
# exactly one prefill row block) and 25 (a second, partial row block); and
# decode at the 1024-frame headline's occupancy
REP8_CASES = ([(3600, 1807, 16384, hq, hkv) for hq, hkv in REP8_HEADS]
              + [(g, 1000, 4096, 16, 2) for g in (1, 23, 24, 25)]
              + [(1, 57344, 65536, hq, hkv) for hq, hkv in ((64, 8), (16, 2))])


def check_flash(dev, cases):
    """B1 on a 2-layer stacked cache, layer 1, D=128; a case is (G, length,
    cap), with Hq=28 / Hkv=4, or (G, length, cap, Hq, Hkv) (a tp rank's
    heads); each row names the kernel _plan picked for its shape. Its time is the B1
    kernels' device time (torch.profiler; host-timed beside it). The
    explicit-mask SDPA yardstick is skipped where its mask would exceed
    5e7 elements (the headline's last step: check_b1_headline_sdpa times
    SDPA there); below 64 rows it is also timed on the device."""
    import torch

    from quickvideo_tpu_torch.ops.attention import cache_attention
    from quickvideo_tpu_torch.ops.flash_attention import (
        _plan,
        flash_past_attention,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for g, length, cap, *heads in cases:
        hq, hkv = heads or (28, 4)
        k_all = torch.randn(2, hkv, cap, 128, generator=gen,
                            device=dev).bfloat16()
        v_all = torch.randn(2, hkv, cap, 128, generator=gen,
                            device=dev).bfloat16()
        # q as the projection lays it out: (G, Hq, D) storage, (Hq, G, D) view
        q = torch.randn(g, hq, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)
        scale = 128 ** -0.5
        got, _ = flash_past_attention(q, k_all[1], v_all[1], length, scale)
        ref, _ = cache_attention(q, k_all[1], v_all[1], length, scale)
        err, within = _compare(got, ref)

        def kernel():
            return flash_past_attention(q, k_all[1], v_all[1], length, scale)

        host_ms = _time_ms(kernel, 20)
        ms = _device_ms(kernel, B1_NAMES, 20)
        plain_ms = _time_ms(
            lambda: cache_attention(q, k_all[1], v_all[1], length, scale), 3
        )
        library_ms = (sdpa_ms(q, k_all[1], v_all[1], length)
                      if g * (length + g) <= 5e7 else None)
        # at decode the host sets a call's pace: SDPA by device time too
        library_dev = (sdpa_ms(q, k_all[1], v_all[1], length, device=True)
                       if g < 64 else None)
        bound_ms, bound_by = flash_bound(g, length, hq=hq, hkv=hkv)
        kernel = _plan(g, hq, hkv, length, cap, True, sms).kernel
        ok = within
        log(f"B1 {kernel} Hq={hq} Hkv={hkv} G={g} length={length} cap={cap}: "
            f"max_abs_err="
            f"{err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|) kernel "
            f"device {ms:.4f} ms (host-timed {host_ms:.4f} ms) plain "
            f"{plain_ms:.4f} ms sdpa "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
            + ("" if library_dev is None else
               f" (device {library_dev:.4f} ms, kernel x"
               f"{ms / library_dev:.2f})")
            + f" bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.0f}% of it) {'OK' if ok else 'FAIL'}")
        rows.append(dict(g=g, length=length, heads=(hq, hkv), kernel=kernel,
                         err=err, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=library_ms, library_dev_ms=library_dev,
                         bound_ms=bound_ms, bound_by=bound_by, ok=ok))
        del k_all, v_all
    return rows


def check_flash_int8(dev, cases):
    """B1's int8-QK variants (int8 K and V; int8 K with bf16 V) against
    their plain version on the same int8 codes, on a 2-layer stacked cache
    quantized from seeded bf16 rows, layer 1, D=128, heads as in
    check_flash's cases; and the bf16 kernel's time at the same shape (bf16
    cache of the same rows).
    Both plain versions round the PV operand (p, or p * vs) to bf16 as the
    kernels do, so B1's bf16 tolerance holds. A row's time is the B1
    kernels' device time: the q quantize runs outside the kernel, as in the
    JAX package, and is timed apart."""
    import torch

    from quickvideo_tpu_torch.ops.attention import (
        cache_attention_int8,
        quantize_q,
    )
    from quickvideo_tpu_torch.ops.flash_attention import (
        _plan,
        flash_past_attention,
    )
    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    scale = 128 ** -0.5
    rows = []
    for g, length, cap, *heads in cases:
        hq, hkv = heads or (28, 4)
        k = torch.randn(hkv, cap, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(hkv, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(g, hq, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)

        def bf16():
            return flash_past_attention(q, k, v, length, scale)[0]

        bf16_ms = _time_ms(bf16, 10)
        bf16_dev = _device_ms(bf16, B1_NAMES, 10)
        q_ms = _time_ms(lambda: quantize_q(q, scale), 10)
        row = dict(g=g, length=length, heads=(hq, hkv), bf16_ms=bf16_ms,
                   q_ms=q_ms, ok=True)
        for variant, mode in (("int8", True), ("int8k", "k")):
            cache = init_cache(2, hkv, cap, 128, device=dev, quantized=mode)
            stacked_append(cache, 1, 0, k, v)
            ks = cache.k_scale[1]
            vs = None if cache.v_scale is None else cache.v_scale[1]

            def kernel():
                return flash_past_attention(q, cache.k[1], cache.v[1], length,
                                            scale, k_scale=ks, v_scale=vs)[0]

            def plain():
                q8, qs = quantize_q(q, scale)
                return cache_attention_int8(
                    q8, qs, cache.k[1], ks, cache.v[1], vs, length,
                    torch.bfloat16,
                )[0]

            err, within = _compare(kernel(), plain())
            host_ms = _time_ms(kernel, 10)
            ms = _device_ms(kernel, B1_NAMES, 10)
            plain_ms = _time_ms(plain, 2)
            bound_ms, bound_by = flash_bound(g, length, variant, hq=hq,
                                             hkv=hkv)
            kname = _plan(g, hq, hkv, length, cap, True, sms, variant).kernel
            row.update({variant: dict(err=err, ms=ms, host_ms=host_ms,
                                      plain_ms=plain_ms, kernel=kname,
                                      bound_ms=bound_ms, bound_by=bound_by)})
            row["ok"] &= within
            log(f"B1 {variant} ({kname}) Hq={hq} Hkv={hkv} G={g} "
                f"length={length} cap={cap}: "
                f"max_abs_err={err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}"
                f"*|plain|) kernel device {ms:.4f} ms, {100 * bound_ms / ms:.0f}"
                f"% of the bound (host-timed with the q quantize {host_ms:.4f}"
                f" ms; the quantize alone {q_ms:.4f} ms) plain "
                f"{plain_ms:.4f} ms, bf16 kernel {bf16_ms:.4f} ms (device "
                f"{bf16_dev:.4f} ms), bound {bound_ms:.4f} ms ({bound_by}) "
                f"{'OK' if within else 'FAIL'}")
            del cache
        rows.append(row)
        del k, v, q
        torch.cuda.empty_cache()
    return rows


def check_flash_modes(dev, cases):
    """B1's lse output and pure-past mode against their plain versions, on
    the bf16, int8 and int8k caches (one layer quantized from seeded bf16
    rows), D=128: out and lse errors apart, B1 device times. A case is
    (causal, G, length, cap) at Hq=28 / Hkv=4, or (causal, G, length, cap,
    Hq, Hkv); pure past writes the f32 output the query-based merge takes,
    unified + lse the hot path's bf16 output."""
    import torch

    from quickvideo_tpu_torch.ops.attention import (
        NEG_INF,
        cache_attention,
        cache_attention_int8,
        quantize_q,
    )
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    scale = 128 ** -0.5
    rows = []
    for causal, g, length, cap, *heads in cases:
        hq, hkv = heads or (28, 4)
        k = torch.randn(hkv, cap, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(hkv, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(g, hq, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)
        out_dtype = torch.bfloat16 if causal else torch.float32
        mode = dict(causal=causal, with_lse=True, out_dtype=out_dtype)
        name = "unified+lse" if causal else "past+lse"
        for variant in ("bf16", "int8", "int8k"):
            kw = {}
            kl, vl = k, v
            if variant != "bf16":
                cache = init_cache(1, hkv, cap, 128, device=dev,
                                   quantized=True if variant == "int8" else "k")
                stacked_append(cache, 0, 0, k, v)
                kl, vl = cache.k[0], cache.v[0]
                kw = dict(k_scale=cache.k_scale[0], v_scale=(
                    None if cache.v_scale is None else cache.v_scale[0]))

            def kernel():
                return flash_past_attention(q, kl, vl, length, scale, **kw,
                                            **mode)

            def plain():
                if not kw:
                    return cache_attention(q, kl, vl, length, scale, **mode)
                q8, qs = quantize_q(q, scale)
                return cache_attention_int8(
                    q8, qs, kl, kw["k_scale"], vl, kw["v_scale"], length,
                    torch.bfloat16, **mode,
                )

            (out, lse), (ref, ref_lse) = kernel(), plain()
            err, within = _compare(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            ok = within and out.dtype == out_dtype and bool(
                torch.isfinite(lse).all() and lse_err <= LSE_ATOL
            )
            if not causal and length == 0:  # nothing to see: 0 and NEG_INF
                ok &= not out.any() and bool((lse == NEG_INF).all())
            host_ms = _time_ms(kernel, 10)
            ms = _device_ms(kernel, B1_NAMES, 10)
            plain_ms = _time_ms(plain, 2)
            bound_ms, bound_by = flash_bound(
                g, length, variant, causal, out_dtype.itemsize, with_lse=True,
                hq=hq, hkv=hkv)
            lib = ""
            library_ms = None  # no PyTorch call takes an int8 cache
            if variant == "bf16":
                library_ms, lib_out, lib_lse = sdpa_lse_ms(q, k, v, length,
                                                           causal)
                if library_ms is not None:
                    d_out = (lib_out.float() - ref.float()).abs().max()
                    d_lse = (lib_lse - ref_lse).abs().max()
                    lib = (f" memory-efficient SDPA with lse "
                           f"{library_ms:.4f} ms (its out / lse against the "
                           f"plain version {d_out.item():.3e} / "
                           f"{d_lse.item():.3e})")
                del lib_out, lib_lse
            log(f"B1 {variant} {name} Hq={hq} Hkv={hkv} G={g} "
                f"length={length} cap={cap}: out max_abs_err={err:.3e} "
                f"(tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), lse "
                f"max_abs_err={lse_err:.3e} (tol {LSE_ATOL}) kernel device "
                f"{ms:.4f} ms (host-timed {host_ms:.4f} ms) plain "
                f"{plain_ms:.4f} ms "
                f"bound {bound_ms:.4f} ms ({bound_by}, "
                f"{100 * bound_ms / ms:.0f}% of it){lib} "
                f"{'OK' if ok else 'FAIL'}")
            rows.append(dict(variant=variant, mode=name, g=g, length=length,
                             heads=(hq, hkv), err=max(err, lse_err), ms=ms,
                             host_ms=host_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, ok=ok))
            del kl, vl, kw
            if variant != "bf16":
                del cache
        del k, v, q
        torch.cuda.empty_cache()
    return rows


def check_vision(dev, cases):
    """B2 at nh=16, hd=80 on strided q/k/v views of one fused projection,
    bf16 rotary tables (the tower casts them once per forward). Spans above
    SHORT_SPAN run the rotary pass, then the long-span kernel: one rotary
    launch per B2 call there, none on shorter spans (each row is rotated
    once per call); q and k are left as they were."""
    import torch

    from quickvideo_tpu_torch.ops.vision_attention import (
        SHORT_SPAN,
        apply_vision_rotary,
        block_diag_attention_2d,
        block_diag_attention_2d_plain,
        vision_rotary,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for span, s_len in cases:
        qkv = torch.randn(s_len, 3 * 1280, generator=gen, device=dev).bfloat16()
        q, k, v = (qkv[:, i * 1280 : (i + 1) * 1280].view(s_len, 16, 80)
                   for i in range(3))
        ang = torch.rand(s_len, 40, generator=gen, device=dev) * 6.28
        emb = torch.cat([ang, ang], dim=-1)
        cos, sin = torch.cos(emb).bfloat16(), torch.sin(emb).bfloat16()
        scale = 80 ** -0.5
        before = qkv.clone()
        rot0 = vision_rotary.launches
        got = block_diag_attention_2d(q, k, v, cos, sin, span, scale)
        rot_launches = vision_rotary.launches - rot0
        ref = block_diag_attention_2d_plain(q, k, v, cos, sin, span, scale)
        err, within = _compare(got, ref)
        within &= bool(torch.equal(qkv, before))
        within &= rot_launches == int(span > SHORT_SPAN)
        del before
        ms = _time_ms(
            lambda: block_diag_attention_2d(q, k, v, cos, sin, span, scale), 20
        )
        plain_ms = _time_ms(
            lambda: block_diag_attention_2d_plain(q, k, v, cos, sin, span,
                                                  scale),
            3,
        )
        # the spans as one batched SDPA call on rotated q, k (rotary applied
        # outside the timed call; the kernel fuses it)
        library_ms = None
        if s_len % span == 0:
            import torch.nn.functional as F

            def spans(x):
                return x.reshape(s_len // span, span, 16, 80).transpose(1, 2)

            qs_ = spans(apply_vision_rotary(q, cos, sin))
            ks_ = spans(apply_vision_rotary(k, cos, sin))
            vs_ = spans(v.contiguous())
            library_ms = _time_ms(
                lambda: F.scaled_dot_product_attention(qs_, ks_, vs_), 20
            )
        # q, k, v and the rotary tables read, out written; QK and PV over
        # each span's rows x rows
        pairs = (s_len // span) * span * span + (s_len % span) ** 2
        bound_ms, bound_by = bound(nbytes(q, k, v, cos, sin, got),
                                   {"bf16": 4 * 16 * 80 * pairs})
        ok = within
        log(f"B2 span={span} S={s_len} ({'long' if span > SHORT_SPAN else 'short'}"
            f"-span kernel, {rot_launches} rotary launch): max_abs_err="
            f"{err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|; inputs "
            f"unmodified) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms sdpa "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} bound "
            f"{bound_ms:.4f} ms ({bound_by}) {'OK' if ok else 'FAIL'}")
        rows.append(dict(span=span, s=s_len, err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, ok=ok))
    return rows


def check_rotary(dev, s_len):
    """The rotary pass at nh=16, hd=80 on strided q/k views of one fused
    projection, bf16 tables: kernel against its plain version (the same
    rounding points, so equal bit for bit is expected; held to the kernel
    tolerance), q and k left unmodified; time, plain time, bytes bound (q,
    k and the tables read, the rotated q and k written)."""
    import torch

    from quickvideo_tpu_torch.ops.vision_attention import (
        vision_rotary,
        vision_rotary_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    qkv = torch.randn(s_len, 3 * 1280, generator=gen, device=dev).bfloat16()
    q, k = (qkv[:, i * 1280 : (i + 1) * 1280].view(s_len, 16, 80)
            for i in range(2))
    ang = torch.rand(s_len, 40, generator=gen, device=dev) * 6.28
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(emb).bfloat16(), torch.sin(emb).bfloat16()
    before = qkv.clone()
    got, ref = vision_rotary(q, k, cos, sin), vision_rotary_plain(q, k, cos, sin)
    err_q, ok_q = _compare(got[0], ref[0])
    err_k, ok_k = _compare(got[1], ref[1])
    equal = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
    ok = ok_q and ok_k and bool(torch.equal(qkv, before))
    ms = _time_ms(lambda: vision_rotary(q, k, cos, sin), 20)
    plain_ms = _time_ms(lambda: vision_rotary_plain(q, k, cos, sin), 5)
    bound_ms, bound_by = bound(nbytes(q, k, cos, sin, got), {})
    log(f"rotary pass S={s_len}: max_abs_err={max(err_q, err_k):.3e} (tol "
        f"{KERNEL_ATOL} + {KERNEL_RTOL}*|plain|; bit-equal {equal}; inputs "
        f"unmodified) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{bound_ms:.4f} ms ({bound_by}) {'OK' if ok else 'FAIL'}")
    del qkv, before, got, ref
    return dict(s=s_len, err=max(err_q, err_k), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, ok=ok)


VISION_KERNEL_NAMES = (
    "vision_rotary_kernel", "short_span_kernel<rotary> (B2)",
    "short_span_kernel (B5)", "short_span_kernel<masked> (B5)",
    "long_span_kernel (B2, B5)", "long_span_kernel<masked> (B5)",
)


def vision_kernel_info():
    """Registers, spilled (local) bytes and shared memory of each vision
    kernel, from cudaFuncGetAttributes (csrc/vision_attention.cu's
    qv_vision_kernel_info). Returns whether every query succeeded."""
    import ctypes

    from quickvideo_tpu_torch import _build

    lib = _build.library()
    ok = True
    for i, name in enumerate(VISION_KERNEL_NAMES):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.qv_vision_kernel_info(i, *(ctypes.byref(v) for v in vals))
        ok &= err == 0
        regs, local, smem, dyn = (v.value for v in vals)
        log(f"{name}: {regs} registers, {local} B spilled (local), {smem} B "
            f"static + {dyn} B dynamic shared memory"
            f"{'' if err == 0 else f' FAIL (CUDA error {err})'}")
    return ok


# qv_flash_kernel_info's families, 8 modes each (the merge kernel: 4)
FLASH_KERNEL_FAMILIES = (
    "flash_decode_kernel<bf16>", "flash_decode_kernel<int8>",
    "flash_decode_kernel<int8k>", "flash_prefill_kernel<bf16>",
    "flash_prefill_kernel<int8>", "flash_prefill_kernel<int8k>",
    "flash_merge_kernel",
)


def flash_kernel_info():
    """Registers, spilled (local) bytes and shared memory of every B1
    instantiation, from cudaFuncGetAttributes (csrc/flash_attention.cu's
    qv_flash_kernel_info; the prefill kernels' registers are their launch
    count, before setmaxnreg moves them to the consumers). Returns whether
    every query succeeded and no instantiation spills."""
    import ctypes

    from quickvideo_tpu_torch import _build

    lib = _build.library()
    ok = True
    for which in range(8 * len(FLASH_KERNEL_FAMILIES) - 4):
        family, m = divmod(which, 8)
        mode = (("past" if m & 4 else "unified") + ("+lse" if m & 2 else "")
                + (", f32 out" if m & 1 else ", bf16 out"))
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.qv_flash_kernel_info(which, *(ctypes.byref(v) for v in vals))
        regs, local, smem, dyn = (v.value for v in vals)
        ok &= err == 0 and local == 0
        why = (f" FAIL (CUDA error {err})" if err else
               " FAIL (spills)" if local else "")
        log(f"{FLASH_KERNEL_FAMILIES[family]} [{mode}]: {regs} registers, "
            f"{local} B spilled (local), {smem} B static + {dyn} B dynamic "
            f"shared memory{why}")
    return ok


def check_b1_headline_sdpa(dev, g=3600, length=53744, cap=65536):
    """B1 (bf16) against one SDPA call at the 1024-frame headline's last
    group step: pure past (G rows over `length` slots, no mask) and unified
    causal (G rows over length + G slots, the mask aligned to the lower
    right, `causal_lower_right`). The 4 kv heads are expanded to the 28
    query heads outside the timed call. Timed for comparison only."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    k = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
    v = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
    q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
    q = q.transpose(0, 1)
    scale = 128 ** -0.5
    rows = []
    for causal in (False, True):
        n = length + g if causal else length
        qb = q.contiguous()[None]
        kb = k[:, :n].repeat_interleave(7, dim=0)[None]
        vb = v[:, :n].repeat_interleave(7, dim=0)[None]
        mask = causal_lower_right(g, n) if causal else None
        sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=scale), 5)
        ms = _time_ms(lambda: flash_past_attention(
            q, k, v, length, scale, causal=causal), 5)
        bound_ms, bound_by = flash_bound(g, length, causal=causal)
        what = "unified causal" if causal else "pure past"
        log(f"B1 bf16 {what} G={g} length={length}: kernel {ms:.4f} ms, "
            f"one SDPA call {sdpa:.4f} ms (x{ms / sdpa:.2f}), bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        rows.append(dict(causal=causal, ms=ms, library_ms=sdpa,
                         bound_ms=bound_ms))
        del kb, vb
    del k, v, q
    torch.cuda.empty_cache()
    return rows


def check_b5(dev, cases):
    """B5 at nh=16, hd=80 on strided q/k/v views of one fused projection
    (rotary applied outside, as the head-major route does). A case is
    (span, S, masked): masked cases give each span a ragged count of valid
    keys (some none), as tests/test_vision_attention.py's padded windows,
    and compare the valid rows only. The yardstick is one batched SDPA call
    over the spans, which computes B5's function (with the validity as its
    mask)."""
    import torch
    import torch.nn.functional as F

    from quickvideo_tpu_torch.ops.vision_attention import (
        block_diag_attention,
        block_diag_attention_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    scale = 80 ** -0.5
    rows = []
    for span, s_len, masked in cases:
        qkv = torch.randn(s_len, 3 * 1280, generator=gen, device=dev).bfloat16()
        q, k, v = (qkv[:, i * 1280 : (i + 1) * 1280].view(s_len, 16, 80)
                   for i in range(3))
        n = s_len // span
        valid = None
        if masked:
            counts = torch.randint(0, span + 1, (n,), generator=gen,
                                   device=dev)
            counts[0], counts[-1] = 0, span  # a dead span and a full one
            valid = (torch.arange(span, device=dev)[None, :]
                     < counts[:, None]).reshape(-1)

        def kernel():
            return block_diag_attention(q, k, v, span, scale=scale,
                                        valid=valid)

        def plain():
            return block_diag_attention_plain(q, k, v, span, scale, valid)

        got, ref = kernel(), plain()
        live = slice(None) if valid is None else valid
        err, within = _compare(got[live], ref[live])
        if masked:  # a span without a valid key is 0 in both
            dead = ~valid.reshape(n, span).any(1).repeat_interleave(span)
            within &= not got[dead].any() and not ref[dead].any()
        ms = _time_ms(kernel, 20)
        plain_ms = _time_ms(plain, 3)

        def spans(x):
            return x.reshape(n, span, 16, 80).transpose(1, 2)

        qs_, ks_, vs_ = spans(q), spans(k), spans(v)
        mask = None if valid is None else valid.reshape(n, 1, 1, span)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, attn_mask=mask), 20)
        # q, k, v (and the validity) read, out written; QK and PV over each
        # row and the valid keys of its span
        keys = (span * n * span if valid is None
                else span * int(valid.sum().item()))
        bound_ms, bound_by = bound(nbytes(q, k, v, got, valid),
                                   {"bf16": 4 * 16 * 80 * keys})
        log(f"B5 span={span} S={s_len}{' masked' if masked else ''}: "
            f"max_abs_err={err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}"
            f"*|plain|{', valid rows' if masked else ''}) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) {'OK' if within else 'FAIL'}")
        rows.append(dict(span=span, s=s_len, masked=masked, err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, ok=within))
        del qkv, q, k, v, got, ref
    torch.cuda.empty_cache()
    return rows


def _capture_fused_failure(name, kernel, plain, args, got, ref):
    """A B3/B4/B6 check failed (ROADMAP C12): print up to 8 differing rows,
    kernel and plain side by side (with their row scales where the output
    is quantized), then rerun both on the same inputs in this process and
    say whether each is bit-identical to its first run."""
    import torch

    quantized = isinstance(got, tuple)
    if quantized:
        (q, s), (qr, sr) = got, ref
        deq, deq_r = q.float() * s, qr.float() * sr
    else:
        deq, deq_r = got.float(), ref.float()
    bad = torch.nonzero((deq != deq_r).any(1)).flatten()
    # the worst rows first: by row scale (quantized outputs) or value
    worst = (((s - sr).abs() / sr).squeeze(1) if quantized
             else (deq - deq_r).abs().amax(1))[bad]
    bad = bad[torch.argsort(worst, descending=True)]
    log(f"{name} C12 capture: {bad.numel()} of {deq.shape[0]} rows differ; "
        "the worst 8:")
    for r in bad[:8].tolist():
        cols = torch.nonzero(deq[r] != deq_r[r]).flatten()[:4].tolist()
        vals = ", ".join(f"col {c}: kernel {deq[r, c].item():.6g} plain "
                         f"{deq_r[r, c].item():.6g}" for c in cols)
        scales = (f" scale kernel {s[r, 0].item():.9g} plain "
                  f"{sr[r, 0].item():.9g}" if quantized else "")
        log(f"  row {r}:{scales}; {vals}")

    def same(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    again, again_ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    log(f"  rerun in the same process: kernel "
        f"{'bit-identical' if same(again, got) else 'DIFFERENT'}, plain "
        f"{'bit-identical' if same(again_ref, ref) else 'DIFFERENT'}")


# B3/B4/B6 at the 7B tower's widths: row counts, seeds per row count, and
# the parts of a call by kernel name (the parent commit's kernels too)
FUSED_ROWS_CASES = (14400, 250, 90)
FUSED_SEEDS = 5
FUSED_TIMED = (14400, 250)
FUSED_PARTS = (("prologue", "ln_quantize"), ("requantize", "requantize"),
               ("GEMM", "gemm"))


def _fused_inputs(dev, s_len, seed):
    """One block's weights and S seeded rows: the B3, B4 and B6 cases as
    (name, kernel, plain, args, compare)."""
    import torch

    from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
    from quickvideo_tpu_torch.ops.quantization import quantize_act
    from quickvideo_tpu_torch.testing import (
        bf16_rows_close,
        fused_block,
        quantized_close,
    )

    bp = fused_block(dev, 1280, 3840, 3420, s_len + 1000 * seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(s_len + 1 + seed)
    x = torch.randn(s_len, 1280, generator=gen, device=dev).bfloat16()
    xq, xs = quantize_act(x)
    eps = 1e-6
    return (
        ("B3", fm.ln_gemm_bias, fm.ln_gemm_bias_plain,
         (x, bp["ln"], bp["wqkv"], bp["bqkv"], eps), bf16_rows_close),
        ("B4", fm.ln_dual_gemm_silu_quant, fm.ln_dual_gemm_silu_quant_plain,
         (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], eps), quantized_close),
        ("B6", fm.dual_gemm_silu_quant, fm.dual_gemm_silu_quant_plain,
         (xq, xs, bp["wgu_p"], bp["bgu_p"]), quantized_close),
    )


def _device_parts(fn, reps: int = 20, tries: int = 3) -> dict:
    """Device time per call of fn by part (FUSED_PARTS: the prologue, the
    GEMM, a requantize launch where the tree has one), from torch.profiler.
    A trace without one GEMM kernel per call is taken again; after `tries`
    such traces the call is timed by CUDA events ({"events": ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n_gemm = {}, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for label, frag in FUSED_PARTS:
                if frag in e.name:
                    us[label] = us.get(label, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
                    n_gemm += label == "GEMM"
                    break
        if n_gemm >= reps:
            return {k: v / 1e3 / reps for k, v in us.items()}
    log(f"torch.profiler recorded no GEMM kernel per call in {tries} "
        "traces: timed by CUDA events around the calls instead")
    return {"events": _time_ms(fn, reps)}


def _parts_text(parts: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items())


def _fused_bound(s_len, args, got):
    """B3/B4/B6's bound: the inputs and outputs once; the s8 GEMM(s) over
    S x 1280 x N (N = the bias width)."""
    return bound(nbytes(args, got), {"int8": 2 * s_len * 1280 * args[3].numel()})


def check_fused(dev, cases=FUSED_ROWS_CASES, seeds=FUSED_SEEDS):
    """B3, B4, B6 at the 7B tower's widths (C 1280, QKV N 3840, MLP I 3420
    padded to 3456) for each row count and seed, under
    quickvideo_tpu_torch/testing.py's rule; a failure prints its worst rows
    and reruns both sides (ROADMAP C12). Seed 0 at FUSED_TIMED row counts is
    timed: device time by part (torch.profiler), CUDA events, the plain
    version, the bound."""
    import torch

    rows = []
    for s_len in cases:
        for seed in range(seeds):
            for name, kernel, plain, args, compare in _fused_inputs(
                    dev, s_len, seed):
                got, ref = kernel(*args), plain(*args)
                err, ok, why = compare(got, ref)
                if not ok:
                    _capture_fused_failure(name, kernel, plain, args, got,
                                           ref)
                row = dict(name=name, s=s_len, seed=seed, err=err, ok=ok)
                line = (f"{name} S={s_len} seed {seed}: max_abs_err={err:.3e} "
                        f"(rule: quickvideo_tpu_torch/testing.py FUSED_*)")
                if seed == 0 and s_len in FUSED_TIMED:
                    parts = _device_parts(lambda: kernel(*args))
                    ms = sum(parts.values())
                    events_ms = _time_ms(lambda: kernel(*args), 20)
                    plain_ms = _time_ms(lambda: plain(*args), 5)
                    bound_ms, bound_by = _fused_bound(s_len, args, got)
                    row.update(ms=ms, parts=parts, events_ms=events_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
                    line += (f" kernels {ms:.4f} ms device ({_parts_text(parts)}"
                             f"), {100 * bound_ms / ms:.1f}% of the bound "
                             f"{bound_ms:.4f} ms ({bound_by}); events "
                             f"{events_ms:.4f} ms; plain {plain_ms:.4f} ms")
                log(f"{line} {'OK' if ok else 'FAIL: ' + why}")
                rows.append(row)
                del got, ref
            torch.cuda.empty_cache()
    return rows


FUSED_KERNEL_NAMES = (
    "ln_quantize_reg_kernel<8> (B3/B4 prologue, C <= 2048)",
    "gemm_bias_kernel (B3)", "gemm_silu_quant_kernel<64> (B4/B6)",
    "gemm_silu_quant_kernel<72> (B4/B6)",
    "ln_quantize_kernel (B3/B4 prologue, wider rows)",
)


def fused_kernel_info():
    """Registers, spilled (local) bytes and shared memory of the B3/B4/B6
    kernels (csrc/fused_vision_mlp.cu's qv_fused_kernel_info; B3's
    registers are its launch count, before setmaxnreg), and how many
    clusters of the B4/B6 plan at the 7B width the card keeps resident
    (qv_fused_max_clusters). Returns whether every query succeeded, no
    kernel spills and the plan can launch."""
    import ctypes

    from quickvideo_tpu_torch import _build
    from quickvideo_tpu_torch.ops import fused_vision_mlp as fm

    lib = _build.library()
    ok = True
    for i, name in enumerate(FUSED_KERNEL_NAMES):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.qv_fused_kernel_info(i, *(ctypes.byref(v) for v in vals))
        regs, local, smem, dyn = (v.value for v in vals)
        ok &= err == 0 and local == 0
        why = (f" FAIL (CUDA error {err})" if err else
               " FAIL (spills)" if local else "")
        log(f"{name}: {regs} registers, {local} B spilled (local), {smem} B "
            f"static + {dyn} B dynamic shared memory (0: the plan's){why}")
    plan = fm.mlp_plan(3456)
    n = ctypes.c_int()
    err = lib.qv_fused_max_clusters(plan.chunk, plan.cluster, plan.nch,
                                    plan.stages, ctypes.byref(n))
    ok &= err == 0 and n.value >= 1
    log(f"B4/B6 plan at Np=3456 {plan}: {n.value} clusters resident "
        f"({n.value * plan.cluster} CTAs){'' if err == 0 and n.value else ' FAIL'}")
    return ok


def int_mm_yardstick(dev):
    """torch._int_mm's device time on the products alone, (14,400 x 1280)
    times (1280 x 3840) and (1280 x 6912): a yardstick for the GEMM core
    (timed here only; no PyTorch call computes the fused functions)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    a = torch.randint(-127, 128, (14400, 1280), generator=gen, device=dev,
                      dtype=torch.int8)
    for n in (3840, 6912):
        w = torch.randint(-127, 128, (n, 1280), generator=gen, device=dev,
                          dtype=torch.int8).t()
        ms = _device_ms(lambda: torch._int_mm(a, w), ("",), 20)
        bound_ms, _ = bound(0, {"int8": 2 * 14400 * 1280 * n})
        log(f"torch._int_mm 14400 x 1280 x {n} (yardstick): device {ms:.4f} "
            f"ms, {100 * bound_ms / ms:.1f}% of the ops bound {bound_ms:.4f} ms")


def compare_fused(dev, tree):
    """B3, B4, B6 of the package imported from `tree` (this checkout, or an
    older one) at S = 14,400 and 250, seed 0: device time per call by part
    (torch.profiler), its share of the bound, the error against the plain
    version. Returns whether every output agreed."""
    import torch

    ok = True
    for s_len in FUSED_TIMED:
        for name, kernel, plain, args, compare in _fused_inputs(dev, s_len, 0):
            got, ref = kernel(*args), plain(*args)
            err, within, why = compare(got, ref)
            ok &= within
            parts = _device_parts(lambda: kernel(*args))
            ms = sum(parts.values())
            bound_ms, bound_by = _fused_bound(s_len, args, got)
            log(f"{name} compare [{tree}] S={s_len}: device {ms:.4f} ms "
                f"({_parts_text(parts)}), bound {bound_ms:.4f} ms "
                f"({bound_by}), {100 * bound_ms / ms:.1f}% of it; "
                f"max_abs_err {err:.3e} {'OK' if within else 'FAIL: ' + why}")
            del got, ref
        torch.cuda.empty_cache()
    return ok


# -- phase 3: the main path ------------------------------------------------


def seeded_image(seed: int = 0) -> np.ndarray:
    """An IMAGE_HW RGB uint8 photo of seeded noise: at a size smart_resize
    keeps, so no PIL resize runs."""
    return np.random.default_rng(seed).integers(
        0, 256, (*IMAGE_HW, 3), dtype=np.uint8
    )


def make_request(cfg, tokenizer, question: str, seed: int,
                 n_frames: int = REQUEST_FRAMES,
                 group_frames: int = GROUP_FRAMES, image=None,
                 source_hw=None):
    """PrefillInputs for `n_frames` seeded-noise 420x420 yuv420 frames in
    groups of `group_frames` (each group's grid from its own frame count),
    with the chat template around them; `image`, an (H, W, 3) uint8 array,
    goes before the video, prepared as LVU.chat prepares it. `source_hw`:
    the frames come at that size instead, for the tower to resize to the
    420x420 grid on the device (native_hw)."""
    from quickvideo_tpu_torch.engines.qwen25 import _prepare_images
    from quickvideo_tpu_torch.tokenization import build_chat_ids_from_messages
    from quickvideo_tpu_torch.prefill import PrefillInputs

    ps, ms = cfg.vision.patch_size, cfg.vision.spatial_merge_size
    tps = cfg.vision.temporal_patch_size
    gh = gw = FRAME_HW // ps
    rng = np.random.default_rng(seed)
    sh, sw = source_hw or (FRAME_HW, FRAME_HW)
    frames = rng.integers(0, 256, (n_frames, sh * sw * 3 // 2), dtype=np.uint8)
    groups, grids = [], []
    for off in range(0, n_frames, group_frames):
        groups.append(frames[off : off + group_frames])
        grids.append((-(-len(groups[-1]) // tps), gh, gw))
    n_vid = sum(t * (h // ms) * (w // ms) for t, h, w in grids)
    content = [{"type": "video", "video": "<seeded frames>"},
               {"type": "text", "text": question}]
    images = {}
    counts = ()
    if image is not None:
        content.insert(0, {"type": "image", "image": image})
        px, img_grids, counts = _prepare_images(cfg, [content[0]])
        images = dict(image_grid_thw=img_grids, image_pixels=px)
    ids = build_chat_ids_from_messages(
        tokenizer, cfg, [{"role": "user", "content": content}], n_vid,
        image_token_counts=counts,
    )
    return PrefillInputs(
        input_ids=ids,
        video_grid_thw=(sum(g[0] for g in grids), gh, gw),
        pixel_groups=groups,
        group_grids=grids,
        second_per_grid_ts=1.0,
        native_hw=source_hw,
        **images,
    )


def group_layer_rows(lvu, inputs):
    """Per group, the video rows that reach each layer's group step, from
    the config's rules: layer li keeps resolve_effective_top_k of the rows
    that reach it (all of them where that is 0); from
    prefill_prune_starting_layer on, a pruning layer passes only its kept
    rows to the next (the cascade). Group 0's rows include the prefix."""
    from quickvideo_tpu_torch.config import resolve_effective_top_k

    cfg, lc = lvu.model_config, lvu.config
    ids = np.asarray(inputs.input_ids)
    vid = np.nonzero(ids == cfg.video_token_id)[0]
    n = cfg.text.num_hidden_layers
    ms = cfg.vision.spatial_merge_size
    lens = [t * (h // ms) * (w // ms) for t, h, w in inputs.group_grids]
    lens[0] += int(vid[0])
    psl = lc.prefill_prune_starting_layer
    out = []
    for rows in lens:
        per_layer = []
        for li in range(n):
            per_layer.append(rows)
            k = resolve_effective_top_k(lc, li, n, rows)
            if isinstance(psl, int) and 0 <= psl <= li and k > 0:
                rows = k
        out.append(per_layer)
    return out


def expected_lengths(lvu, inputs, n_tokens):
    """(cache_length, per-layer lengths) a request must end with, from the
    config's rules: layer li of a group keeps resolve_effective_top_k of the
    video rows that reach it (group_layer_rows). cache_length counts each
    group's largest keep over the layers on its full rows, as the JAX
    engine does. The suffix (its layer-0 keep with do_top_k_for_query) and
    the decoded tokens follow."""
    from quickvideo_tpu_torch.config import resolve_effective_top_k

    cfg, lc = lvu.model_config, lvu.config
    ids = np.asarray(inputs.input_ids)
    vid = np.nonzero(ids == cfg.video_token_id)[0]
    n = cfg.text.num_hidden_layers
    layers = [0] * n
    logical = 0
    for per_layer in group_layer_rows(lvu, inputs):
        for li, rows in enumerate(per_layer):
            layers[li] += resolve_effective_top_k(lc, li, n, rows) or rows
        g = per_layer[0]
        logical += max(resolve_effective_top_k(lc, li, n, g) or g
                       for li in range(n))
    suffix = len(ids) - int(vid[-1]) - 1
    if lc.do_top_k_for_query:
        suffix = resolve_effective_top_k(lc, 0, n, suffix) or suffix
    tail = suffix + max(0, n_tokens - 1)
    return logical + tail, [x + tail for x in layers]


def expected_b1(lvu, inputs, n_tokens, variant):
    """B1 launches of one request per "flash_{variant}_{mode}" key: each
    group step of each layer in the group's mode (pure past + lse for the
    query-based past partial, unified + lse for an attention-statistics
    predictor, else unified); the final prefill unified, with the lse where
    do_top_k_for_query prunes it with probabilities; each decode step
    unified."""
    lc = lvu.config
    n = lvu.model_config.text.num_hidden_layers
    group = ("past+lse" if lc.query_based else
             "unified+lse" if lc.needs_attn_stats else "unified")
    final = ("unified+lse" if lc.do_top_k_for_query and (
        lc.query_based or lc.needs_attn_stats) else "unified")
    want = {}
    for mode, launches in ((group, len(inputs.group_grids) * n),
                           (final, n), ("unified", (n_tokens - 1) * n)):
        key = f"flash_{variant}_{mode}"
        want[key] = want.get(key, 0) + launches
    return want


B1_VARIANTS = ("bf16", "int8", "int8k")
B1_MODES = ("unified", "unified+lse", "past", "past+lse")


def _reset_counters(counters):
    from quickvideo_tpu_torch.ops.flash_attention import reset_launch_counts

    for fn in counters.values():
        fn.launches = 0
    reset_launch_counts()


B1_KERNELS = ("bf16_prefill", "int8_prefill", "decode")


def b1_kernels(lvu, rows, variant="bf16"):
    """B1 launches per "flash_kernel_{name}" key of launches of `rows`
    query rows each, by _plan's row-tile rule: the prefill kernel of the
    cache's variant at rows x (q heads / kv heads) >= PREFILL_ROWS, the
    decode kernel below."""
    from quickvideo_tpu_torch.ops.flash_attention import PREFILL_ROWS

    t = lvu.model_config.text
    rep = t.num_attention_heads // t.num_key_value_heads
    prefill = "bf16_prefill" if variant == "bf16" else "int8_prefill"
    want = dict.fromkeys((f"flash_kernel_{k}" for k in B1_KERNELS), 0)
    for g in rows:
        want[f"flash_kernel_{prefill if g * rep >= PREFILL_ROWS else 'decode'}"] += 1
    return want


def expected_kernels(lvu, inputs, n_tokens, variant):
    """B1 launches of one request per "flash_kernel_{name}" key: each group
    step and the final prefill (its exact suffix length) at the rows that
    reach the layer (group_layer_rows; a query-based step's prompt rows
    only add to them), and every decode step (G = 1), by b1_kernels."""
    n = lvu.model_config.text.num_hidden_layers
    ids = np.asarray(inputs.input_ids)
    vid = np.nonzero(ids == lvu.model_config.video_token_id)[0]
    suffix = len(ids) - int(vid[-1]) - 1
    steps = [g for per_layer in group_layer_rows(lvu, inputs)
             for g in per_layer]
    return b1_kernels(lvu, steps + [suffix] * n + [1] * ((n_tokens - 1) * n),
                      variant)


def _read_counters(counters):
    """Each wrapper's launches, B1's per variant ("flash_bf16",
    "flash_int8", "flash_int8k"), per variant and mode
    ("flash_bf16_unified+lse", ...) and per kernel
    ("flash_kernel_bf16_prefill", ...)."""
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    counts = {k: fn.launches for k, fn in counters.items()}
    for variant, n in flash_past_attention.variant_launches.items():
        counts[f"flash_{variant}"] = n
    for kernel in B1_KERNELS:
        counts[f"flash_kernel_{kernel}"] = (
            flash_past_attention.kernel_launches[kernel])
    for variant in B1_VARIANTS:
        for mode in B1_MODES:
            counts[f"flash_{variant}_{mode}"] = (
                flash_past_attention.mode_launches[variant, mode]
            )
    return counts


def _kernel_counters():
    from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
    from quickvideo_tpu_torch.ops.vision_attention import (
        block_diag_attention,
        block_diag_attention_2d,
        vision_rotary,
    )

    return {
        "flash": flash_past_attention,
        "vision_2d": block_diag_attention_2d,  # B2
        "vision_hm": block_diag_attention,  # B5, the head-major route
        "rotary": vision_rotary,  # the rotary pass
        "ln_gemm": fm.ln_gemm_bias,
        "ln_mlp": fm.ln_dual_gemm_silu_quant,
        "mlp_pre": fm.dual_gemm_silu_quant,
    }


MODEL_7B = "qwen25-vl-7b"


def model_config(model=MODEL_7B, layers=None):
    """The preset `model`'s ModelConfig, at `layers` decoder layers where
    that is given (full width, depth cut)."""
    import dataclasses

    from quickvideo_tpu_torch.models.qwen25_vl.config import get_config

    cfg = get_config(model)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers))


def make_lvu(dev, param_dtype, kv_cache_dtype="auto", kv_cache_capacity=None,
             params=None, model=MODEL_7B, layers=None, fast=False, **pruning):
    """LVU for the preset `model` (qwen25-vl-7b by default) at full width
    and depth (`layers` decoder layers where given), random weights from
    seed 0 (init_params' normals, _seeded_weights), or with `fast` the
    preset path's own deterministic weights (phase 3m), or `params`, as
    the main path runs it ("auto" KV, which resolves to bf16 for the
    64-frame requests on one card); `pruning` overrides the
    key_norms_small policy's LVUConfig fields."""
    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.api import LVU

    cfg = LVUConfig(
        model_name_or_path=model,
        model_type="qwen25_lvu_interleaved",
        video_group_size=GROUP_FRAMES,
        num_frames=REQUEST_FRAMES,
        top_p=0.5,
        top_k_predict_type="key_norms_small",
        max_decode_tokens=16,
        decode_output="yuv420",
        dtype="bfloat16",
        param_dtype=param_dtype,
        kv_cache_dtype=kv_cache_dtype,
        kv_cache_capacity=kv_cache_capacity,
        seed=0,
    ).replace(**pruning)
    with _preset(model, model_config(model, layers)), (
            contextlib.nullcontext() if fast else _seeded_weights()):
        return LVU(cfg, params=params, device=dev)


def _seeded_weights():
    """A context inside which the port's preset path draws init_params'
    seeded normals from the config's seed: every phase but 3m runs them,
    since their limits were set on them; the preset's own weights after
    it."""
    from unittest import mock

    from quickvideo_tpu_torch import api
    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params

    def drawn(mcfg, cfg, dtype, device, mesh):
        return init_params(mcfg, cfg.seed, dtype, device,
                           param_dtype=cfg.param_dtype, mesh=mesh)

    return mock.patch.object(api, "preset_params", drawn)


@contextlib.contextmanager
def _preset(model, cfg):
    """The port's preset `model` is `cfg` inside the block (an LVU
    resolves its model name once, as it is built), the published one
    again after it."""
    from quickvideo_tpu_torch.models.qwen25_vl.config import PRESETS

    published = PRESETS[model]
    PRESETS[model] = cfg
    try:
        yield
    finally:
        PRESETS[model] = published


# request 0 of each run_main_path call, by (param_dtype, kv_cache_dtype):
# its tokens, final-prefill logits (host f32), lengths, retained sets,
# memory and walls (reference_record), which phases 3i and 3j hold their
# mesh runs against
MAIN_PATH_REFERENCE = {}
# phase 3j's sampled decode (on the card, from a fresh generator), streamed
# request and scored options (the engine call under loglikelihood_multi:
# 2, 5, 9 and 12 token ids), run by one rank and by the pipeline alike
PP_SAMPLING = dict(greedy=False, temperature=0.8, top_p=0.9, top_k=50)
PP_SCORE_OPTIONS = ([300, 301], list(range(400, 405)), list(range(500, 509)),
                    list(range(600, 612)))


def pp_extras(lvu, inputs):
    """Request `inputs` sampled on the card (the engine's generator fresh:
    the first sampled call of `lvu`), streamed (the on_tokens chunks) and
    scored against PP_SCORE_OPTIONS; for phase 3j, on one rank and on the
    pipeline's stages alike."""
    eos = [lvu.tokenizer.eos_token_id]
    sampled = lvu.engine.generate(inputs, max_new_tokens=8,
                                  eos_token_ids=eos, **PP_SAMPLING)
    chunks = []
    lvu.engine.generate(inputs, max_new_tokens=8, eos_token_ids=eos,
                        on_tokens=lambda t: chunks.append(list(t)))
    scores = lvu.engine.score_continuations(inputs, list(PP_SCORE_OPTIONS))
    return dict(sampled=sampled.tokens.tolist(), chunks=chunks,
                scores=[[float(t), bool(g)] for t, g in scores])


def reference_record(lvu, inputs, resident, peak):
    """What phases 3i and 3j hold a mesh run of `inputs` against: one
    rank's warm generate of it (tokens, lengths, wall, decode ms/token),
    its resident and peak GiB, and the final-prefill logits and retained
    sets of a fresh prefill."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lvu.engine.generate(inputs, max_new_tokens=8,
                              eos_token_ids=[lvu.tokenizer.eos_token_id])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache, st = lvu.engine.prefill(inputs)
    logits = lvu.engine.final_prefill(cache, st).float().cpu()
    n_dec = len(res.tokens) - 1
    return dict(
        tokens=res.tokens.tolist(), logits=logits,
        layer_lengths=res.layer_lengths, cache_length=res.cache_length,
        kv_cache_bytes=res.kv_cache_bytes,
        retained=[[None if i is None else i.tolist() for i in g]
                  for g in st["retained"]],
        wall=wall, resident_gib=resident, peak_gib=peak,
        decode_ms=(1e3 * res.timings["decode"] / n_dec if n_dec else 0.0),
    )

QUESTIONS = (
    "What happens in this video?",
    "Which objects move from left to right, and when?",
    "Describe the scene at the end of the clip.",
)


def run_main_path(dev, param_dtype="bfloat16", kv_cache_dtype="auto"):
    """Three 7B requests; returns (lvu, ok, launch counts, final-prefill
    logits of request 0 on the host). B1 must run the variant of the cache
    the request resolves to ("auto" -> bf16 here) and no other."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.model import layout_for
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves

    tag = "int8" if param_dtype == "int8" else "bf16"
    variant = {"int8": "int8", "int8k": "int8k"}.get(kv_cache_dtype, "bf16")
    if variant != "bf16":
        tag += f" weights, {variant} KV"
    # an earlier phase's LVU can linger in a reference cycle until the
    # collector runs; what remains is held (the reference records this
    # LVU's own memory above it)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    lvu = make_lvu(dev, param_dtype, kv_cache_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tensor_leaves(lvu.params))
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"[{tag}] 7B init on the card: {time.perf_counter() - t0:.2f} s, "
        f"{n_params / 1e9:.3f} B parameter values, {resident:.2f} GiB "
        f"({base:.2f} GiB held before it)")
    mcfg = lvu.model_config
    requests = [
        make_request(mcfg, lvu.tokenizer, q, seed=i)
        for i, q in enumerate(QUESTIONS)
    ]
    layout = layout_for(mcfg, tuple(requests[0].group_grids[0]))
    n_buckets = len(layout.buckets) or 1
    n_full = len(mcfg.vision.fullatt_block_indexes)
    b2_per_group = (mcfg.vision.depth - n_full) * n_buckets + n_full
    n_layers = mcfg.text.num_hidden_layers

    counters = _kernel_counters()
    _reset_counters(counters)
    results = []
    for i, inputs in enumerate(requests):
        # the last request synchronizes at span edges: its spans partition
        # device time (the first two measure e2e with full overlap)
        os.environ["QV_SYNC_SPANS"] = "1" if i == len(requests) - 1 else "0"
        t0 = time.perf_counter()
        res = lvu.engine.generate(
            inputs, max_new_tokens=8,
            eos_token_ids=[lvu.tokenizer.eos_token_id],
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append((inputs, res, wall))
    os.environ.pop("QV_SYNC_SPANS", None)
    counts = _read_counters(counters)

    ok = True
    exp = dict.fromkeys(counts, 0)
    for i, (inputs, res, wall) in enumerate(results):
        n_groups = len(inputs.group_grids)
        exp["flash"] += (n_groups + 1 + len(res.tokens) - 1) * n_layers
        exp["vision_2d"] += n_groups * b2_per_group
        exp["rotary"] += expected_vision(mcfg, inputs.group_grids)[2]
        if param_dtype == "int8":
            exp["ln_gemm"] += n_groups * mcfg.vision.depth
            exp["ln_mlp"] += n_groups * mcfg.vision.depth
        want_len = expected_lengths(lvu, inputs, len(res.tokens))[0]
        exp[f"flash_{variant}"] = exp[f"flash_{variant}_unified"] = exp["flash"]
        for k, n in expected_kernels(lvu, inputs, len(res.tokens),
                                     variant).items():
            exp[k] += n
        lens_ok = (
            res.cache_length == want_len
            and all(l == want_len for l in res.layer_lengths)
        )
        toks_ok = bool(
            len(res.tokens) >= 1
            and ((res.tokens >= 0) & (res.tokens < mcfg.text.vocab_size)).all()
        )
        ok &= lens_ok and toks_ok
        spans = {k: round(v, 4) for k, v in sorted(res.timings.items())}
        n_dec = len(res.tokens) - 1
        per_tok = (f"{1e3 * res.timings['decode'] / n_dec:.2f} ms/token"
                   if n_dec > 0 else "n/a")
        log(f"[{tag}] request {i} ("
            f"{'sync spans' if i == len(results) - 1 else 'async'}"
            f"): prefill_tokens={res.prefill_tokens} tokens={res.tokens.tolist()} "
            f"cache_length={res.cache_length} (expected {want_len}, layers "
            f"{sorted(set(res.layer_lengths))}) kv_fraction="
            f"{res.kv_memory_fraction:.3f} kv_cache_bytes={res.kv_cache_bytes} "
            f"wall={wall:.3f} s decode "
            f"{per_tok} spans(s)={spans} "
            f"{'OK' if lens_ok and toks_ok else 'FAIL'}")
    counts_ok = (counts == exp and counts["flash"] > 0
                 and counts["vision_2d"] > 0)
    ok &= counts_ok
    log(f"[{tag}] main-path launches: "
        + ", ".join(f"{k} {counts[k]} (expected {exp[k]})" for k in counts)
        + f" {'OK' if counts_ok else 'FAIL'}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak device memory: {peak:.2f} GiB")
    ref = reference_record(lvu, requests[0], resident - base, peak - base)
    if (param_dtype, kv_cache_dtype) == ("bfloat16", "auto"):
        ref.update(pp_extras(lvu, requests[0]))
    MAIN_PATH_REFERENCE[(param_dtype, kv_cache_dtype)] = ref
    cache, state = lvu.engine.prefill(requests[0])
    want_mode = {"bf16": False, "int8": True, "int8k": "k"}[variant]
    cache_ok = cache.quantized == want_mode
    ok &= cache_ok
    log(f"[{tag}] cache: kv_dtype={state['kv_dtype']} K {cache.k.dtype} "
        f"V {cache.v.dtype} capacity {cache.capacity} scales "
        f"{'K+V' if want_mode is True else 'K' if want_mode else 'none'} "
        f"{'OK' if cache_ok else 'FAIL'}")
    logits = lvu.engine.final_prefill(cache, state).float().cpu()
    del cache, state
    return lvu, ok, counts, logits


def run_auto_hour_capacity(dev):
    """The JAX bench's 7B setting (int8 weights, kv_cache_dtype="auto") at
    hour-scale capacity (131,072 slots): "auto" must resolve to int8, the
    cache must hold int8 K and V with f32 scales, and one request must run
    through B1's int8 variant only. Returns (ok, launch counts)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    lvu = make_lvu(dev, "int8", "auto", kv_cache_capacity=131072)
    eng = lvu.engine
    inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                          seed=0)
    counters = _kernel_counters()
    _reset_counters(counters)
    t0 = time.perf_counter()
    res = eng.generate(inputs, max_new_tokens=8,
                       eos_token_ids=[lvu.tokenizer.eos_token_id])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters(counters)
    n_layers = lvu.model_config.text.num_hidden_layers
    want = (len(inputs.group_grids) + len(res.tokens)) * n_layers
    want_len = expected_lengths(lvu, inputs, len(res.tokens))[0]
    counts_ok = (counts["flash_int8"] == want == counts["flash"]
                 and counts["flash_bf16"] == counts["flash_int8k"] == 0)
    len_ok = res.cache_length == want_len
    cache, state = eng.prefill(inputs)
    t = lvu.model_config.text
    scales = (t.num_hidden_layers, t.num_key_value_heads, 131072)
    cache_ok = (
        state["kv_dtype"] == "int8" and cache.capacity == 131072
        and cache.k.dtype == cache.v.dtype == torch.int8
        and all(sc is not None and sc.dtype == torch.float32
                and tuple(sc.shape) == scales
                for sc in (cache.k_scale, cache.v_scale))
    )
    del cache, state
    ok = counts_ok and len_ok and cache_ok
    log(f"[int8 weights, auto KV, capacity 131072] resolved "
        f"{eng.resolve_kv_dtype(131072)} (card memory "
        f"{eng.device_memory_bytes() / 2**30:.2f} GiB); cache int8 K/V with "
        f"f32 scales {'OK' if cache_ok else 'FAIL'}; tokens="
        f"{res.tokens.tolist()} cache_length={res.cache_length} (expected "
        f"{want_len}) kv_cache_bytes={res.kv_cache_bytes} wall={wall:.3f} s; "
        f"B1 launches int8 {counts['flash_int8']} (expected {want}), bf16 "
        f"{counts['flash_bf16']}, int8k {counts['flash_int8k']} "
        f"{'OK' if counts_ok and len_ok else 'FAIL'}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del lvu, eng
    torch.cuda.empty_cache()
    return ok, counts


# phase 3d: the pruning predictors and modes, one request each
MODE_REQUESTS = (
    ("salient_tokens, bf16 KV", dict(top_k_predict_type="salient_tokens")),
    ("salient_tokens, int8 KV", dict(top_k_predict_type="salient_tokens",
                                     kv_cache_dtype="int8")),
    ("query_attention_weights, query-based",
     dict(top_k_predict_type="query_attention_weights", query_based=True)),
    ("key_norms_small, linear decay, cascade from layer 14",
     dict(top_k_decay_type="linear", prefill_prune_starting_layer=14)),
    # the int8 and int8k variants of the new B1 modes
    ("query-based, int8 KV, exponential decay",
     dict(top_k_predict_type="query_attention_weights", query_based=True,
          kv_cache_dtype="int8", top_k_decay_type="exponential",
          top_k_decay_factor=0.9)),
    ("query-based, int8k KV, do_top_k_for_query",
     dict(top_k_predict_type="query_attention_weights", query_based=True,
          kv_cache_dtype="int8k", do_top_k_for_query=True)),
)


def run_modes(dev, params):
    """Phase 3d: one 7B request per entry of MODE_REQUESTS on the bf16
    weights `params`. Each must launch B1 in the modes its predictor needs
    (expected_b1) and end with the cache lengths the config's rules give
    per layer (expected_lengths). Returns (ok, each request's launch
    counts)."""
    import torch

    counters = _kernel_counters()
    ok, runs = True, []
    for i, (what, kw) in enumerate(MODE_REQUESTS):
        kw = dict(kw)
        lvu = make_lvu(dev, "bfloat16", kw.pop("kv_cache_dtype", "auto"),
                       params=params, **kw)
        inputs = make_request(lvu.model_config, lvu.tokenizer,
                              QUESTIONS[i % len(QUESTIONS)], seed=i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters(counters)
        t0 = time.perf_counter()
        res = lvu.engine.generate(inputs, max_new_tokens=8,
                                  eos_token_ids=[lvu.tokenizer.eos_token_id])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counters(counters)
        runs.append(counts)
        want_len, want_layers = expected_lengths(lvu, inputs, len(res.tokens))
        variant = {"int8": "int8", "int8k": "int8k"}.get(
            lvu.config.kv_cache_dtype, "bf16")
        want = expected_b1(lvu, inputs, len(res.tokens), variant)
        b1 = {f"flash_{v}_{m}": counts[f"flash_{v}_{m}"]
              for v in B1_VARIANTS for m in B1_MODES}
        want_k = expected_kernels(lvu, inputs, len(res.tokens), variant)
        kern = {k: counts[k] for k in want_k}
        counts_ok = (b1 == {k: want.get(k, 0) for k in b1}
                     and kern == want_k
                     and counts["flash"] == sum(want.values())
                     and counts["vision_2d"] > 0)
        lens_ok = (res.cache_length == want_len
                   and res.layer_lengths == want_layers)
        toks_ok = bool(len(res.tokens) >= 1 and (
            (res.tokens >= 0) & (res.tokens < lvu.model_config.text.vocab_size)
        ).all())
        ok &= counts_ok and lens_ok and toks_ok
        spans = {k: round(v, 4) for k, v in sorted(res.timings.items())}
        log(f"[3d {what}] tokens={res.tokens.tolist()} cache_length="
            f"{res.cache_length} (expected {want_len}), layer lengths "
            f"{res.layer_lengths[0]}..{res.layer_lengths[-1]} "
            f"{'as' if res.layer_lengths == want_layers else 'NOT as'} "
            f"expected per layer; B1 launches "
            + ", ".join(f"{k[6:]} {n}" for k, n in b1.items() if n)
            + f" (expected {', '.join(f'{k[6:]} {n}' for k, n in want.items())}); "
            f"kernels " + ", ".join(f"{k[13:]} {n}" for k, n in kern.items())
            + f" (expected "
            + ", ".join(f"{k[13:]} {n}" for k, n in want_k.items()) + "); "
            f"wall={wall:.3f} s spans(s)={spans} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"{'OK' if counts_ok and lens_ok and toks_ok else 'FAIL'}")
        del lvu
        torch.cuda.empty_cache()
    return ok, runs


@contextlib.contextmanager
def vision_route(value):
    """QV_VISION_2D set to `value` (None: unset, the default route choice)
    for the block, restored after it."""
    old = os.environ.get("QV_VISION_2D")
    if value is None:
        os.environ.pop("QV_VISION_2D", None)
    else:
        os.environ["QV_VISION_2D"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QV_VISION_2D", None)
        else:
            os.environ["QV_VISION_2D"] = old


def expected_vision(cfg, grids, forced_head_major=False):
    """(B2, B5, rotary pass) launches of a tower over `grids`, by the JAX
    package's route rule (vision.py:373-388, with its tiling rule as the
    port copies it): a block takes B2 when every span it needs tiles, else
    B5, once per window-size bucket (window blocks) or once (full-attention
    blocks). The rotary pass runs once per head-major block and once per
    B2 call on a span above SHORT_SPAN."""
    from quickvideo_tpu_torch.models.qwen25_vl.model import layout_for
    from quickvideo_tpu_torch.ops.vision_attention import (
        SHORT_SPAN,
        kernel_applicable,
    )

    b2 = b5 = rot = 0
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_win = cfg.vision.depth - n_full
    for grid in grids:
        lay = layout_for(cfg, tuple(grid))
        s_len = lay.seq_len
        win = ([(b - a, span) for span, a, b in lay.buckets] if lay.buckets
               else [(s_len, lay.mw)])
        for blocks, spans in ((n_win, win), (n_full, [(s_len, lay.frame_len)])):
            tiles = not forced_head_major and all(
                kernel_applicable(n, span) for n, span in spans)
            if tiles:
                b2 += blocks * len(spans)
                rot += blocks * sum(span > SHORT_SPAN for _, span in spans)
            else:
                b5 += blocks * len(spans)
                rot += blocks
    return b2, b5, rot


def _request_line(counts_ok, tag, res, counts, wall, want_len, extra=""):
    """One phase-3e request's line: tokens, cache lengths against the
    config's rules, launches (`counts_ok`: as expected), wall, spans, peak
    memory; returns whether all hold."""
    import torch

    lens_ok = (res.cache_length == want_len
               and res.layer_lengths == [want_len] * len(res.layer_lengths))
    toks_ok = len(res.tokens) >= 1
    spans = {k: round(v, 4) for k, v in sorted(res.timings.items())}
    log(f"[3e {tag}] prefill_tokens={res.prefill_tokens} tokens="
        f"{res.tokens.tolist()} cache_length={res.cache_length} (expected "
        f"{want_len}, layers {sorted(set(res.layer_lengths))}); launches "
        f"B1 {counts['flash']}, B2 {counts['vision_2d']}, B3 "
        f"{counts['ln_gemm']}, B4 {counts['ln_mlp']}, B5 {counts['vision_hm']}"
        f", rotary pass {counts['rotary']}{extra}; wall={wall:.3f} s spans(s)={spans} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"{'OK' if counts_ok and lens_ok and toks_ok else 'FAIL'}")
    return counts_ok and lens_ok and toks_ok


def run_head_major(dev, params, logits_bf16):
    """Phase 3e: the head-major vision route (kernel B5) on the 7B at full
    width and depth. (1) the 64-frame request under QV_VISION_2D=0 with the
    bf16 weights `params` and with int8 weights (the engine skips the B4
    prep there, so the MLP runs the unfused int8 chain): B2, B3, B4 launch 0
    times; (2) 66 frames under the default route choice, whose last group
    (2 frames, t = 1) takes B5; (3) an image alone through LVU.chat; (4) an
    image before the 64-frame video. Returns (ok, each run's launch
    counts)."""
    import torch

    counters = _kernel_counters()
    ok, runs = True, []

    def request(lvu, inputs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters(counters)
        t0 = time.perf_counter()
        res = lvu.engine.generate(inputs, max_new_tokens=8,
                                  eos_token_ids=[lvu.tokenizer.eos_token_id])
        torch.cuda.synchronize()
        return res, _read_counters(counters), time.perf_counter() - t0

    for param_dtype in ("bfloat16", "int8"):
        with vision_route("0"):
            lvu = make_lvu(dev, param_dtype,
                           params=params if param_dtype == "bfloat16" else None)
            mcfg = lvu.model_config
            inputs = make_request(mcfg, lvu.tokenizer, QUESTIONS[0], seed=0)
            res, counts, wall = request(lvu, inputs)
            _, b5, rot = expected_vision(mcfg, inputs.group_grids, True)
            want_len = expected_lengths(lvu, inputs, len(res.tokens))[0]
            counts_ok = (counts["vision_hm"] == b5 and counts["vision_2d"] == 0
                         and counts["rotary"] == rot
                         and counts["ln_gemm"] == counts["ln_mlp"] == 0)
            ok &= _request_line(counts_ok,
                f"QV_VISION_2D=0, {param_dtype} weights", res, counts, wall,
                want_len, f" (expected B5 {b5}, rotary {rot}, B2/B3/B4 0)")
            runs.append(counts)
            if param_dtype == "bfloat16":
                cache, state = lvu.engine.prefill(inputs)
                lg = lvu.engine.final_prefill(cache, state).float().cpu()
                del cache, state
                rel = ((lg - logits_bf16).norm() / logits_bf16.norm()).item()
                log(f"[3e] 7B final-prefill logits, QV_VISION_2D=0 vs the "
                    f"default route (phase 3, bf16, same inputs): rel L2 "
                    f"{rel:.3e} (printed, not asserted); argmax "
                    f"{int(lg.argmax())} vs {int(logits_bf16.argmax())}")
            del lvu
            torch.cuda.empty_cache()

    with vision_route(None):
        lvu = make_lvu(dev, "bfloat16", params=params)
        mcfg = lvu.model_config
        for what, inputs in (
            ("66 frames, default route", make_request(
                mcfg, lvu.tokenizer, QUESTIONS[1], seed=1, n_frames=66)),
            ("image before the 64-frame video", make_request(
                mcfg, lvu.tokenizer, QUESTIONS[2], seed=2,
                image=seeded_image(1))),
        ):
            res, counts, wall = request(lvu, inputs)
            grids = list(inputs.group_grids) + [
                tuple(g) for g in (inputs.image_grid_thw
                                   if inputs.image_grid_thw is not None
                                   else [])]
            b2, b5, rot = expected_vision(mcfg, grids)
            want_len = expected_lengths(lvu, inputs, len(res.tokens))[0]
            counts_ok = (counts["vision_2d"], counts["vision_hm"],
                         counts["rotary"]) == (b2, b5, rot)
            ok &= _request_line(counts_ok,
                what, res, counts, wall, want_len,
                f" (expected B2 {b2}, B5 {b5}, rotary {rot}; group grids "
                f"{[tuple(g) for g in inputs.group_grids]})")
            runs.append(counts)

        # an image alone, through the chat entry point
        image = seeded_image(0)
        messages = [{"role": "user", "content": [
            {"type": "image", "image": image},
            {"type": "text", "text": "What is in this photo?"},
        ]}]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters(counters)
        t0 = time.perf_counter()
        text = lvu.chat(messages, max_new_tokens=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counters(counters)
        res = lvu.last_result
        ps = mcfg.vision.patch_size
        grid = (1, IMAGE_HW[0] // ps, IMAGE_HW[1] // ps)
        b2, b5, rot = expected_vision(mcfg, [grid])
        want_len = res.prefill_tokens + len(res.tokens) - 1
        counts_ok = ((counts["vision_2d"], counts["vision_hm"],
                      counts["rotary"]) == (b2, b5, rot)
                     and isinstance(text, list))
        ok &= _request_line(counts_ok,
            f"image alone via LVU.chat, {IMAGE_HW[0]}x{IMAGE_HW[1]}", res,
            counts, wall, want_len,
            f" (expected B2 {b2}, B5 {b5}, rotary {rot}; grid {grid})")
        runs.append(counts)
        del lvu
        torch.cuda.empty_cache()
    return ok, runs


def run_video_file(lvu):
    """LVU.generate(question, video_path) through the CPU decoder, where its
    library is built (it needs FFmpeg)."""
    from quickvideo_tpu_torch.video import quickdecode as qd

    if not qd.is_available():
        log("video-file phase: not run (libquickdecode.so is not built on "
            "this machine; it needs FFmpeg). It exercises the CPU decoder "
            "shared with the JAX package, not the port.")
        return True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.mp4")
        qd.encode_textured_video(
            path, width=448, height=448, nframes=REQUEST_FRAMES, fps=24, gop=48
        )
        t0 = time.perf_counter()
        text = lvu.generate("What happens in this video?", path,
                            max_new_tokens=4)
        res = lvu.last_result
        log(f"video-file phase: {len(res.tokens)} tokens, "
            f"{time.perf_counter() - t0:.3f} s, spans(s)="
            f"{ {k: round(v, 4) for k, v in sorted(res.timings.items())} }")
        return isinstance(text, list) and len(res.tokens) >= 1


# -- --profile: where the time goes -------------------------------------------

# kernel name fragment -> kind, first match wins
KERNEL_KINDS = (
    ("flash_prefill_kernel<0", "B1 flash prefill, bf16 (wgmma)"),
    ("flash_prefill_kernel", "B1 flash prefill, int8-QK (wgmma)"),
    ("flash_decode_kernel", "B1 flash decode"),
    ("flash_merge_kernel", "B1 split-K merge"),
    ("short_span_kernel<true", "B2 short-span (rotary inside)"),
    ("short_span_kernel<false", "B5 short-span (head-major)"),
    ("long_span_kernel", "B2/B5 long-span (wgmma)"),
    ("vision_rotary_kernel", "vision rotary pass"),
    ("gemm_bias_kernel", "B3 GEMM (wgmma, TMA ring)"),
    ("gemm_silu_quant_kernel", "B4/B6 GEMM + requantize (wgmma, cluster)"),
    ("ln_quantize", "B3/B4 prologue"),
    ("gemm_s8", "int8 GEMM (_int_mm)"),
    ("imma", "int8 GEMM (_int_mm)"),
    ("gemm", "bf16/f32 GEMM"),
    ("nvjet", "bf16/f32 GEMM"),
    ("copy", "copies/casts"),
    ("Memcpy", "copies/casts"),
    ("Memset", "copies/casts"),
)


def _kind(name: str) -> str:
    for frag, kind in KERNEL_KINDS:
        if frag in name:
            return kind
    return "other elementwise/reductions"


def run_profile(dev, param_dtype, kv_cache_dtype="auto", route=None,
                **pruning):
    """One warm 7B request (request 0 of the main path, or with the
    predictor `pruning` sets, on the vision route QV_VISION_2D=`route`)
    under torch.profiler: wall time, the sum of kernel times, the busy
    share (the union of kernel intervals over the wall time), the spans,
    kernel time by kind and the top kernels."""
    with vision_route(route):
        _run_profile(dev, param_dtype, kv_cache_dtype, route, **pruning)


def _run_profile(dev, param_dtype, kv_cache_dtype, route, **pruning):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lvu = make_lvu(dev, param_dtype, kv_cache_dtype, **pruning)
    inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                          seed=0)

    def request():
        return lvu.engine.generate(
            inputs, max_new_tokens=8,
            eos_token_ids=[lvu.tokenizer.eos_token_id],
        )

    request()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = request()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        # kernels only: not the device-side copies of the engine's spans
        # (SpanTimer's annotate ranges, which cover their kernels' gaps)
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + end - start)
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    total = sum(us for _, us in by_name.values())
    by_kind = {}
    for name, (_, us) in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + us
    log(f"== {param_dtype} weights, {kv_cache_dtype} KV, "
        f"{lvu.config.top_k_predict_type}"
        f"{'' if route is None else f', QV_VISION_2D={route}'}: wall "
        f"{wall:.4f} s "
        f"under the profiler, kernels "
        f"{total / 1e6:.4f} s, busy {busy / 1e6:.4f} s, busy share "
        f"{busy / 1e6 / wall:.3f}, {len(res.tokens)} tokens, spans(s)="
        f"{ {k: round(v, 4) for k, v in sorted(res.timings.items())} }")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3:10.2f} ms  {kind}")
    log("  top kernels:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, us) in top:
        log(f"  {us / 1e3:10.2f} ms  n={n:6d}  {name[:100]}")
    del lvu
    torch.cuda.empty_cache()


# -- --compare-b1: B1's device times at the main path's shapes --------------

# (variant, causal, with_lse, G, length, cap): decode over 4,000, 57,344 and
# 122,880 slots; 20 rows over a past (pure past + lse: the query-based
# group 0's shape); the 64-frame group step in every mode; the headline's
# last step; the bf16 prefill kernel at both steps for reference
B1_COMPARE_SHAPES = tuple(
    [(v, True, False, 1, n, cap) for v in ("bf16", "int8", "int8k")
     for n, cap in ((4000, 8192), (57344, 65536), (122880, 131072))]
    + [(v, False, True, 20, 1807, 4096) for v in ("bf16", "int8", "int8k")]
    + [(v, c, lse, g, n, cap) for v in ("int8", "int8k")
       for c, lse, g, n, cap in (
           (True, False, 3600, 1807, 16384), (True, True, 3600, 1807, 16384),
           (False, True, 3620, 1807, 16384), (True, False, 3600, 53744, 65536),
           (False, False, 3600, 53744, 65536),
           (True, True, 3600, 53744, 65536),
           (False, True, 3600, 53744, 65536))]
    + [("bf16", True, False, 3600, 1807, 16384),
       ("bf16", True, False, 3600, 53744, 65536),
       ("bf16", False, False, 3600, 53744, 65536),
       # the lse modes, beside memory-efficient SDPA with its lse
       ("bf16", True, True, 3600, 1807, 16384),
       ("bf16", False, True, 3620, 1807, 16384)]
)


def compare_b1(dev, tree):
    """Each B1_COMPARE_SHAPES entry through flash_past_attention of the
    package imported from `tree` (this checkout, or an older one): the B1
    kernels' device time per call (torch.profiler, 10 calls after a
    warm-up; the q quantize of the int8 caches runs outside them and is
    not counted), the bound and its share, the error against the plain
    version; at decode also SDPA's device time; where the call splits its
    key range, the split-K merge's part. Returns whether every output
    agreed."""
    import torch

    from quickvideo_tpu_torch.ops import flash_attention as fa
    from quickvideo_tpu_torch.ops.attention import (
        cache_attention,
        cache_attention_int8,
        quantize_q,
    )
    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    scale = 128 ** -0.5
    ok = True
    for variant, causal, lse, g, length, cap in B1_COMPARE_SHAPES:
        k = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)
        out_dtype = torch.bfloat16 if causal else torch.float32
        mode = dict(causal=causal, with_lse=lse, out_dtype=out_dtype)
        kw, kl, vl = {}, k, v
        if variant != "bf16":
            cache = init_cache(1, 4, cap, 128, device=dev,
                               quantized=True if variant == "int8" else "k")
            stacked_append(cache, 0, 0, k, v)
            kl, vl = cache.k[0], cache.v[0]
            kw = dict(k_scale=cache.k_scale[0], v_scale=(
                None if cache.v_scale is None else cache.v_scale[0]))

        def run():
            return fa.flash_past_attention(q, kl, vl, length, scale, **kw,
                                           **mode)

        if kw:
            q8, qs = quantize_q(q, scale)
            ref, ref_lse = cache_attention_int8(
                q8, qs, kl, kw["k_scale"], vl, kw["v_scale"], length,
                torch.bfloat16, **mode)
        else:
            ref, ref_lse = cache_attention(q, kl, vl, length, scale, **mode)
        out, out_lse = run()
        err, within = _compare(out, ref)
        if lse:
            err = max(err, (out_lse - ref_lse).abs().max().item())
            within &= bool((out_lse - ref_lse).abs().max() <= LSE_ATOL)
        ok &= within
        del ref, ref_lse
        ms = _device_ms(run, B1_NAMES, 10)
        plan = fa._plan(g, 28, 4, length, cap, causal, sms, variant)
        bound_ms, bound_by = flash_bound(g, length, variant, causal,
                                         out_dtype.itemsize, with_lse=lse)
        extra = ""
        if g == 1 and variant == "bf16":
            sdpa = sdpa_ms(q, k, v, length, device=True, reps=10)
            extra += f"; SDPA device {sdpa:.4f} ms (kernel x{ms / sdpa:.2f})"
        if plan.n_split > 1:  # the split-K merge's share
            merge = _device_ms(run, ("flash_merge",), 10)
            extra += f"; split-K merge {merge:.4f} ms of it"
        if lse and variant == "bf16":
            lib_ms = sdpa_lse_ms(q, k, v, length, causal, reps=10)[0]
            if lib_ms is not None:
                extra += (f"; memory-efficient SDPA with lse {lib_ms:.4f} ms"
                          " (CUDA events)")
        mname = ("unified" if causal else "past") + ("+lse" if lse else "")
        log(f"B1 compare [{tree}] {variant} {mname} G={g} length={length} "
            f"cap={cap} (plan {plan.kernel}, split {plan.n_split}): device "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.1f}% of it{extra}; max_abs_err {err:.3e} "
            f"{'OK' if within else 'FAIL'}")
        del k, v, q, kl, vl, kw
        if variant != "bf16":
            del cache
        torch.cuda.empty_cache()
    return ok


# -- phase 3f: sessions, scoring, sampling, batching, checkpoints -----------


class SeededReader:
    """The native interleaved reader's surface (video/quickdecode.py, and
    VideoReader.get_batch) over seeded noise, so the entry points that open
    a video path run without a decoder: 2 * REQUEST_FRAMES source frames of
    SOURCE_HW at 2 fps; frames come out at the size the plan asked for, or
    at the source size where none was set (the on-device resize), packed
    yuv420 or RGB, each drawn from (path, frame index). `frames_read`
    counts the frames drawn over all readers, `drawn_hw` is the size of
    the last ones."""

    SOURCE_HW = (FRAME_HW, FRAME_HW)
    frames_read = 0
    drawn_hw = None

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.seed = sum(path.encode())
        self.source_height, self.source_width = self.SOURCE_HW
        self.height = self.width = self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self._pos = 0

    def __len__(self):
        return 2 * REQUEST_FRAMES

    def get_fps(self):
        return 2.0

    def process(self, indices):
        h = self.height or self.source_height
        w = self.width or self.source_width
        shape = ((h * w * 3 // 2,) if self.output_format == "YUV420"
                 else (3, h, w))
        self._frames = np.stack([
            np.random.default_rng((self.seed, i)).integers(
                0, 256, shape, dtype=np.uint8)
            for i in indices
        ])
        SeededReader.frames_read += len(indices)
        SeededReader.drawn_hw = (h, w)
        self._pos = 0

    def get_batch(self, indices):
        self.process(indices)
        return self._frames

    def __next__(self):
        block = self._frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        if not len(block):
            raise StopIteration
        return block

    def close(self):
        pass


@contextlib.contextmanager
def seeded_videos(source_hw=(FRAME_HW, FRAME_HW)):
    """The streaming reader replaced by the seeded one, and the seeded
    reader forced on the registry (which the whole-video decoder and the
    disk frame cache open), with sources of `source_hw`, for the block (as
    tests/test_torch_engine.py replaces them), restored after it."""
    from quickvideo_tpu_torch.video import quickdecode as qd
    from quickvideo_tpu_torch.video import reader as vreader

    saved = (qd.InterleavedVideoReader, SeededReader.SOURCE_HW,
             os.environ.get("FORCE_QWENVL_VIDEO_READER"))
    qd.InterleavedVideoReader = SeededReader
    SeededReader.SOURCE_HW = tuple(source_hw)
    vreader.register_backend("seeded", lambda p, threads: SeededReader(p))
    os.environ["FORCE_QWENVL_VIDEO_READER"] = "seeded"
    try:
        yield
    finally:
        qd.InterleavedVideoReader, SeededReader.SOURCE_HW, forced = saved
        vreader._BACKENDS.pop("seeded", None)
        if forced is None:
            os.environ.pop("FORCE_QWENVL_VIDEO_READER", None)
        else:
            os.environ["FORCE_QWENVL_VIDEO_READER"] = forced


SESSION_QUESTIONS = (
    "What happens in this video?",
    "Why?",  # a 26-row follow-up suffix: 182 packed rows, the decode kernel
    "Describe the colors in the frames.",  # 56 rows: the prefill kernel
    "And then?",  # 31 rows (217 packed): the prefill kernel
)
# scored options: 2, 7 and 15 tokens (the fallback tokenizer is byte-level)
# and 12 token ids; with the 20-row suffix the passes run 22-35 rows, on
# both sides of B1's 192 packed rows
SCORE_CONTEXT = "Which?"
SCORE_OPTIONS = (" A", " B. red", " C. moving left", list(range(300, 312)))
SCORE_ATOL = 1e-3  # one option's total, shared prefill vs its own
BATCH_QUESTIONS = QUESTIONS + ("Is anything red?",)


def _path_lvu(dev, params, **kw):
    """The 7B LVU of phase 3f on the bf16 weights `params`: seeded videos
    at the 30 x 30 grid of phase 3 (the pixel budget raised to 420 x 420),
    groups of 32 frames."""
    return make_lvu(dev, "bfloat16", params=params,
                    extra_kwargs={"max_pixels": FRAME_HW * FRAME_HW}, **kw)


class _Run:
    """Counters reset before a call, read after it; wall and peak memory."""

    def __init__(self, counters):
        self.counters = counters

    def __call__(self, fn, *args, **kw):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters(self.counters)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - t0
        self.peak = torch.cuda.max_memory_allocated() / 2**30
        self.counts = _read_counters(self.counters)
        return out


def _b1_ok(counts, want):
    """B1's per-kernel launches equal `want`, and all ran as bf16 unified
    (the mode of every launch on these paths)."""
    total = sum(want.values())
    return ({k: counts[k] for k in want} == want and counts["flash"] == total
            and counts["flash_bf16_unified"] == total)


def _kern(d):
    return ", ".join(f"{k[13:]} {n}" for k, n in d.items())


def run_session(dev, params, run, runs):
    """A first ask, two follow-ups, save, resume, a third follow-up on the
    resumed and on the live session (equal tokens); the first follow-up's
    final-prefill logits against a from-scratch request over the whole
    history. B1 launches per turn by the rows each launch runs."""
    import torch

    from quickvideo_tpu_torch.video import reader as vreader
    from quickvideo_tpu_torch.video.reader import (
        build_prefill_inputs_from_frames,
    )

    lvu = _path_lvu(dev, params)
    eng = lvu.engine
    n = lvu.model_config.text.num_hidden_layers
    ok = True
    session = lvu.start_chat("seeded-session.mp4")
    frames, plan, _ = vreader.decode_video_batch("seeded-session.mp4",
                                                 lvu.config)
    logits = []
    final_prefill = eng.final_prefill

    def capture(*a, **k):
        logits.append(final_prefill(*a, **k))
        return logits[-1]

    walls, history_end = [], []
    for i, q in enumerate(SESSION_QUESTIONS[:3]):
        before = 0 if session._ids is None else len(session._ids)
        eng.final_prefill = capture
        try:
            answer = run(session.ask, q, max_new_tokens=8)
        finally:
            eng.final_prefill = final_prefill
        runs.append(run.counts)
        history_end.append(len(session._ids))
        toks = session.turns[-1]["tokens"]
        n_dec = len(toks) - 1
        if i == 0:
            ids1 = session._ids[: len(session._ids) - n_dec]
            want = expected_kernels(lvu, SimpleNamespace(
                input_ids=ids1, group_grids=plan.group_grids), len(toks),
                "bf16")
        else:
            g = len(session._ids) - n_dec - before
            want = b1_kernels(lvu, [g] * n + [1] * (n_dec * n))
        vision = run.counts["vision_2d"]
        this_ok = (_b1_ok(run.counts, want) and (vision > 0) == (i == 0)
                   and session._cache_len == max(session._cache.lengths))
        ok &= this_ok
        walls.append(run.wall)
        spans = {k: round(v, 4) for k, v in
                 sorted(session.turns[-1]["timings"].items())}
        log(f"[3f session] turn {i + 1} ({'first ask, video prefill' if i == 0 else f'follow-up, {g}-row suffix'}): "
            f"tokens={toks} cache_len={session._cache_len} (layers "
            f"{sorted(set(session._cache.lengths))}) capacity "
            f"{session._cache.capacity}; B1 kernels {_kern({k: run.counts[k] for k in want})} "
            f"(expected {_kern(want)}); B2 {vision}; wall={run.wall:.4f} s "
            f"spans(s)={spans} peak {run.peak:.2f} GiB "
            f"{'OK' if this_ok else 'FAIL'}")

    # the first follow-up against the whole history from scratch: the ids
    # the session held once it ran, less its answer
    t1 = session.turns[1]["tokens"]
    hist = session._ids[: history_end[1] - (len(t1) - 1)]
    cache, state = eng.prefill(build_prefill_inputs_from_frames(frames, plan,
                                                                hist))
    full = eng.final_prefill(cache, state).float().cpu()
    del cache, state
    inc = logits[1].float().cpu()
    rel = ((inc - full).norm() / full.norm()).item()
    this_ok = bool(rel <= LOGITS_REL_L2 and torch.isfinite(inc).all())
    ok &= this_ok
    log(f"[3f session] follow-up 1 incremental vs the whole history from "
        f"scratch ({len(hist)} ids): final-prefill logits rel L2 {rel:.3e} "
        f"(tol {LOGITS_REL_L2}), argmax {int(inc.argmax())} vs "
        f"{int(full.argmax())}, turn tokens {t1} "
        f"{'OK' if this_ok else 'FAIL'}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.npz")
        t0 = time.perf_counter()
        session.save(path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        resumed = lvu.resume_chat(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    q = SESSION_QUESTIONS[3]
    a_res = run(resumed.ask, q, max_new_tokens=8)
    runs.append(run.counts)
    res_wall, res_counts = run.wall, run.counts
    a_live = run(session.ask, q, max_new_tokens=8)
    runs.append(run.counts)
    toks_r, toks_l = (s.turns[-1]["tokens"] for s in (resumed, session))
    same = (toks_r == toks_l and a_res == a_live
            and resumed._cache.lengths == session._cache.lengths
            and res_counts == run.counts)
    ok &= same
    log(f"[3f session] saved {size / 2**20:.1f} MiB in {t_save:.3f} s, "
        f"resumed in {t_load:.3f} s; turn 4 on the resumed session "
        f"{toks_r} ({res_wall:.4f} s) vs the live one {toks_l} "
        f"({run.wall:.4f} s), launches alike "
        f"{'OK' if same else 'FAIL'}")
    log(f"[3f session] walls: turn 1 {walls[0]:.4f} s, turns 2-3 "
        f"{walls[1]:.4f} / {walls[2]:.4f} s, turn 4 {run.wall:.4f} s")
    del lvu, session, resumed
    torch.cuda.empty_cache()
    return ok


def _video_request(lvu, question, video):
    """(input_ids and group grids, suffix rows) of the request
    LVU.generate / LVU.loglikelihood build for `question` on `video`."""
    from quickvideo_tpu_torch.tokenization import build_chat_ids_from_messages
    from quickvideo_tpu_torch.video.reader import plan_from_reader

    plan = plan_from_reader(SeededReader(video), lvu.config)
    ids = build_chat_ids_from_messages(
        lvu.tokenizer, lvu.model_config,
        lvu._context_messages(question, video), sum(plan.tokens_per_group))
    vid = np.nonzero(ids == lvu.model_config.video_token_id)[0]
    inputs = SimpleNamespace(input_ids=ids, group_grids=plan.group_grids)
    return inputs, len(ids) - int(vid[-1]) - 1


def _video_request_rows(lvu, question, video):
    """(per-layer group rows of every group, suffix rows) of the request
    LVU.generate / LVU.loglikelihood build for `question` on `video`."""
    inputs, suffix = _video_request(lvu, question, video)
    groups = [g for per in group_layer_rows(lvu, inputs) for g in per]
    return groups, suffix


def run_scoring(dev, params, run, runs):
    """loglikelihood_multi with 4 options against each option's own
    loglikelihood; the request's greedy answer scored. B1 launches: the
    video groups once, then one pass per option at suffix + option rows."""
    import torch

    lvu = _path_lvu(dev, params)
    video = "seeded-scoring.mp4"
    n = lvu.model_config.text.num_hidden_layers
    multi = run(lvu.loglikelihood_multi, SCORE_CONTEXT, video,
                list(SCORE_OPTIONS))
    runs.append(run.counts)
    multi_wall, multi_counts = run.wall, run.counts
    ok = True
    single, single_wall = [], 0.0
    for opt in SCORE_OPTIONS:
        single.append(run(lvu.loglikelihood, SCORE_CONTEXT, video, opt))
        runs.append(run.counts)
        single_wall += run.wall
    # the expected launches: the request's groups, then one pass per option
    groups, suffix = _video_request_rows(lvu, SCORE_CONTEXT, video)
    conts = [lvu.tokenizer.encode_text(o) if isinstance(o, str) else o
             for o in SCORE_OPTIONS]
    want = b1_kernels(lvu, groups + [suffix + len(c) for c in conts
                                     for _ in range(n)])
    counts_ok = _b1_ok(multi_counts, want)
    ok &= counts_ok
    for (t_m, g_m), (t_s, g_s), c in zip(multi, single, conts):
        this_ok = (abs(t_m - t_s) <= SCORE_ATOL and g_m == g_s
                   and np.isfinite(t_m) and t_m < 0)
        ok &= this_ok
        log(f"[3f scoring] option of {len(c)} tokens (pass of "
            f"{suffix + len(c)} rows): shared {t_m:.5f} (greedy {g_m}) vs "
            f"its own {t_s:.5f} (greedy {g_s}), |diff| {abs(t_m - t_s):.2e} "
            f"(tol {SCORE_ATOL}) {'OK' if this_ok else 'FAIL'}")
    log(f"[3f scoring] 4 options on one shared prefill {multi_wall:.4f} s vs "
        f"4 single calls {single_wall:.4f} s; B1 kernels "
        f"{_kern({k: multi_counts[k] for k in want})} (expected {_kern(want)})"
        f"; peak {run.peak:.2f} GiB {'OK' if counts_ok else 'FAIL'}")
    run(lvu.generate, SCORE_CONTEXT, video, max_new_tokens=8)
    greedy = lvu.last_result.tokens.tolist()
    score = run(lvu.loglikelihood, SCORE_CONTEXT, video, greedy)
    log(f"[3f scoring] the request's own greedy answer {greedy}: total "
        f"{score[0]:.5f}, is_greedy {score[1]} (printed, not asserted)")
    del lvu
    torch.cuda.empty_cache()
    return ok


def run_sampling(dev, params, run, runs):
    """top_k=1 sampling gives the greedy tokens; a repeated seed repeats a
    sample; streamed chunks concatenate to the unstreamed tokens, each at
    most stream_chunk_tokens; decode ms/token greedy against sampled (on the
    device with top_p, which sorts the vocabulary each step, and on the
    host). B1: every decode step on the decode kernel."""
    import torch

    q, video = QUESTIONS[1], "seeded-sampling.mp4"
    n_new = 16
    ok = True
    per_tok, peaks = {}, []

    def request(lvu, **kw):
        """(tokens, decode ms/token, B1 launches as expected)."""
        run(lvu.generate, q, video, max_new_tokens=n_new, **kw)
        runs.append(run.counts)
        peaks.append(run.peak)
        res = lvu.last_result
        n_dec = len(res.tokens) - 1
        n = lvu.model_config.text.num_hidden_layers
        groups, suffix = _video_request_rows(lvu, q, video)
        want = b1_kernels(lvu, groups + [suffix] * n + [1] * (n_dec * n))
        ms = 1e3 * res.timings["decode"] / max(n_dec, 1)
        return res.tokens.tolist(), ms, _b1_ok(run.counts, want)

    lvu = _path_lvu(dev, params, stream_chunk_tokens=4)
    greedy, per_tok["greedy"], c_ok = request(lvu)
    top1, per_tok["sampled top_k 1, on the card"], c1 = request(
        lvu, do_sample=True, top_k=1)
    this_ok = top1 == greedy and c_ok and c1
    ok &= this_ok
    log(f"[3f sampling] greedy {greedy}; top_k=1 sampled {top1}; B1 "
        f"launches as expected {c_ok and c1} {'OK' if this_ok else 'FAIL'}")
    chunks = []
    streamed, _, c2 = request(lvu, on_tokens=chunks.append)
    sizes = [len(c) for c in chunks]
    this_ok = (sum(chunks, []) == streamed == greedy and sizes[0] == 1
               and max(sizes) <= 4 and c2)
    ok &= this_ok
    log(f"[3f sampling] streamed chunks {sizes} (stream_chunk_tokens 4) "
        f"concatenate to the greedy tokens {'OK' if this_ok else 'FAIL'}")
    kw = dict(do_sample=True, top_p=0.9, temperature=1.0)
    draws = []
    counts_ok = True
    for _ in range(2):
        seeded = _path_lvu(dev, params, seed=7)
        toks, ms, c = request(seeded, **kw)
        draws.append(toks)
        counts_ok &= c
        per_tok["sampled top_p 0.9, on the card"] = ms
        del seeded
    host = _path_lvu(dev, params, seed=7, sample_on_device=False)
    toks_h, per_tok["sampled top_p 0.9, on the host"], c = request(host, **kw)
    del host
    this_ok = draws[0] == draws[1] and counts_ok and c
    ok &= this_ok
    log(f"[3f sampling] seed 7, top_p 0.9, twice: {draws[0]} / {draws[1]} "
        f"{'OK' if this_ok else 'FAIL'}; host sampling {toks_h}")
    log("[3f sampling] decode ms/token: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_tok.items())
        + f"; peak {max(peaks):.2f} GiB")
    del lvu
    torch.cuda.empty_cache()
    return ok


def run_batching(dev, params, run, runs):
    """BatchedQAEngine over 4 questions on one video: each answer equals
    the question's own generate; B1 launches: the groups once, then per
    question its suffix and decode steps."""
    import torch

    from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine

    lvu = make_lvu(dev, "bfloat16", params=params)
    mcfg, n = lvu.model_config, lvu.model_config.text.num_hidden_layers
    eos = [lvu.tokenizer.eos_token_id]

    def reqs():
        return [make_request(mcfg, lvu.tokenizer, q, seed=0)
                for q in BATCH_QUESTIONS]

    got = run(BatchedQAEngine(lvu.engine).generate_batch, reqs(), 8,
              eos_token_ids=eos)
    runs.append(run.counts)
    b_wall, b_counts, b_peak = run.wall, run.counts, run.peak
    single, s_wall = [], 0.0
    for r in reqs():
        single.append(run(lvu.engine.generate, r, max_new_tokens=8,
                          eos_token_ids=eos).tokens)
        runs.append(run.counts)
        s_wall += run.wall
    r0 = reqs()
    steps = [g for per in group_layer_rows(lvu, r0[0]) for g in per]
    for r, toks in zip(r0, got):
        ids = np.asarray(r.input_ids)
        suffix = len(ids) - int(np.nonzero(ids == mcfg.video_token_id)[0][-1]) - 1
        steps += [suffix] * n + [1] * ((len(toks) - 1) * n)
    want = b1_kernels(lvu, steps)
    same = all(np.array_equal(a, b) for a, b in zip(got, single))
    this_ok = same and _b1_ok(b_counts, want)
    log(f"[3f batching] {len(got)} questions, one video prefill: "
        f"{[t.tolist() for t in got]} vs single requests "
        f"{'equal' if same else [t.tolist() for t in single]}; B1 kernels "
        f"{_kern({k: b_counts[k] for k in want})} (expected {_kern(want)}); "
        f"batched {b_wall:.4f} s vs single {s_wall:.4f} s, peak "
        f"{b_peak:.2f} GiB {'OK' if this_ok else 'FAIL'}")
    del lvu
    torch.cuda.empty_cache()
    return this_ok


def run_checkpoint(dev, run, runs):
    """Phase 4's narrow config (production head dims) written as a
    safetensors directory by quickvideo_tpu_torch/testing.py, loaded
    through LVU(LVUConfig(model_name_or_path=dir)): the generated tokens
    equal those of the same weights passed as `params=`, with bf16 and
    with int8 weights."""
    import tempfile

    import torch

    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.models.qwen25_vl.convert import (
        init_params,
        params_to,
    )
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves
    from quickvideo_tpu_torch.testing import write_checkpoint

    mcfg = narrow_config()
    base = init_params(mcfg, seed=5, dtype=torch.bfloat16, device=dev)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        d = write_checkpoint(os.path.join(tmp, "narrow"), base, mcfg)
        for param_dtype in ("bfloat16", "int8"):
            cfg = LVUConfig(model_name_or_path=d, max_decode_tokens=8,
                            top_p=0.5, param_dtype=param_dtype)
            t0 = time.perf_counter()
            loaded = LVU(cfg, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            given = LVU(cfg, params=params_to(base, device=dev), device=dev)
            inputs = [make_request(mcfg, loaded.tokenizer,
                                   "What happens in this video?", seed=7,
                                   n_frames=16, group_frames=8)
                      for _ in range(2)]
            a = run(loaded.engine.generate, inputs[0], max_new_tokens=8)
            runs.append(run.counts)
            b = run(given.engine.generate, inputs[1], max_new_tokens=8)
            runs.append(run.counts)
            dev_ok = all(t.device.type == "cuda"
                         for t in tensor_leaves(loaded.params))
            this_ok = (a.tokens.tolist() == b.tokens.tolist() and dev_ok
                       and run.counts["flash"] > 0)
            ok &= this_ok
            log(f"[3f checkpoint] narrow config from {len(os.listdir(d)) - 1}"
                f" safetensors shards, {param_dtype} weights: loaded in "
                f"{t_load:.3f} s, tokens {a.tokens.tolist()} vs the same "
                f"weights as params= {b.tokens.tolist()}, every leaf on the "
                f"card {dev_ok} {'OK' if this_ok else 'FAIL'}")
            del loaded, given
    torch.cuda.empty_cache()
    return ok


def run_api_paths(dev, params):
    """Phase 3f: the 7B (bf16 weights `params`, full width and depth)
    through LVU.start_chat / resume_chat, LVU.loglikelihood_multi,
    LVU.generate(do_sample=...) and BatchedQAEngine on seeded 64-frame
    videos, then a narrow checkpoint directory through LVU. Returns (ok,
    each run's launch counts)."""
    import torch

    run = _Run(_kernel_counters())
    runs = []
    ok = True
    torch.cuda.reset_peak_memory_stats()
    with seeded_videos():
        for fn in (run_session, run_scoring, run_sampling, run_batching):
            ok &= fn(dev, params, run, runs)
    ok &= run_checkpoint(dev, run, runs)
    log("[3f] B1 launches per kernel over the phase: " + _kern(
        {f"flash_kernel_{k}": sum(r[f"flash_kernel_{k}"] for r in runs)
         for k in B1_KERNELS}) + f" {'OK' if ok else 'FAIL'}")
    return ok, runs


# -- phase 3g: the HTTP server, the CLI and the disk frame cache -------------


def _spelled(lvu):
    """`lvu` with answers that spell their token ids: under the byte-level
    fallback tokenizer most of the random 7B's tokens decode to U+FFFD, so
    only spelled answers make equal text mean equal tokens on the HTTP and
    CLI surfaces."""
    lvu.tokenizer.decode = lambda ids: "".join(f"<{int(t)}>" for t in ids)
    return lvu


def _http(base, path, body=None, method=None, data=None):
    """(status, decoded JSON body) of one request; `data` sends raw
    bytes."""
    import urllib.error
    import urllib.request

    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(base, path, body):
    """(status, content type, the JSON frames before `data: [DONE]`, whether
    the stream ended with it) of a streamed request."""
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(dict(body, stream=True)).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=900) as resp:
        status, ctype = resp.status, resp.headers.get("Content-Type")
        raw = resp.read().decode()
    frames = [f[len("data: "):] for f in raw.split("\n\n")
              if f.startswith("data: ")]
    done = bool(frames) and frames[-1] == "[DONE]"
    return status, ctype, [json.loads(f) for f in frames[:-1]], done


def _status_ok(what, got, want):
    this_ok = got == want
    if not this_ok:
        log(f"[3g serve] {what}: HTTP {got}, expected {want} FAIL")
    return this_ok


def run_serving(dev, params, run, runs):
    """make_http_server on port 0 in this process over the 7B (bf16
    weights `params`, seeded videos): a burst of 4 /v1/generate questions
    about one video served as one micro-batch, against 4 direct
    LVU.generate calls; two sessions with max_resident_sessions=1, the
    first spilled to disk and resumed on its next ask, against a session
    that never spilled; /v1/chat/completions with a video_url part; one
    SSE stream on each streaming route against the unstreamed answer; a
    400 and a 413. Every status is checked. The LVU takes the device as
    the server's `main` gives it, "cuda" with no index, so the worker
    thread selects the card the LVU resolved it to."""
    import threading

    import torch

    from quickvideo_tpu_torch.serving import ServerConfig, make_http_server

    lvu = _spelled(_path_lvu("cuda", params))
    n = lvu.model_config.text.num_hidden_layers
    ok = lvu.device == dev
    log(f"serving LVU(device='cuda') resolved to {lvu.device} "
        f"{'OK' if ok else 'FAIL'}")
    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "serve.mp4")
        other = os.path.join(tmp, "other.mp4")
        for path in (video, other):  # the routes check that paths exist
            open(path, "wb").close()
        cfg = ServerConfig(port=0, spill_dir=os.path.join(tmp, "spill"),
                           max_resident_sessions=1, default_max_new_tokens=8,
                           request_timeout_s=900, max_body_bytes=1 << 16)
        httpd, server = make_http_server(lvu, cfg)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            ok &= _serve_checks(lvu, server, base, video, other, n, run,
                                runs)
        finally:
            httpd.shutdown()
            server.shutdown()
            httpd.server_close()
    del lvu
    torch.cuda.empty_cache()
    return ok


def _serve_checks(lvu, server, base, video, other, n, run, runs):
    import threading

    ok = True
    questions = BATCH_QUESTIONS
    direct, direct_toks, single_wall = [], [], 0.0
    for q in questions:
        direct.append(run(lvu.generate, q, video, max_new_tokens=8)[0])
        runs.append(run.counts)
        direct_toks.append(len(lvu.last_result.tokens))
        single_wall += run.wall

    # the burst: queued behind a paused worker (which may hold one popped
    # job), released at once, drained into one micro-batch
    server.pause()
    got = {}

    def ask(i):
        got[i] = _http(base, "/v1/generate", {
            "video": video, "question": questions[i], "max_new_tokens": 8})

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(questions))]
    for t in threads:
        t.start()
    for _ in range(600):
        if server._q.qsize() >= len(questions) - 1:
            break
        time.sleep(0.05)
    time.sleep(0.2)

    def release():
        server.resume()
        for t in threads:
            t.join(timeout=900)

    run(release)
    runs.append(run.counts)
    groups, _ = _video_request_rows(lvu, questions[0], video)
    steps = list(groups)
    for q, n_tok in zip(questions, direct_toks):
        steps += ([_video_request_rows(lvu, q, video)[1]] * n
                  + [1] * ((n_tok - 1) * n))
    want = b1_kernels(lvu, steps)
    code, stats = _http(base, "/v1/stats")
    this_ok = (all(_status_ok(f"burst request {i}", got[i][0], 200)
                   for i in got)
               and [got[i][1].get("answer") for i in range(len(questions))]
               == direct and stats["batches"] == {str(len(questions)): 1}
               and _b1_ok(run.counts, want) and run.counts["vision_2d"] > 0
               and _status_ok("stats", code, 200))
    ok &= this_ok
    log(f"[3g serve] burst of {len(questions)} /v1/generate questions on one "
        f"video: answers equal to {len(questions)} direct LVU.generate calls "
        f"{[got[i][1].get('answer') for i in range(len(questions))] == direct}"
        f"; batch histogram {stats['batches']}; B1 kernels "
        f"{_kern({k: run.counts[k] for k in want})} (expected {_kern(want)}); "
        f"B2 {run.counts['vision_2d']}; wall {run.wall:.4f} s vs "
        f"{single_wall:.4f} s for the {len(questions)} direct calls, peak "
        f"{run.peak:.2f} GiB {'OK' if this_ok else 'FAIL'}")

    # sessions: the first spills to disk when the second arrives and
    # resumes on its next ask; a session that never spilled answers alike
    q1, q2 = SESSION_QUESTIONS[:2]
    live = lvu.start_chat(video)
    live_answers = [live.ask(q1, max_new_tokens=8),
                    run(live.ask, q2, max_new_tokens=8)]
    live_wall = run.wall
    del live
    code1, s1 = _http(base, "/v1/sessions", {"video": video})
    sid1 = s1.get("session_id")
    code2, a1 = _http(base, f"/v1/sessions/{sid1}/ask",
                      {"question": q1, "max_new_tokens": 8})
    code3, s2 = run(_http, base, "/v1/sessions", {"video": other})
    spill_wall = run.wall
    sid2 = s2.get("session_id")
    code4, b1 = _http(base, f"/v1/sessions/{sid2}/ask",
                      {"question": q1, "max_new_tokens": 8})
    code5, a2 = run(_http, base, f"/v1/sessions/{sid1}/ask",
                    {"question": q2, "max_new_tokens": 8})
    runs.append(run.counts)
    resume_wall, resume_counts = run.wall, run.counts
    _, stats = _http(base, "/v1/stats")
    closed = [_http(base, f"/v1/sessions/{sid}", method="DELETE")[0]
              for sid in (sid1, sid2)]
    statuses = all(_status_ok(w, c, 200) for w, c in (
        ("session 1", code1), ("session 1 ask", code2), ("session 2", code3),
        ("session 2 ask", code4), ("session 1 resumed ask", code5),
        ("close 1", closed[0]), ("close 2", closed[1])))
    this_ok = (statuses and [a1.get("answer"), a2.get("answer")]
               == live_answers and stats["spills"] >= 1
               and stats["resumes"] >= 1 and resume_counts["vision_2d"] == 0
               and resume_counts["flash"] > 0)
    ok &= this_ok
    log(f"[3g serve] two sessions, max_resident_sessions=1: session 1's "
        f"answers {[a1.get('answer'), a2.get('answer')]} vs a session that "
        f"never spilled {live_answers}; spills {stats['spills']}, resumes "
        f"{stats['resumes']}; session 2's creation (spilling session 1's "
        f"cache to disk) {spill_wall:.4f} s; session 1's next ask (resumed "
        f"from disk, no vision) {resume_wall:.4f} s against "
        f"{live_wall:.4f} s for that follow-up on a session that stayed on "
        f"the card {'OK' if this_ok else 'FAIL'}")

    # the OpenAI adapter, then one stream on each streaming route
    messages = [{"role": "user", "content": [
        {"type": "video_url", "video_url": {"url": f"file://{video}"}},
        {"type": "text", "text": questions[0]}]}]
    code, out = _http(base, "/v1/chat/completions",
                      {"model": "qwen25-vl-7b", "max_tokens": 8,
                       "messages": messages})
    content = (out.get("choices") or [{}])[0].get("message", {}).get("content")
    this_ok = (_status_ok("chat completion", code, 200)
               and out.get("object") == "chat.completion"
               and content == direct[0])
    ok &= this_ok
    log(f"[3g serve] /v1/chat/completions with a video_url part: "
        f"{content} vs the direct answer {direct[0]} "
        f"{'OK' if this_ok else 'FAIL'}")

    code, s3 = _http(base, "/v1/sessions", {"video": video})
    streams = {
        "/v1/generate": (_sse(base, "/v1/generate", {
            "video": video, "question": questions[1], "max_new_tokens": 8}),
            direct[1], "delta"),
        "/v1/sessions/<id>/ask": (_sse(
            base, f"/v1/sessions/{s3.get('session_id')}/ask",
            {"question": q1, "max_new_tokens": 8}), live_answers[0],
            "delta"),
        "/v1/chat/completions": (_sse(base, "/v1/chat/completions", {
            "model": "qwen25-vl-7b", "max_tokens": 8,
            "messages": messages}), direct[0], "openai"),
    }
    ok &= _status_ok("stream session", code, 200)
    _http(base, f"/v1/sessions/{s3.get('session_id')}", method="DELETE")
    for route, ((status, ctype, frames, done), want, kind) in streams.items():
        if kind == "openai":
            joined = "".join(f["choices"][0]["delta"].get("content", "")
                             for f in frames)
            final = frames[-1]["choices"][0]["finish_reason"] == "stop"
        else:
            joined = "".join(f["delta"] for f in frames if "delta" in f)
            final = [f["answer"] for f in frames if "answer" in f] == [want]
        this_ok = (_status_ok(f"stream {route}", status, 200) and done
                   and ctype == "text/event-stream" and joined == want
                   and final)
        ok &= this_ok
        log(f"[3g serve] SSE on {route}: {len(frames)} frames whose deltas "
            f"join to {joined} vs the unstreamed {want} "
            f"{'OK' if this_ok else 'FAIL'}")

    code400, out400 = _http(base, "/v1/generate", {"video": video})
    code413, out413 = _http(base, "/v1/generate",
                            data=json.dumps({"video": video, "question":
                                             "x" * (1 << 17)}).encode())
    this_ok = (_status_ok("missing question", code400, 400)
               and _status_ok("oversized body", code413, 413))
    ok &= this_ok
    log(f"[3g serve] refusals: {code400} {out400.get('error')!r}; {code413} "
        f"{out413.get('error')!r} {'OK' if this_ok else 'FAIL'}")
    return ok


@contextlib.contextmanager
def _cli_lvu(built, **kw):
    """quickvideo_tpu_torch.api.LVU recording each instance the CLI builds
    in `built` (spelled, a preset's weights seeded as make_lvu's, `kw`
    passed on: params= for shared weights)."""
    from quickvideo_tpu_torch import api

    orig = api.LVU

    def make(cfg, device=None):
        with _seeded_weights():
            built.append(_spelled(orig(cfg, device=device, **kw)))
        return built[-1]

    api.LVU = make
    try:
        yield
    finally:
        api.LVU = orig


def _cli(argv):
    """(exit code, stdout lines) of lvu_cli.main(argv) with an empty
    stdin."""
    import io

    from quickvideo_tpu_torch import lvu_cli

    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("")
    try:
        with contextlib.redirect_stdout(out):
            rc = lvu_cli.main(argv)
    finally:
        sys.stdin = stdin
    return rc, out.getvalue().splitlines()


def run_cli(dev, params, run, runs):
    """lvu_cli.main in this process: one --json question on the 7B with
    int8 weights drawn from the seed (kernels B1-B4), whose JSON line must
    hold the direct call's answer and cache_length; then --interactive with
    queued questions, an empty stdin and --session_file (bf16 weights
    `params`), saved, then resumed for a third turn, against a session of
    the same LVU that never left the card."""
    import torch

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "cli.mp4")
        argv = ["--video_path", video, "--model_name_or_path", "qwen25-vl-7b",
                "--num_frames", str(REQUEST_FRAMES), "--video_group_size",
                str(GROUP_FRAMES), "--top_p", "0.5", "--decode_output",
                "yuv420", "--max_new_tokens", "8", "--device",
                torch.device(dev).type]
        built = []
        with _cli_lvu(built):
            rc, lines = run(_cli, argv + ["--param_dtype", "int8", "--json",
                                          "--question", QUESTIONS[0]])
        runs.append(run.counts)
        counts, wall = run.counts, run.wall
        (lvu,) = built
        rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
        answer = run(lvu.generate, QUESTIONS[0], video, max_new_tokens=8)[0]
        res = lvu.last_result
        this_ok = (rc == 0 and len(rows) == 1
                   and rows[0]["answer"] == answer
                   and rows[0]["cache_length"] == res.cache_length
                   and rows[0]["tokens"] == len(res.tokens)
                   and lvu.config.param_dtype == "int8"
                   and all(counts[k] > 0 for k in
                           ("flash", "vision_2d", "ln_gemm", "ln_mlp")))
        ok &= this_ok
        log(f"[3g cli] --json, int8 weights: {rows[0] if rows else lines} vs "
            f"the direct call's answer {answer} and cache_length "
            f"{res.cache_length}; launches B1 {counts['flash']} B2 "
            f"{counts['vision_2d']} B3 {counts['ln_gemm']} B4 "
            f"{counts['ln_mlp']}; wall with the 7B's init {wall:.2f} s "
            f"{'OK' if this_ok else 'FAIL'}")
        del built, lvu
        torch.cuda.empty_cache()

        sess = os.path.join(tmp, "session.npz")
        chat = argv + ["--interactive", "--json", "--session_file", sess]
        built = []
        with _cli_lvu(built, params=params):
            rc1, first = _cli(chat + ["--question", SESSION_QUESTIONS[0],
                                      "--question", SESSION_QUESTIONS[1]])
            rc2, second = _cli(chat + ["--question", SESSION_QUESTIONS[2]])
        live = built[0].start_chat(video)
        want = [live.ask(q, max_new_tokens=8) for q in SESSION_QUESTIONS[:3]]
        rows = [json.loads(ln) for ln in first + second if ln.startswith("{")]
        this_ok = (rc1 == rc2 == 0
                   and [r["answer"] for r in rows] == want
                   # input()'s prompt may lead the line
                   and any(ln.endswith(f"[chat] session saved to {sess}")
                           for ln in first)
                   and f"[chat] resumed session from {sess} (2 prior turns)"
                   in second)
        ok &= this_ok
        log(f"[3g cli] --interactive --session_file: turns "
            f"{[r['answer'] for r in rows]} (turn_s "
            f"{[r['turn_s'] for r in rows]}), the third after a resume, vs "
            f"a live session {want} {'OK' if this_ok else 'FAIL'}")
        del built, live
    torch.cuda.empty_cache()
    return ok


def run_frame_cache(dev, params, run, runs):
    """save_video_cache with a temporary cache_dir through the sync engine:
    the first request decodes 64 frames and writes them, the second reads
    them from disk and draws none from the reader; equal tokens."""
    import torch

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        lvu = _path_lvu(dev, params, model_type="qwen25_lvu",
                        save_video_cache=True, cache_dir=tmp)
        seen = []
        for turn in ("decode + write", "cache hit"):
            SeededReader.frames_read = 0
            run(lvu.generate, QUESTIONS[0], "seeded-cache.mp4",
                max_new_tokens=8)
            runs.append(run.counts)
            res = lvu.last_result
            seen.append((res.tokens.tolist(), SeededReader.frames_read,
                         res.timings["frame_fetch"], run.wall,
                         run.counts["flash"]))
            log(f"[3g frame cache] {turn}: frames drawn from the reader "
                f"{SeededReader.frames_read}, frame_fetch span "
                f"{res.timings['frame_fetch']:.4f} s, wall {run.wall:.4f} s, "
                f"tokens {res.tokens.tolist()}")
        entries = os.listdir(tmp)
        this_ok = (seen[0][1] == REQUEST_FRAMES and seen[1][1] == 0
                   and seen[0][0] == seen[1][0] and len(entries) == 1
                   and seen[0][4] == seen[1][4] > 0)
        ok &= this_ok
        log(f"[3g frame cache] entry {entries}; the second request read no "
            f"frame from the reader and gave the first one's tokens "
            f"{'OK' if this_ok else 'FAIL'}")
        del lvu
    torch.cuda.empty_cache()
    return ok


def run_front_end(dev, params):
    """Phase 3g: the server, the CLI and the disk frame cache on the 7B.
    Returns (ok, each run's launch counts)."""
    run = _Run(_kernel_counters())
    runs = []
    ok = True
    with seeded_videos():
        for fn in (run_serving, run_cli, run_frame_cache):
            ok &= fn(dev, params, run, runs)
    log("[3g] B1 launches per kernel over the phase: " + _kern(
        {f"flash_kernel_{k}": sum(r[f"flash_kernel_{k}"] for r in runs)
         for k in B1_KERNELS}) + f" {'OK' if ok else 'FAIL'}")
    return ok, runs


# -- phase 3h: the on-device resize ------------------------------------------

def run_device_resize(dev, params):
    """Phase 3h: one 64-frame 7B request (bf16 weights `params`) from
    480 x 854 sources, resized in the decoder (the seeded reader draws
    frames at the grid) and resized on the card (resize_on_device) in
    yuv420 and in RGB; each twice, the second with spans that synchronize
    (QV_SYNC_SPANS=1). Launches, cache lengths, the vision span and the
    frame bytes sent to the card; then lanczos3_resize on the card against
    its own f32 run on the CPU over one group's frames. Returns (ok, each
    run's launch counts)."""
    import torch

    from quickvideo_tpu_torch.ops.resize import lanczos3_resize

    run = _Run(_kernel_counters())
    runs = []
    ok = True
    video = "seeded-resize.mp4"
    with seeded_videos(RESIZE_SOURCE_HW):
        for fmt, resize in (("yuv420", False), ("yuv420", True),
                            ("rgb", True)):
            lvu = _path_lvu(dev, params, resize_on_device=resize,
                            decode_output=fmt)
            for sync in ("0", "1"):
                os.environ["QV_SYNC_SPANS"] = sync
                try:
                    run(lvu.generate, QUESTIONS[0], video, max_new_tokens=8)
                finally:
                    os.environ.pop("QV_SYNC_SPANS", None)
                runs.append(run.counts)
            res = lvu.last_result
            drawn = SeededReader.drawn_hw
            inputs, suffix = _video_request(lvu, QUESTIONS[0], video)
            ps = lvu.model_config.vision.patch_size
            plan_hw = tuple(ps * x for x in inputs.group_grids[0][1:])
            groups = [g for per in group_layer_rows(lvu, inputs) for g in per]
            n = lvu.model_config.text.num_hidden_layers
            want = b1_kernels(lvu, groups + [suffix] * n
                              + [1] * ((len(res.tokens) - 1) * n))
            b2, b5, rot = expected_vision(lvu.model_config,
                                          inputs.group_grids)
            want_len = expected_lengths(lvu, inputs, len(res.tokens))[0]
            h, w = drawn
            frame_bytes = h * w * 3 // 2 if fmt == "yuv420" else 3 * h * w
            this_ok = (_b1_ok(run.counts, want)
                       and (run.counts["vision_2d"], run.counts["vision_hm"],
                            run.counts["rotary"]) == (b2, b5, rot)
                       and res.cache_length == want_len
                       # frames left the reader at the source size only
                       # when the card resizes them
                       and drawn == (RESIZE_SOURCE_HW if resize
                                     else plan_hw))
            ok &= this_ok
            log(f"[3h] {'on the card' if resize else 'in the decoder'}, "
                f"{fmt}: {RESIZE_SOURCE_HW[0]}x{RESIZE_SOURCE_HW[1]} -> "
                f"{plan_hw[0]}x{plan_hw[1]} (grid {inputs.group_grids[0]}), "
                f"frames sent at {h}x{w}: "
                f"{REQUEST_FRAMES * frame_bytes / 2**20:.2f} MiB to the card; "
                f"vision span {res.timings['vision']:.4f} s (sync), wall "
                f"{run.wall:.4f} s; tokens {res.tokens.tolist()} "
                f"cache_length {res.cache_length} (expected {want_len}); B1 kernels "
                f"{_kern({k: run.counts[k] for k in want})} (expected "
                f"{_kern(want)}), B2 / B5 / rotary {run.counts['vision_2d']} "
                f"/ {run.counts['vision_hm']} / {run.counts['rotary']} "
                f"(expected {b2} / {b5} / {rot}) "
                f"{'OK' if this_ok else 'FAIL'}")
            del lvu
            torch.cuda.empty_cache()

    out_hw = plan_hw
    x = torch.randint(0, 256, (GROUP_FRAMES, 3, *RESIZE_SOURCE_HW),
                      generator=torch.Generator().manual_seed(0)).float()
    xd = x.to(dev)
    got = lanczos3_resize(xd, out_hw).cpu()
    t0 = time.perf_counter()
    want = lanczos3_resize(x, out_hw)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    err = (got - want).abs().max().item()
    ms = _time_ms(lambda: lanczos3_resize(xd, out_hw), 10)
    this_ok = bool(err <= RESIZE_ATOL and torch.isfinite(got).all())
    ok &= this_ok
    log(f"[3h] lanczos3_resize of {GROUP_FRAMES} RGB f32 frames "
        f"{RESIZE_SOURCE_HW} -> {out_hw}: card vs its CPU run max abs "
        f"{err:.3e} (tol {RESIZE_ATOL} on 0..255), {ms:.4f} ms on the card, "
        f"{cpu_ms:.1f} ms on the CPU {'OK' if this_ok else 'FAIL'}")
    del x, xd, got, want
    torch.cuda.empty_cache()
    return ok, runs


# -- phase 3i: tensor and context parallelism over torch.distributed --------

class MeshRun(NamedTuple):
    """One run of a mesh phase: request 0 of phase 3 on the mesh `mesh`
    (seeded weights of the preset `model`, at `layers` decoder layers where
    given), held `against` one rank's run of the same configuration on card
    0 ("one"; phases 3i / 3j take phase 3's, recorded by run_main_path),
    against an earlier run of the same call (its tag), or against nothing
    ("none": the run must agree over its ranks and with the config's rules
    only; its logits are printed beside the earlier runs' of the same
    model)."""

    tag: str
    mesh: dict
    param_dtype: str
    kv_dtype: str
    model: str = MODEL_7B
    layers: Optional[int] = None
    against: str = "one"
    # the preset path's deterministic weights instead of the seeded ones:
    # each rank's part is checked at sampled blocks against the index
    # function's (fast_samples), its parameter bytes against the seeded
    # twin's (the tag without "_fast") where that ran before it
    fast: bool = False

    @property
    def world(self) -> int:
        return int(np.prod(list(self.mesh.values())))

    @property
    def ref_key(self):
        """The key of its one-rank reference."""
        if (self.model, self.layers) == (MODEL_7B, None):
            return (self.param_dtype, self.kv_dtype)  # MAIN_PATH_REFERENCE's
        return (self.model, self.layers, self.param_dtype, self.kv_dtype)


# the runs of phase 3i, the 7B on two gloo ranks sharing the card
MESH_RUNS = (
    MeshRun("tp2", {"tp": 2}, "bfloat16", "auto"),
    MeshRun("sp2", {"sp": 2}, "bfloat16", "auto"),
    MeshRun("sp2_int8kv", {"sp": 2}, "bfloat16", "int8"),
    MeshRun("tp2_int8w", {"tp": 2}, "int8", "auto"),
)
MESH_WORLD = 2
# the runs of phase 3j, pipeline parallelism; the first also runs
# pp_extras (sampled, streamed, scored)
PP_RUNS = (
    MeshRun("pp2", {"pp": 2}, "bfloat16", "auto"),
    MeshRun("pp2_int8kv", {"pp": 2}, "bfloat16", "int8"),
    MeshRun("pp2_int8w", {"pp": 2}, "int8", "auto"),
)
MODEL_72B = "qwen25-vl-72b"
# `--mesh-cards`: the mesh runs with NCCL, one rank per card, by the
# number of cards on the machine; a run of fewer ranks takes the first
# cards
CARD_MESH_RUNS = {
    2: (MeshRun("tp2", {"tp": 2}, "bfloat16", "auto"),
        MeshRun("sp2", {"sp": 2}, "bfloat16", "auto"),
        MeshRun("tp2_int8w", {"tp": 2}, "int8", "auto"),
        MeshRun("pp2", {"pp": 2}, "bfloat16", "auto")),
    4: (MeshRun("tp4", {"tp": 4}, "bfloat16", "auto"),
        MeshRun("sp4", {"sp": 4}, "bfloat16", "auto"),
        MeshRun("tp2_sp2", {"tp": 2, "sp": 2}, "bfloat16", "auto"),
        MeshRun("sp4_int8kv", {"sp": 4}, "bfloat16", "int8"),
        MeshRun("tp4_int8w", {"tp": 4}, "int8", "auto"),
        MeshRun("pp4", {"pp": 4}, "bfloat16", "auto"),
        MeshRun("pp2_tp2", {"pp": 2, "tp": 2}, "bfloat16", "auto"),
        MeshRun("pp4_int8w", {"pp": 4}, "int8", "auto"),
        # pp = 2 on two cards, twice over (two dp replicas)
        MeshRun("dp2_pp2", {"dp": 2, "pp": 2}, "bfloat16", "auto"),
        # the 72B, which fits one card only cut in depth: its 8 layers
        # over tp = 2 and tp = 4 against the same 8 on card 0, and pp 2 x
        # tp 2 against tp = 2 (the same sums: bit for bit), with a bf16 and
        # an int8 cache (ROADMAP C28)
        MeshRun("72b8_tp2", {"tp": 2}, "bfloat16", "auto", MODEL_72B, 8),
        MeshRun("72b8_tp4", {"tp": 4}, "bfloat16", "auto", MODEL_72B, 8),
        MeshRun("72b8_pp2_tp2", {"pp": 2, "tp": 2}, "bfloat16", "auto",
                MODEL_72B, 8, against="72b8_tp2"),
        MeshRun("72b8_tp2_int8kv", {"tp": 2}, "bfloat16", "int8",
                MODEL_72B, 8),
        MeshRun("72b8_tp4_int8kv", {"tp": 4}, "bfloat16", "int8",
                MODEL_72B, 8),
        MeshRun("72b8_pp2_tp2_int8kv", {"pp": 2, "tp": 2}, "bfloat16",
                "int8", MODEL_72B, 8, against="72b8_tp2_int8kv")),
}
# runs made only where `--mesh-runs` names them: the 72B at 16 layers over
# tp = 2 (how far tp's roundings grow with depth; fits one card's gloo
# ranks), and at its 80 layers on four cards (about 13 minutes for all of
# them: about 40 GB of bf16 weights a rank over four, drawn and run once
# each). There "auto" resolves to int8 (ROADMAP C26), so an explicit bf16
# cache beside it; pp 2 x tp 2 against tp = 4 (other sums: C28); int8
# weights over tp = 2 on two cards (about 37.7 GB a rank)
TAGGED_RUNS = (
    MeshRun("72b16_tp2", {"tp": 2}, "bfloat16", "auto", MODEL_72B, 16),
    MeshRun("72b_tp4", {"tp": 4}, "bfloat16", "auto", MODEL_72B,
            against="none"),
    MeshRun("72b_tp4_bf16kv", {"tp": 4}, "bfloat16", "bfloat16", MODEL_72B,
            against="none"),
    MeshRun("72b_pp2_tp2", {"pp": 2, "tp": 2}, "bfloat16", "auto", MODEL_72B,
            against="72b_tp4"),
    MeshRun("72b_pp2_tp2_bf16kv", {"pp": 2, "tp": 2}, "bfloat16", "bfloat16",
            MODEL_72B, against="72b_tp4_bf16kv"),
    MeshRun("72b_tp2_int8w", {"tp": 2}, "int8", "auto", MODEL_72B,
            against="none"),
    # the preset path's own weights over tp = 4 (the JAX package's, whose
    # int32 iota wraps in the 72B's stacked wq, wo, wg, wu and wd; ROADMAP
    # C30), beside 72b_tp4's parameter bytes
    MeshRun("72b_tp4_fast", {"tp": 4}, "bfloat16", "auto", MODEL_72B,
            against="none", fast=True),
)


def tagged_runs(only: str) -> tuple:
    """The runs of every table (CARD_MESH_RUNS, TAGGED_RUNS) tagged in
    `only`, a comma-separated string."""
    tags = only.split(",")
    return tuple(r for table in (*CARD_MESH_RUNS.values(), TAGGED_RUNS)
                 for r in table if r.tag in tags)
# pipeline parallelism vs one rank, final-prefill logits: pp changes no
# arithmetic (each layer runs the same kernels at the same shapes on the
# same cache layout; the activation crosses as its bytes), so they are
# expected bit for bit; the stated limit only admits a difference that
# the line names. pp x tp is held against tp alone's limits
PP_LOGITS_REL_L2 = 1e-6
# tp / sp vs one rank, final-prefill logits: the mesh changes the order of
# f32 sums (the o-projection's and MLP's partial products summed over tp,
# the past split in two windows and merged) and where bf16 rounds (a tp
# product rounds once after the f32 all-reduce); under sp with an int8
# cache the group also attends its own raw bf16 K/V (the in-group partial,
# as the JAX package's CP route does) where one rank reads them back
# quantized. The first is the class of difference of phase 3f's follow-up
# against the whole history from scratch (3.468e-2, PERF.md section 6), the
# second at most the int8-vs-bf16 KV distance of phase 3c; both within
# LOGITS_REL_L2
MESH_LOGITS_REL_L2 = LOGITS_REL_L2
# the same with int8 weights: every act-quantized product re-quantizes the
# rows those roundings moved, and the flipped codes grow through 28
# layers; phase 4 measures int8 weights 4x as far as bf16 ones from the
# same rounding differences (2.1e-2 against 5.4e-3, PERF.md section 6), and
# tp = 2 measured 1.127e-1 on its first run, tokens equal, while
# check_tp_products holds its int8 products to one device's codes and
# sums. Three times the bf16 limit
MESH_INT8_LOGITS_REL_L2 = 3 * LOGITS_REL_L2
# a tp rank's int8 product against one device's (check_tp_products): the
# codes and s32 sums are equal, only two f32 partial sums are added in
# another order
MESH_PRODUCT_REL_L2 = 1e-6
# one decoder layer at the 7B's width, a tp rank's shard vs the whole
# layer (check_tp_layer): the partial products sum in f32 over tp where one
# device sums in one product, and B1 splits a kv head's keys differently at
# 2 kv heads than at 4, so the outputs differ by bf16 roundings (2^-8
# relative each; ten roundings' worth with bf16 weights) and, with int8
# weights, by the codes those roundings flip: phase 4 measures int8 weights
# 4x as far as bf16 from the same rounding differences (2.1e-2 against
# 5.4e-3, PERF.md section 6)
MESH_LAYER_REL_L2 = {"bfloat16": 1e-2, "int8": 4e-2}
# a rank's whole mesh phase (kernel builds are done by then)
MESH_TIMEOUT_S = 900
# the windows of the cp kernel checks: capacity 8192 over 2 ranks; lengths
# 0 (both windows empty), 1805 (the second empty, the 64-frame request's
# state before its second group), 4133 (the second window partial) and
# 8192 (both full); rows 3600 (a group step) and 1 (decode)
CP_CHECK_CAP = 8192
CP_CHECK_LENGTHS = (0, 1805, 4133, 8192)
CP_CHECK_ROWS = (3600, 1)
# the in-group partial's rows: a group step, a 20-token final prefill, a
# decode step
IN_GROUP_ROWS = (3600, 20, 1)


def expected_b1_mesh(lvu, inputs, n_tokens, variant, sp):
    """B1 launches of one rank per "flash_{variant}_{mode}" and
    "flash_kernel_{name}" key. tp alone: those of one rank (expected_b1,
    expected_kernels; a tp rank keeps rep = 7). Under sp every step of
    every layer (group steps, the final prefill, each decode step) runs
    the past on the rank's window (pure past + lse, the cache's variant)
    and the in-group partial (unified + lse, bf16, over the raw group)."""
    if sp == 1:
        want = expected_b1(lvu, inputs, n_tokens, variant)
        want.update(expected_kernels(lvu, inputs, n_tokens, variant))
        return want
    n = lvu.model_config.text.num_hidden_layers
    ids = np.asarray(inputs.input_ids)
    vid = np.nonzero(ids == lvu.model_config.video_token_id)[0]
    suffix = len(ids) - int(vid[-1]) - 1
    rows = [g for per_layer in group_layer_rows(lvu, inputs)
            for g in per_layer] + [suffix] * n + [1] * ((n_tokens - 1) * n)
    want = {f"flash_{variant}_past+lse": len(rows),
            "flash_bf16_unified+lse": len(rows)}
    for var in (variant, "bf16"):
        for k, c in b1_kernels(lvu, rows, var).items():
            want[k] = want.get(k, 0) + c
    return want


def _cp_check_cache(dev, variant, gen):
    """One seeded layer of CP_CHECK_CAP slots in `variant`, whole."""
    import torch

    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    k = torch.randn(4, CP_CHECK_CAP, 128, generator=gen, device=dev)
    v = torch.randn(4, CP_CHECK_CAP, 128, generator=gen, device=dev)
    cache = init_cache(1, 4, CP_CHECK_CAP, 128, device=dev, quantized={
        "bf16": False, "int8": True, "int8k": "k"}[variant])
    stacked_append(cache, 0, 0, k.bfloat16(), v.bfloat16())
    return cache


def check_cp_kernels(dev, mesh):
    """On every rank of an sp mesh (collective): B1 pure past + lse on
    each rank's window at its local length, merged over sp
    (cp_stacked_past_attention), against the plain version over the whole
    cache, for every cache variant, CP_CHECK_LENGTHS x CP_CHECK_ROWS (an
    empty window must give out 0 and lse NEG_INF before the merge weighs it
    at 0); then the in-group partial (B1 unified + lse over an empty past)
    against its plain version. Returns (ok, rows) with each case's error;
    only rank 0 logs."""
    import torch

    from quickvideo_tpu_torch.ops.attention import (
        NEG_INF,
        cache_attention,
        cache_attention_int8,
        quantize_q,
    )
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
    from quickvideo_tpu_torch.parallel.context_parallel import (
        cp_stacked_past_attention,
        in_group_partial,
        shard_cache_cp,
    )

    say = log if mesh.rank == 0 else (lambda msg: None)
    scale = 128 ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    ok, rows = True, []
    for variant in B1_VARIANTS:
        whole = _cp_check_cache(dev, variant, gen)
        window = shard_cache_cp(whole, mesh.index("sp"), mesh.sp)
        for g in CP_CHECK_ROWS:
            q = torch.randn(g, 28, 128, generator=gen, device=dev)
            q = q.bfloat16().transpose(0, 1)
            for length in CP_CHECK_LENGTHS:
                local = window.local_length(length)
                own = flash_past_attention(
                    q, window.k[0], window.v[0], local, scale,
                    k_scale=None if window.k_scale is None
                    else window.k_scale[0],
                    v_scale=None if window.v_scale is None
                    else window.v_scale[0],
                    causal=False, with_lse=True, out_dtype=torch.float32)
                empty_ok = local > 0 or (not own[0].any() and bool(
                    (own[1] == NEG_INF).all()))
                got = cp_stacked_past_attention(q, window, 0, length, scale,
                                                mesh.group("sp"))
                mode = dict(causal=False, with_lse=True,
                            out_dtype=torch.float32)
                if variant == "bf16":
                    ref = cache_attention(q, whole.k[0], whole.v[0], length,
                                          scale, **mode)
                else:
                    q8, qs = quantize_q(q, scale)
                    ref = cache_attention_int8(
                        q8, qs, whole.k[0], whole.k_scale[0], whole.v[0],
                        None if whole.v_scale is None else whole.v_scale[0],
                        length, torch.bfloat16, **mode)
                err, within = _compare(got.out, ref[0])
                lse_err = (got.lse - ref[1]).abs().max().item()
                case_ok = (within and empty_ok and lse_err <= LSE_ATOL
                           and bool(torch.isfinite(got.lse).all()))
                ok &= case_ok
                rows.append(dict(what="cp_past", variant=variant, g=g,
                                 length=length, err=max(err, lse_err),
                                 ok=case_ok))
                say(f"[3i] B1 {variant} pure past + lse per window, merged "
                    f"over sp={mesh.sp}: G={g} length={length} (this "
                    f"window {local}): out max_abs_err={err:.3e} lse "
                    f"max_abs_err={lse_err:.3e} empty window "
                    f"{'0 / NEG_INF' if local == 0 else 'n/a'} "
                    f"{'OK' if case_ok else 'FAIL'}")
        del whole, window
    for g in IN_GROUP_ROWS:
        q = torch.randn(g, 28, 128, generator=gen, device=dev)
        q = q.bfloat16().transpose(0, 1)
        # the group's K/V as the model lays them out: (G, Hkv, D) rows
        k = torch.randn(g, 4, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(g, 4, 128, generator=gen, device=dev).bfloat16()
        k, v = k.transpose(0, 1), v.transpose(0, 1)
        got = in_group_partial(q, k, v, scale)
        ref = cache_attention(q, k, v, 0, scale, causal=True, with_lse=True,
                              out_dtype=torch.float32)
        err, within = _compare(got.out, ref[0])
        lse_err = (got.lse - ref[1]).abs().max().item()
        case_ok = within and lse_err <= LSE_ATOL
        ok &= case_ok
        rows.append(dict(what="in_group", variant="bf16", g=g, length=0,
                         err=max(err, lse_err), ok=case_ok))
        say(f"[3i] B1 in-group partial (unified + lse over an empty past, "
            f"the raw group as the cache): G={g}: out max_abs_err={err:.3e} "
            f"lse max_abs_err={lse_err:.3e} {'OK' if case_ok else 'FAIL'}")
    torch.cuda.synchronize()
    return ok, rows


def check_collectives(dev, mesh):
    """The port's collectives (parallel/comm.py) on card tensors over the
    group of all ranks: all_reduce_sum and all_reduce_max of
    rank-distinct f32 rows against their elementwise sum and max, and
    all_gather of bf16, f32 and int8 rows against the ranks' rows put
    together. Returns ok; only rank 0 logs."""
    import torch
    import torch.distributed as dist

    from quickvideo_tpu_torch.parallel import comm

    group, n, r = mesh.group("sp"), mesh.sp, mesh.index("sp")
    # small integers: their f32 sums are exact in any order
    rows = [((torch.arange(4096, device=dev) * (7 + i)) % 97 - 48).float()
            for i in range(n)]
    ok = bool(torch.equal(comm.all_reduce_sum(rows[r].clone(), group),
                          sum(rows[1:], rows[0])))
    ok &= bool(torch.equal(comm.all_reduce_max(rows[r].clone(), group),
                           torch.stack(rows).amax(0)))
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        parts = [(x * 20).to(dtype).reshape(16, 256) for x in rows]
        ok &= bool(torch.equal(comm.all_gather(parts[r], group, dim=-1),
                               torch.cat(parts, dim=-1)))
    if mesh.rank == 0:
        log(f"[3i] all_reduce sum / max and all_gather (bf16, f32, int8) on "
            f"card tensors over {dist.get_backend(group)}, {n} ranks: "
            f"{'OK' if ok else 'FAIL'}")
    return ok


def check_tp_products(dev, mesh):
    """The int8 products of a tp rank at the 7B's widths, over gloo:
    row-split (wo 3584 x 3584, wd 18944 x 3584: the rank's slice of each
    activation row, quantized with the whole row's scale) and
    column-split (wq / wg columns). The row scales and int8 codes must
    equal one device's, the ranks' s32 sums must add up to one device's
    exactly, and the f32 products agree to MESH_PRODUCT_REL_L2 (only the
    order of two f32 partial sums differs). Returns (ok, rows); only rank
    0 logs."""
    import torch

    from quickvideo_tpu_torch.ops import quantization as tq
    from quickvideo_tpu_torch.parallel import comm
    from quickvideo_tpu_torch.parallel.sharding import COL, ROW, shard_leaf

    tp, r, n = mesh.group("tp"), mesh.index("tp"), mesh.tp
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ok, rows = True, []
    for k, cols, rule in ((3584, 3584, ROW), (18944, 3584, ROW),
                          (3584, 3584, COL), (3584, 18944, COL)):
        w = (torch.randn(k, cols, generator=gen, device=dev)
             * 0.02).bfloat16()
        x = torch.randn(256, k, generator=gen, device=dev).bfloat16()
        wq = tq.quantize_weight(w)
        part = shard_leaf(wq, rule, r, n)
        full = tq.qdot(x, wq)
        xq, xs = tq.quantize_act(x)
        acc = tq.int_mm(xq, wq["q8"])
        if rule == ROW:
            span = slice(r * k // n, (r + 1) * k // n)
            xl = x[:, span].contiguous()
            got = comm.all_reduce_sum(tq.qdot(xl, part, group=tp), tp)
            xql, xsl = tq.quantize_act(xl, tp)
            sums = comm.all_reduce_sum(
                tq.int_mm(xql, part["q8"]).double(), tp)
            exact = bool(torch.equal(xsl, xs) and torch.equal(
                xql, xq[:, span]) and torch.equal(sums, acc.double()))
            want = full
        else:
            span = slice(r * cols // n, (r + 1) * cols // n)
            got = tq.qdot(x, part)
            exact = bool(torch.equal(tq.int_mm(xq, part["q8"]),
                                     acc[:, span]))
            want = full[:, span]
        rel = ((got - want).norm() / want.norm()).item()
        case_ok = exact and rel <= MESH_PRODUCT_REL_L2
        ok &= case_ok
        rows.append(dict(what="tp_product", err=rel, ok=case_ok))
        if mesh.rank == 0:
            log(f"[3i] int8 product, {'row' if rule == ROW else 'column'}-"
                f"split over tp={n}, (256 x {k}) @ ({k} x {cols}): scales, "
                f"codes and s32 sums as one device's: {exact}, f32 rel L2 "
                f"{rel:.3e} (limit {MESH_PRODUCT_REL_L2}) "
                f"{'OK' if case_ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok, rows


def check_tp_layer(dev, mesh):
    """One decoder layer of the 7B's width (seeded, drawn whole on every
    rank) at a 256-row group over a 1000-slot past, with key_norms_small
    pruning: this rank's tp shard (layer_step with the mesh) against the
    whole layer on one device, with bf16 and with int8 weights (the
    row-split products act-quantize here, 256 >= 16 rows: each rank must
    quantize its slice of a row with the whole row's scale). Out rel. L2
    within MESH_LAYER_REL_L2 of its dtype and the retained indices agreeing
    on at least RETAINED_AGREE. Returns (ok, rows); only rank 0 logs."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
    from quickvideo_tpu_torch.models.qwen25_vl.language import (
        StepSpec,
        layer_step,
    )
    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append
    from quickvideo_tpu_torch.ops.quantization import quantize_weight
    from quickvideo_tpu_torch.parallel.sharding import shard_language_layer

    t = get_config("qwen25-vl-7b").text
    c, d = t.hidden_size, t.head_dim
    hq, hkv = t.num_attention_heads, t.num_key_value_heads
    tpi, tpn = mesh.index("tp"), mesh.tp
    ok, rows = True, []
    for param_dtype in ("bfloat16", "int8"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)

        def nrm(*shape, std=0.02):
            w = torch.empty(shape, device=dev).normal_(0, std, generator=gen)
            return w.bfloat16()

        lp = {"ln1": nrm(c, std=1.0).abs() + 0.5,
              "ln2": nrm(c, std=1.0).abs() + 0.5,
              "wq": nrm(c, hq * d), "bq": nrm(hq * d, std=0.5),
              "wk": nrm(c, hkv * d), "bk": nrm(hkv * d, std=0.5),
              "wv": nrm(c, hkv * d), "bv": nrm(hkv * d, std=0.5),
              "wo": nrm(hq * d, c), "wg": nrm(c, t.intermediate_size),
              "wu": nrm(c, t.intermediate_size),
              "wd": nrm(t.intermediate_size, c)}
        if param_dtype == "int8":
            for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
                lp[k] = quantize_weight(lp[k])
        part = shard_language_layer(lp, tpi, tpn)
        g, past = 256, 1000
        x = nrm(g, c, std=1.0)
        ang = torch.rand(g, d, generator=gen, device=dev) * 6.28
        cos, sin = ang.cos(), ang.sin()
        pk, pv = nrm(hkv, past, d, std=1.0), nrm(hkv, past, d, std=1.0)
        spec = StepSpec(q_len=g, keep_k=g // 2)
        outs = []
        for lay, heads, m in ((lp, slice(None), None),
                              (part, slice(tpi * hkv // tpn,
                                           (tpi + 1) * hkv // tpn), mesh)):
            cache = init_cache(1, pk[heads].shape[0], 4096, d, device=dev)
            stacked_append(cache, 0, 0, pk[heads], pv[heads])
            cache.lengths[0] = past
            outs.append(layer_step(lay, x, cos, sin, cache, 0, t, spec,
                                   mesh=m))
        (want, want_idx), (got, got_idx) = outs
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        # a key norm within an ulp of its neighbour may order either way
        agree = len(set(got_idx.tolist()) & set(want_idx.tolist())) / (g // 2)
        limit = MESH_LAYER_REL_L2[param_dtype]
        case_ok = rel <= limit and agree >= RETAINED_AGREE
        ok &= case_ok
        rows.append(dict(what="tp_layer", param_dtype=param_dtype, err=rel,
                         ok=case_ok))
        if mesh.rank == 0:
            log(f"[3i] one 7B decoder layer, {param_dtype} weights, tp="
                f"{tpn} shard vs the whole layer (G={g} over {past} slots, "
                f"key_norms_small keeps {g // 2}): out rel L2 {rel:.3e} "
                f"(limit {limit}), retained indices agree "
                f"{agree:.3f} (>= {RETAINED_AGREE}) "
                f"{'OK' if case_ok else 'FAIL'}")
        del lp, part, outs
    torch.cuda.empty_cache()
    return ok, rows


def _mesh_request(dev, run, mesh_rank, work):
    """One MeshRun (tp / sp) on this rank: LVU on the mesh (seeded weights,
    this rank's shard), request 0 of phase 3 through generate twice (the
    second timed and its launches counted), then its prefill and final
    prefill again (logits, retained sets). Returns the rank's record; its
    final-prefill logits go to work/logits-{tag}-{rank}.pt."""
    import torch
    import torch.distributed as dist

    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves

    tag, mesh_kw = run.tag, run.mesh
    param_dtype, kv_dtype = run.param_dtype, run.kv_dtype
    counters = _kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what an earlier run left
    t0 = time.perf_counter()
    trees = []  # the preset path's tree, before the engine's prep
    with (_capture_preset(trees) if run.fast
          else contextlib.nullcontext()):
        lvu = make_lvu(dev, param_dtype, kv_dtype,
                       mesh=MeshConfig(**mesh_kw), model=run.model,
                       layers=run.layers, fast=run.fast)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() - base) / 2**30
    param_bytes = sum(t.nbytes for t in tensor_leaves(lvu.params))
    samples = (fast_samples(trees[0], lvu.model_config, lvu.mesh)
               if run.fast else None)
    del trees
    inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                          seed=0)
    for _ in range(2):  # the second is timed and counted: the first sets up
        dist.barrier()  # the new groups' communicators
        _reset_counters(counters)
        t0 = time.perf_counter()
        res = lvu.engine.generate(inputs, max_new_tokens=8,
                                  eos_token_ids=[lvu.tokenizer.eos_token_id])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counters(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30  # before the checks
    cache, st = lvu.engine.prefill(inputs)
    variant = {"int8": "int8", "int8k": "int8k"}.get(st["kv_dtype"], "bf16")
    want = expected_b1_mesh(lvu, inputs, len(res.tokens), variant,
                            mesh_kw.get("sp", 1))
    b1 = {k: counts[k] for k in counts
          if k.startswith("flash_") and k != "flash" and counts[k]
          and k[6:] not in B1_VARIANTS}
    counts_ok = (b1 == {k: n for k, n in want.items() if n}
                 and counts["flash"] == sum(
                     n for k, n in want.items() if not k.startswith(
                         "flash_kernel")) and counts["vision_2d"] > 0
                 and (param_dtype != "int8" or counts["ln_mlp"] > 0))
    want_len, want_layers = expected_lengths(lvu, inputs, len(res.tokens))
    lens_ok = (res.cache_length == want_len
               and res.layer_lengths == want_layers)
    local_shape = tuple(cache.k.shape)
    torch.save(lvu.engine.final_prefill(cache, st).float().cpu(),
               os.path.join(work, f"logits-{tag}-{mesh_rank}.pt"))
    retained = [[] if i is None else i.tolist() for g in st["retained"]
                for i in g]
    del cache, st, lvu
    gc.collect()  # the LVU, in a cycle: the next run's must fit beside
    torch.cuda.empty_cache()
    return dict(tag=tag, rank=mesh_rank, tokens=res.tokens.tolist(),
                cache_length=res.cache_length,
                kv_cache_bytes=res.kv_cache_bytes,
                layer_lengths=res.layer_lengths, want_len=want_len,
                counts=b1, want=want, counts_ok=counts_ok, lens_ok=lens_ok,
                spans={k: round(v, 4) for k, v in sorted(
                    res.timings.items())},
                wall=wall, decode_ms=1e3 * res.timings["decode"] / max(
                    len(res.tokens) - 1, 1),
                init_s=init_s, resident_gib=resident, peak_gib=peak,
                local_shape=local_shape, retained=retained,
                kv_dtype=variant, param_bytes=param_bytes,
                fast_samples=samples)


def fast_samples(params, cfg, mesh):
    """This rank's part `params` of the preset path's deterministic
    weights, as the preset path made it (before the engine's prep), at
    sampled blocks against the index function's on the CPU: the blocks of
    up to 3 x 7 at the corners of the rank's slice of every leaf of the
    embedding, the final norm, the lm_head, the vision tower's patch
    embedding and merger, of the first and the last vision block, and of
    the rank's first and last decoder layer and the one that holds a
    stacked leaf's index 2^31 (where the JAX package's int32 iota wraps,
    where the rank holds it); every
    int8 scale is 8e-5. Returns (values checked, of them at wrapped
    indices, the blocks that differ)."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.convert import (
        FAST_SCALE,
        fast_codes,
        fast_index,
        fast_values,
    )
    from quickvideo_tpu_torch.ops.quantization import is_quantized
    from quickvideo_tpu_torch.parallel.sharding import (
        COL,
        LAYER_RULES,
        stage_layers,
        stage_of,
    )

    t = cfg.text
    tpi, tpn = (0, 1) if mesh is None else (mesh.index("tp"), mesh.tp)
    held = stage_layers(t.num_hidden_layers, *stage_of(mesh))
    n_values, n_wrapped, bad = 0, 0, []

    def check(name, leaf, rule=None, index=0):
        """The corners of `leaf`, the rank's part of the `index`-th of a
        stacked JAX leaf (tp `rule`; a 1-D leaf as one row)."""
        nonlocal n_values, n_wrapped
        q = leaf["q8"] if is_quantized(leaf) else leaf
        if is_quantized(leaf) and not bool((leaf["sc"] == FAST_SCALE).all()):
            bad.append(f"{name}.sc")
        q = q if q.dim() == 2 else q[None]
        rows, cols = q.shape
        col_split, row_split = rule == COL, rule not in (None, COL)
        r0 = tpi * rows if row_split else 0
        c0 = tpi * cols if col_split else 0
        shape = (rows * tpn if row_split else rows,
                 cols * tpn if col_split else cols)
        offset = index * shape[0] * shape[1]
        for br in sorted({0, max(rows - 3, 0)}):
            for bc in sorted({0, max(cols - 7, 0)}):
                lr = range(br, min(br + 3, rows))
                lc = range(bc, min(bc + 7, cols))
                idx = fast_index(shape, offset, range(r0 + lr.start,
                                                      r0 + lr.stop),
                                 range(c0 + lc.start, c0 + lc.stop))
                want = (fast_codes(idx) if is_quantized(leaf)
                        else fast_values(idx, q.dtype))
                got = q[lr.start:lr.stop, lc.start:lc.stop].cpu()
                flat = (offset + (r0 + torch.arange(lr.start, lr.stop))[
                    :, None] * shape[1] + (c0 + torch.arange(
                        lc.start, lc.stop))[None, :])
                n_values += want.numel()
                n_wrapped += int((flat != idx).sum())
                if not torch.equal(got, want):
                    bad.append(f"{name} [{br}:, {bc}:]")

    lang = params["language"]
    for name in ("embed", "norm", "lm_head"):
        if name in lang:
            check(name, lang[name], COL if name == "lm_head" else None)
    for key in lang["layers"][0] if lang["layers"] else ():
        leaf = lang["layers"][0][key]
        numel = (leaf["q8"] if is_quantized(leaf) else leaf).numel() * (
            tpn if key in LAYER_RULES else 1)
        wrap_layer = 2**31 // numel
        for layer in sorted({held.start, held.stop - 1, wrap_layer}):
            if layer in held:
                check(f"layers[{layer}].{key}",
                      lang["layers"][layer - held.start][key],
                      LAYER_RULES.get(key), layer)
    if "vision" in params:
        vision = params["vision"]
        check("patch_embed", vision["patch_embed"])
        for key, leaf in vision["merger"].items():
            check(f"merger.{key}", leaf)
        depth = len(vision["blocks"])
        for b in sorted({0, depth - 1}):
            for key, leaf in vision["blocks"][b].items():
                check(f"blocks[{b}].{key}", leaf, index=b)
    return n_values, n_wrapped, bad


def _pp_request(dev, run, mesh_rank, work, extras=False):
    """One pipeline-parallel run on this rank: LVU on the mesh (seeded
    weights, this rank's stage: drawn in one device's order, the rest
    dropped), request 0 of phase 3 through generate twice (the second
    timed and its launches counted), its prefill and final prefill again
    (logits, this stage's retained sets, the gathered per-layer lengths),
    the stage's group-step time (its layers alone on the request's second
    group, CUDA events, the stages one after another), and with `extras`
    pp_extras. Returns the rank's record; its final-prefill logits go to
    work/logits-{tag}-{rank}.pt."""
    import torch
    import torch.distributed as dist

    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.models.qwen25_vl.language import (
        StepSpec,
        prefill_step_unrolled,
    )

    tag, param_dtype = run.tag, run.param_dtype
    counters = _kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvu = make_lvu(dev, param_dtype, run.kv_dtype,
                   mesh=MeshConfig(**run.mesh), model=run.model,
                   layers=run.layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2**30
    mesh, eng = lvu.mesh, lvu.engine
    inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                          seed=0)
    for _ in range(2):  # the second is timed and counted: the first sets up
        dist.barrier()  # the links' communicators
        _reset_counters(counters)
        t0 = time.perf_counter()
        res = eng.generate(inputs, max_new_tokens=8,
                           eos_token_ids=[lvu.tokenizer.eos_token_id])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counters(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30  # before the checks
    cache, st = eng.prefill(inputs)
    variant = {"int8": "int8", "int8k": "int8k"}.get(st["kv_dtype"], "bf16")
    one = expected_b1_mesh(lvu, inputs, len(res.tokens), variant, 1)
    stages = mesh.pp
    want = {k: n // stages for k, n in one.items()}
    b1 = {k: counts[k] for k in counts
          if k.startswith("flash_") and k != "flash" and counts[k]
          and k[6:] not in B1_VARIANTS}
    first = mesh.is_first_stage
    counts_ok = (b1 == {k: n for k, n in want.items() if n}
                 and counts["flash"] == sum(
                     n for k, n in want.items()
                     if not k.startswith("flash_kernel"))
                 and (counts["vision_2d"] > 0) == first
                 and (param_dtype != "int8"
                      or (counts["ln_mlp"] > 0) == first))
    want_len, want_layers = expected_lengths(lvu, inputs, len(res.tokens))
    lens_ok = (res.cache_length == want_len
               and res.layer_lengths == want_layers)
    local_shape = tuple(cache.k.shape)
    torch.save(eng.final_prefill(cache, st).float().cpu(),
               os.path.join(work, f"logits-{tag}-{mesh_rank}.pt"))
    retained = [[None if i is None else i.tolist() for i in g]
                for g in st["retained"]]
    # the stage's group step alone: its layers on the second group's rows
    # (random hidden states), appended past the request's rows
    from quickvideo_tpu_torch.config import resolve_effective_top_k

    stack, mcfg = st["pp_stack"], lvu.model_config
    q_len = (int(np.prod(inputs.group_grids[1]))
             // mcfg.vision.spatial_merge_unit)
    x = torch.randn(q_len, mcfg.text.hidden_size, device=dev,
                    dtype=eng.dtype)
    spec = StepSpec(q_len=q_len, keep_k=resolve_effective_top_k(
        lvu.config, 0, mcfg.text.num_hidden_layers, q_len))
    rows = slice(0, q_len)

    def group_step():
        saved = list(cache.lengths)
        prefill_step_unrolled(stack.params, cache, x, st["cos"][rows],
                              st["sin"][rows], mcfg.text,
                              [spec] * len(stack.layers), mesh=mesh,
                              layer0=stack.layer0)
        cache.lengths[:] = saved

    step_ms = None
    for s_ in range(stages):
        dist.barrier()
        if s_ == mesh.stage:
            step_ms = _time_ms(group_step, 3)
    dist.barrier()
    rec = dict(tag=tag, rank=mesh_rank, stage=mesh.stage,
               tokens=res.tokens.tolist(), cache_length=res.cache_length,
               kv_cache_bytes=res.kv_cache_bytes,
               layer_lengths=res.layer_lengths,
               want_len=want_len, counts=b1, want=want, one=one,
               counts_ok=counts_ok, lens_ok=lens_ok,
               spans={k: round(v, 4) for k, v in sorted(
                   res.timings.items())},
               wall=wall, decode_ms=1e3 * res.timings["decode"] / max(
                   len(res.tokens) - 1, 1),
               init_s=init_s, resident_gib=resident, peak_gib=peak,
               local_shape=local_shape, retained=retained,
               layers=[stack.layers.start, stack.layers.stop],
               step_ms=step_ms, step_rows=q_len, kv_dtype=variant)
    del cache, st, stack, x
    if extras:
        rec.update(pp_extras(lvu, inputs))
    del lvu, eng
    gc.collect()  # the LVU, in a cycle: the next run's must fit beside
    torch.cuda.empty_cache()
    return rec


def mesh_runs(world: int, phase: str = "3i", only=None):
    """The runs of a mesh phase: MESH_RUNS (3i) or PP_RUNS (3j) over gloo
    on one card; with `only` (a comma-separated string of tags, as
    `--mesh-cards` passes it, over NCCL or gloo) the runs so tagged of any
    machine's table whose mesh has `world` ranks."""
    if not only:
        return PP_RUNS if phase == "3j" else MESH_RUNS
    return tuple(r for r in tagged_runs(only) if r.world == world)


def run_mesh_rank(dev, rank: int, world: int, work: str,
                  backend: str = "gloo", phase: str = "3i",
                  only=None) -> None:
    """A rank process of a mesh phase (python3 chip_smoke.py --mesh-rank R
    --mesh-dir DIR [--mesh-world W --mesh-backend nccl --mesh-phase 3j]):
    joins the process group at DIR, runs (phase 3i) the collective, CP
    kernel and tp checks (on an sp and a tp mesh of all ranks), then each
    run of mesh_runs (a pp run through _pp_request), and writes its
    records to DIR/rank{R}.json. Any failure raises: the parent fails the
    phase on a non-zero exit."""
    import torch
    import torch.distributed as dist

    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.parallel.mesh import init_multihost, make_mesh

    init_multihost(f"file://{work}/init", world, rank, backend=backend)
    if phase == "3k":  # the server on the mesh
        out = dict(runs=[])
        for i, run in enumerate(serve_runs(world, backend, only)):
            out["runs"].append(_serve_mesh_run(
                dev, run, rank, work, SERVE_IDLE_S if i == 0 else 0))
            dist.barrier()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
        return
    kernels_ok, kernel_rows = True, []
    runs = mesh_runs(world, phase, only)
    # phase 3i's checks are the 7B's: made where a 7B tp / sp run is
    if phase == "3i" and any(r.model == MODEL_7B for r in runs):
        mesh = make_mesh(MeshConfig(sp=world), dev)
        kernels_ok = check_collectives(dev, mesh)
        cp_ok, kernel_rows = check_cp_kernels(dev, mesh)
        tp_mesh = make_mesh(MeshConfig(tp=world), dev)
        prod_ok, prod_rows = check_tp_products(dev, tp_mesh)
        layer_ok, layer_rows = check_tp_layer(dev, tp_mesh)
        kernels_ok &= cp_ok and prod_ok and layer_ok
        kernel_rows += prod_rows + layer_rows
        del mesh
    out = dict(kernels_ok=kernels_ok, kernel_rows=kernel_rows, runs=[])
    for i, run in enumerate(runs):
        if run.mesh.get("pp", 1) > 1:
            out["runs"].append(_pp_request(
                dev, run, rank, work,
                extras=phase == "3j" and not only and i == 0))
        else:
            out["runs"].append(_mesh_request(dev, run, rank, work))
        dist.barrier()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_nccl_one(dev, work: str) -> None:
    """The NCCL run of phase 3i (python3 chip_smoke.py --nccl-one --mesh-dir
    DIR): one rank, NCCL at world size 1. The collectives the port issues
    (all_reduce sum and max, broadcast) run through NCCL on card tensors
    and must return their inputs, then one request through an LVU whose
    process group is that NCCL group (at world size 1 the mesh has no
    axis of more than one rank, so the request itself issues none).
    Writes DIR/nccl.json."""
    import torch
    import torch.distributed as dist

    from quickvideo_tpu_torch.config import MeshConfig

    dist.init_process_group("nccl", init_method=f"file://{work}/nccl-init",
                            world_size=1, rank=0,
                            device_id=torch.device(dev))
    x = torch.arange(4096, dtype=torch.float32, device=dev)
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    z = x.clone()
    dist.all_reduce(z, op=dist.ReduceOp.MAX)
    w = x.clone()
    dist.broadcast(w, src=0)
    coll_ok = bool(torch.equal(x, y) and torch.equal(x, z)
                   and torch.equal(x, w))
    lvu = make_lvu(dev, "bfloat16", "auto", mesh=MeshConfig())
    inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                          seed=0)
    t0 = time.perf_counter()
    res = lvu.engine.generate(inputs, max_new_tokens=8,
                              eos_token_ids=[lvu.tokenizer.eos_token_id])
    torch.cuda.synchronize()
    with open(os.path.join(work, "nccl.json"), "w") as f:
        json.dump(dict(backend=dist.get_backend(), coll_ok=coll_ok,
                       tokens=res.tokens.tolist(),
                       wall=time.perf_counter() - t0), f)
    dist.destroy_process_group()


def _spawn(args, n: int, timeout_s: float, work: str):
    """n copies of this script with `args` ("{r}" standing for the rank),
    their output in files under `work`; waits for all and kills any left
    at the time limit (its code is then None). Returns [(code, output)]."""
    logs = [os.path.join(work, f"out-{time.time_ns()}-{r}.log")
            for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 *[a.format(r=r) for a in args]],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True,
            ))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        timed_out = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, path, late in zip(procs, logs, timed_out):
        with open(path) as f:
            out.append((None if late else p.returncode, f.read()))
    return out


def _mesh_phase(world: int, backend: str, refs: dict, label: str,
                phase: str = "3i", only=None, done=None):
    """Start `world` rank processes of a mesh phase, wait for them, and
    hold each run's records against its reference: one rank's (`refs` by
    MeshRun.ref_key) or an earlier run's, of this call or in `done` (tag ->
    rank 0's record, its logits and mesh; this call's runs are added).
    Returns (ok, kernel rows, each run's records, work dir); a rank that
    fails fails the phase."""
    import torch

    work = tempfile.mkdtemp(prefix="qv-mesh-")
    t0 = time.perf_counter()
    outs = _spawn(["--mesh-rank", "{r}", "--mesh-dir", work, "--mesh-world",
                   str(world), "--mesh-backend", backend, "--mesh-phase",
                   phase] + (["--mesh-runs", only] if only else []), world,
                  MESH_TIMEOUT_S, work)
    phase_s = time.perf_counter() - t0
    records = []
    for r, (rc, out) in enumerate(outs):
        for line in out.splitlines():
            if line.startswith(f"[{phase}]") or rc != 0:
                log(line if line.startswith(f"[{phase}]")
                    else f"[{phase} rank {r}] {line}")
        if rc != 0:
            log(f"[{phase}] rank {r} exited with {rc} (None: killed at "
                f"{MESH_TIMEOUT_S} s; a rank that fails fails the phase) "
                "FAIL")
            return False, [], [], work
        with open(os.path.join(work, f"rank{r}.json")) as f:
            records.append(json.load(f))
    log(f"[{phase}] {world} ranks, {label}: phase {phase_s:.1f} s")
    ok = all(rec["kernels_ok"] for rec in records)
    runs = []
    done = {} if done is None else done
    for i, run in enumerate(mesh_runs(world, phase, only)):
        tag, mesh_kw, param_dtype = run.tag, run.mesh, run.param_dtype
        recs = [rec["runs"][i] for rec in records]
        r0 = recs[0]
        rank_logits = [torch.load(os.path.join(work, f"logits-{tag}-{r}.pt"))
                       for r in range(world)]
        logits = rank_logits[0]
        same_model = [t for t, d in done.items()
                      if (d["model"], d["layers"]) == (run.model, run.layers)]
        done[tag] = dict(r0, logits=logits, model=run.model,
                         layers=run.layers, mesh=mesh_kw,
                         residents=[r["resident_gib"] for r in recs],
                         param_bytes=[r.get("param_bytes") for r in recs])
        what = "one rank"
        if run.against == "one":
            ref = refs[run.ref_key]
        elif run.against == "none":
            ref = None
        elif run.against in done:
            ref, what = done[run.against], run.against
        else:
            log(f"[{phase} {tag}] held against {run.against}, which is not "
                "among this call's runs: not checked FAIL")
            ok = False
            continue
        if mesh_kw.get("pp", 1) > 1:
            ok &= _check_pp_run(phase, tag, mesh_kw, param_dtype, recs, ref,
                                rank_logits, label, what)
            for t in same_model:
                if t != run.against:
                    log(f"[{phase} {tag}] final-prefill logits rel L2 "
                        f"against {t} {_rel_l2(logits, done[t]['logits']):.3e}"
                        " (printed, not asserted)")
            runs.append(recs)
            continue
        agree = all(r["tokens"] == r0["tokens"]
                    and r["retained"] == r0["retained"] for r in recs) and all(
            torch.equal(x, logits) for x in rank_logits)
        vocab = model_config(run.model).text.vocab_size
        valid = (bool(torch.isfinite(logits).all())
                 and logits.shape[-1] == vocab
                 and all(0 <= t < vocab for t in r0["tokens"]))
        run_ok = (agree and valid
                  and all(r["counts_ok"] and r["lens_ok"] for r in recs))
        model = run.model + ("" if run.layers is None
                             else f" at {run.layers} layers")
        if run.fast:
            run_ok &= _check_fast_run(tag, recs, done.get(
                tag.removesuffix("_fast")))
        if ref is None:
            held = "; ".join(
                [f"tokens {r0['tokens']}; final-prefill logits finite, "
                 f"tokens in the vocabulary: {valid}; held against no "
                 "one-rank run (it does not fit one card)"]
                + [f"logits rel L2 against {t} "
                   f"{_rel_l2(logits, done[t]['logits']):.3e} (printed, not "
                   "asserted)" for t in same_model])
        else:
            rel = _rel_l2(logits, ref["logits"])
            limit = (MESH_INT8_LOGITS_REL_L2 if param_dtype == "int8"
                     else MESH_LOGITS_REL_L2)
            run_ok &= rel <= limit
            same = r0["tokens"] == ref["tokens"]
            held = (f"tokens {r0['tokens']} vs {what} {ref['tokens']} "
                    f"({'equal' if same else 'differ'}); final-prefill "
                    f"logits rel L2 {rel:.3e} (limit {limit}); argmax "
                    f"{int(logits.argmax())} vs "
                    f"{int(ref['logits'].argmax())}; {what}'s cache lengths "
                    f"per layer {sorted(set(ref['layer_lengths']))}")
        ok &= run_ok
        log(f"[3i {tag}] {model} {mesh_kw} weights {param_dtype} KV "
            f"{r0['kv_dtype']} ({run.kv_dtype}): {held}; ranks agree on "
            f"tokens, retained indices and logits: {agree}; cache lengths "
            f"per layer {sorted(set(r0['layer_lengths']))} (expected "
            f"{r0['want_len']}) {'OK' if run_ok else 'FAIL'}")
        for r in recs:
            log(f"[3i {tag}] rank {r['rank']}: cache {r['local_shape']} "
                f"B1 launches " + ", ".join(
                    f"{k[6:]} {n}" for k, n in sorted(r["counts"].items()))
                + " (expected " + ", ".join(
                    f"{k[6:]} {n}" for k, n in sorted(r["want"].items())
                    if n) + f") {'OK' if r['counts_ok'] else 'FAIL'}; "
                f"init {r['init_s']:.2f} s, request wall {r['wall']:.3f} s "
                f"({label}), decode {r['decode_ms']:.2f} ms/token, spans(s) "
                f"{r['spans']}, resident {r['resident_gib']:.2f} GiB, peak "
                f"device memory {r['peak_gib']:.2f} GiB")
        runs.append(recs)
    return ok, records[0]["kernel_rows"], runs, work


def _check_fast_run(tag, recs, twin) -> bool:
    """A run on the preset path's deterministic weights: every rank's
    sampled blocks equal the index function's, wrapped indices among them;
    each rank's parameter bytes equal the seeded `twin`'s (where it ran in
    this call; the allocator's resident count beside them, which also
    holds its block rounding, printed)."""
    ok = True
    for r in recs:
        n, wrapped, bad = r["fast_samples"]
        this_ok = not bad and n > 0 and wrapped > 0
        ok &= this_ok
        log(f"[3i {tag}] rank {r['rank']}: {n} sampled weights (at "
            f"{wrapped} wrapped int32 indices) against the index "
            f"function's: {'equal' if not bad else f'differ at {bad[:6]}'} "
            f"{'OK' if this_ok else 'FAIL'}")
    if twin is None:
        log(f"[3i {tag}] its seeded twin did not run in this call: resident "
            "memory not compared")
        return ok
    mine = [r["param_bytes"] for r in recs]
    same = mine == twin["param_bytes"]
    log(f"[3i {tag}] resident parameter bytes per rank {mine} vs the seeded "
        f"run's {twin['param_bytes']} {'OK' if same else 'FAIL'} (allocated "
        f"GiB {[round(r['resident_gib'], 3) for r in recs]} vs "
        f"{[round(x, 3) for x in twin['residents']]}, printed)")
    return ok and same


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _check_pp_run(phase, tag, mesh_kw, param_dtype, recs, ref,
                  rank_logits, label, what="one rank") -> bool:
    """One pipeline run's records (every rank's) against one rank's or an
    earlier run's: tokens, final-prefill logits (bit for bit:
    PP_LOGITS_REL_L2, where the reference splits the heads as the run does,
    one rank's for pp alone, tp = 2's for pp 2 x tp 2; else tp's limits, as
    phase 3i holds tp), the ranks' agreement,
    cache_length, kv_cache_bytes, the per-layer lengths gathered over the
    stages, each stage's retained sets (one rank's at the stage's layers;
    not under tp, whose sums round elsewhere), B1 launches per stage (one
    rank's / pp, and their sum one rank's), and the sampled, streamed and
    scored requests of pp_extras where the run has them. Prints memory
    and walls beside one rank's."""
    import torch

    r0, logits = recs[0], rank_logits[0]
    tp = mesh_kw.get("tp", 1)
    copies = tp * mesh_kw.get("dp", 1)  # ranks that run each stage
    rel = ((logits - ref["logits"]).norm() / ref["logits"].norm()).item()
    exact = torch.equal(logits, ref["logits"])
    # the same arithmetic: the reference splits the heads and the past as
    # the run does (pp moves activations, dp copies them)
    same_sums = ({k: n for k, n in ref.get("mesh", {}).items()
                  if k in ("tp", "sp") and n > 1}
                 == {k: n for k, n in mesh_kw.items()
                     if k in ("tp", "sp") and n > 1})
    if same_sums:
        limit = PP_LOGITS_REL_L2
    else:
        limit = (MESH_INT8_LOGITS_REL_L2 if param_dtype == "int8"
                 else MESH_LOGITS_REL_L2)
    agree = (all(r["tokens"] == r0["tokens"] for r in recs)
             and all(torch.equal(x, logits) for x in rank_logits))
    same = r0["tokens"] == ref["tokens"]
    lens_ok = all(r["lens_ok"] and r["layer_lengths"] == ref["layer_lengths"]
                  and r["cache_length"] == ref["cache_length"]
                  and r["kv_cache_bytes"] == ref["kv_cache_bytes"]
                  for r in recs)
    ret_ok = tp > 1 or all(
        r["retained"] == [g[r["layers"][0]:r["layers"][1]]
                          for g in ref["retained"]] for r in recs)
    total = {}
    for r in recs:
        for k, n in r["counts"].items():
            total[k] = total.get(k, 0) + n
    sum_ok = total == {k: n * copies for k, n in r0["one"].items() if n}
    counts_ok = sum_ok and all(r["counts_ok"] for r in recs)
    run_ok = (agree and rel <= limit and (same or not same_sums) and lens_ok
              and ret_ok and counts_ok)
    log(f"[{phase} {tag}] {mesh_kw} weights {param_dtype} KV "
        f"{r0['kv_dtype']}: tokens {r0['tokens']} vs {what} "
        f"{ref['tokens']} ({'equal' if same else 'differ'}); final-prefill "
        f"logits {'bit for bit equal' if exact else 'differ'}: rel L2 "
        f"{rel:.3e} (limit {limit}), max |diff| "
        f"{(logits - ref['logits']).abs().max().item():.3e}; ranks agree on "
        f"tokens and logits: {agree}; cache_length {r0['cache_length']} "
        f"kv_cache_bytes {r0['kv_cache_bytes']} per-layer lengths "
        f"{sorted(set(r0['layer_lengths']))} ({what} "
        f"{ref['cache_length']}, {ref['kv_cache_bytes']}, "
        f"{sorted(set(ref['layer_lengths']))}): {lens_ok}; retained sets per "
        f"stage as one rank's: {ret_ok if tp == 1 else 'not held under tp'}"
        f"; B1 launches over the stages {total} (one rank x tp x dp "
        f"{ {k: n * copies for k, n in r0['one'].items() if n} }): {sum_ok} "
        f"{'OK' if run_ok else 'FAIL'}")
    for r in recs:
        log(f"[{phase} {tag}] rank {r['rank']} stage {r['stage']} (layers "
            f"{r['layers'][0]}-{r['layers'][1] - 1}): cache "
            f"{r['local_shape']} B1 launches " + ", ".join(
                f"{k[6:]} {n}" for k, n in sorted(r["counts"].items()))
            + f" (one rank / {mesh_kw['pp']}) "
            f"{'OK' if r['counts_ok'] else 'FAIL'}; the stage's group step "
            f"({r['step_rows']} rows over its layers) {r['step_ms']:.4f} ms;"
            f" resident {r['resident_gib']:.2f} GiB, peak "
            f"{r['peak_gib']:.2f} GiB ({what}: {ref['resident_gib']:.2f} /"
            f" {ref['peak_gib']:.2f}); init {r['init_s']:.2f} s; request "
            f"wall {r['wall']:.3f} s, decode {r['decode_ms']:.2f} ms/token "
            f"({what} {ref['wall']:.3f} s, {ref['decode_ms']:.2f} "
            f"ms/token; {label}); spans(s) {r['spans']}")
    if "sampled" in r0:
        extras_ok = all(r["sampled"] == ref["sampled"]
                        and r["chunks"] == ref["chunks"]
                        and r["scores"] == ref["scores"] for r in recs)
        run_ok &= extras_ok
        log(f"[{phase} {tag}] sampled on the card {r0['sampled']} (one rank "
            f"{ref['sampled']}); streamed chunks {r0['chunks']} (one rank "
            f"{ref['chunks']}); scores of {len(PP_SCORE_OPTIONS)} options "
            f"{r0['scores']} (one rank {ref['scores']}); equal on every "
            f"rank: {extras_ok} {'OK' if extras_ok else 'FAIL'}")
    return run_ok


def run_pipeline(dev):
    """Phase 3j: pipeline parallelism over torch.distributed with two
    ranks sharing the one card over gloo (pp = 2, 14 layers per stage),
    request 0 of phase 3 at the full width and depth of qwen25-vl-7b with
    bf16 weights, an int8 KV cache and int8 weights, and the sampled,
    streamed and scored requests, against phase 3's single-rank runs.
    Returns (ok, runs)."""
    ok, _, runs, _ = _mesh_phase(
        MESH_WORLD, "gloo", MAIN_PATH_REFERENCE,
        "gloo on one card: its walls say nothing of NCCL between cards",
        phase="3j")
    return ok and bool(runs), runs


def run_mesh(dev):
    """Phase 3i: tp and sp over torch.distributed with two ranks sharing
    the one card over gloo, at the full width and depth of qwen25-vl-7b
    (seeded bf16 weights, each rank drawing its shard from the same seed),
    against phase 3's single-rank runs; then NCCL at world size 1. Returns
    (ok, kernel rows, runs)."""
    ok, kernel_rows, runs, work = _mesh_phase(
        MESH_WORLD, "gloo", MAIN_PATH_REFERENCE,
        "gloo on one card: its walls say nothing of NCCL between cards")
    if not runs:
        return False, kernel_rows, runs
    (rc, out), = _spawn(["--nccl-one", "--mesh-dir", work], 1, 600, work)
    if rc != 0:
        log(out[-3000:])
        log(f"[3i] NCCL world size 1: exited with {rc} FAIL")
        return False, kernel_rows, runs
    with open(os.path.join(work, "nccl.json")) as f:
        nccl = json.load(f)
    ref = MAIN_PATH_REFERENCE[("bfloat16", "auto")]
    nccl_ok = nccl["coll_ok"] and nccl["tokens"] == ref["tokens"]
    ok &= nccl_ok
    log(f"[3i] NCCL at world size 1 (backend {nccl['backend']}): all_reduce "
        f"sum / max and broadcast on card tensors return their inputs: "
        f"{nccl['coll_ok']}; one request's tokens {nccl['tokens']} vs one "
        f"rank's {ref['tokens']}, wall {nccl['wall']:.3f} s "
        f"{'OK' if nccl_ok else 'FAIL'}")
    return ok, kernel_rows, runs


def run_card_mesh(dev, only=None, one_card=False) -> bool:
    """`--mesh-cards [--mesh-runs TAGS] [--one-card]`: with NCCL, one rank
    per card (2 or 4 cards), the runs of CARD_MESH_RUNS[cards], or those
    tagged in `only` from any machine's table whose mesh fits the cards,
    grouped by their number of ranks (one process group each, on the first
    cards; the smaller groups first), after phase 3i's checks where a 7B
    run other than a pipeline one is among them, each against its
    reference (MeshRun.against: one rank's run of request 0 on card 0,
    seeded weights as phase 3 runs it, or an earlier run); then the server
    runs of CARD_SERVE_RUNS[cards] tagged in `only` (`serve`: every one of
    them), phase 3k's checks over NCCL. With `one_card`, the tagged mesh
    runs of up to 4 ranks as gloo ranks sharing card 0 (no server runs):
    the same checks, walls that say nothing of NCCL."""
    import torch

    world = 4 if one_card else torch.cuda.device_count()
    if world not in CARD_MESH_RUNS or (one_card and not only):
        log(f"--mesh-cards: {world} card(s); it runs on "
            f"{sorted(CARD_MESH_RUNS)}, and with --one-card the runs of "
            "--mesh-runs FAIL")
        return False
    if only is None:
        runs, serve = CARD_MESH_RUNS[world], ()
    else:
        tags = only.split(",")
        runs = tuple(r for r in tagged_runs(only) if r.world <= world)
        serve = () if one_card else tuple(
            r for r in CARD_SERVE_RUNS[world]
            if r.tag in tags or "serve" in tags)
        unknown = (set(tags) - {"serve"} - {r.tag for r in runs + serve})
        if unknown or not (runs or serve):
            log(f"--mesh-runs {only}: no run of {world} cards has the tags "
                f"{sorted(unknown)} FAIL")
            return False
    ok = True
    refs = {}
    for run in runs:
        if run.against != "one" or run.ref_key in refs:
            continue
        gc.collect()  # the previous reference's LVU, in a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lvu = make_lvu(dev, run.param_dtype, run.kv_dtype, model=run.model,
                       layers=run.layers)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        inputs = make_request(lvu.model_config, lvu.tokenizer, QUESTIONS[0],
                              seed=0)
        lvu.engine.generate(inputs, max_new_tokens=8,
                            eos_token_ids=[lvu.tokenizer.eos_token_id])
        # the second run is timed (reference_record)
        ref = reference_record(lvu, inputs, resident,
                               torch.cuda.max_memory_allocated() / 2**30)
        refs[run.ref_key] = ref
        log(f"[3i one rank] {run.model}"
            f"{'' if run.layers is None else f' at {run.layers} layers'} "
            f"weights {run.param_dtype} KV {run.kv_dtype}: tokens "
            f"{ref['tokens']}, request wall {ref['wall']:.3f} s (its second "
            f"run), decode {ref['decode_ms']:.2f} ms/token, resident "
            f"{resident:.2f} GiB, peak {ref['peak_gib']:.2f} GiB")
        del lvu
        gc.collect()
        torch.cuda.empty_cache()
    backend, done = ("gloo" if one_card else "nccl"), {}
    for size in sorted({r.world for r in runs}):
        group = [r for r in runs if r.world == size]
        pp_only = all(r.mesh.get("pp", 1) > 1 for r in group)
        label = (f"gloo, {size} ranks on one card: its walls say nothing of "
                 "NCCL between cards" if one_card
                 else f"NCCL across {size} cards")
        group_ok, _, recs, _ = _mesh_phase(
            size, backend, refs, label, "3j" if pp_only else "3i",
            ",".join(r.tag for r in group), done)
        ok &= group_ok and bool(recs)
    if serve:  # phase 3k's server checks over NCCL
        serve_ok, done = _serve_mesh_phase(dev, None, world, "nccl", serve,
                                           f"NCCL across {world} cards")
        ok &= serve_ok and bool(done)
    return ok


# -- phase 3k: the HTTP server on a mesh ---------------------------------------

# the runs of phase 3k (two gloo ranks sharing the card): (tag, mesh axes),
# bf16 weights, phase 3f's seeded 64-frame videos; `--mesh-cards --mesh-runs
# serve` makes CARD_SERVE_RUNS[cards] over NCCL, one rank per card
class ServeRun(NamedTuple):
    """One run of phase 3k: the HTTP server over the mesh `mesh`, bf16
    seeded weights of the preset `model`."""

    tag: str
    mesh: dict
    model: str = MODEL_7B


SERVE_MESH_RUNS = (ServeRun("tp2", {"tp": 2}), ServeRun("pp2", {"pp": 2}))
CARD_SERVE_RUNS = {
    2: SERVE_MESH_RUNS,
    4: (ServeRun("dp2_tp2", {"dp": 2, "tp": 2}),
        ServeRun("dp2_pp2", {"dp": 2, "pp": 2}),
        ServeRun("pp2_tp2", {"pp": 2, "tp": 2}),
        # the 72B at its 80 layers over tp = 4 (bf16 weights, "auto" KV:
        # int8, ROADMAP C26)
        ServeRun("72b_serve_tp4", {"tp": 4}, MODEL_72B)),
}


def serve_runs(world: int, backend: str, only=None):
    """The runs of phase 3k: SERVE_MESH_RUNS over gloo on one card, or
    CARD_SERVE_RUNS[world] over NCCL, those tagged in `only` unless it
    holds `serve` or is not given."""
    if backend == "gloo":
        return SERVE_MESH_RUNS
    tags = (only or "serve").split(",")
    return tuple(r for r in CARD_SERVE_RUNS[world]
                 if r.tag in tags or "serve" in tags)
# lowered for the phase: a follower waits for its next job at most
# SERVE_CONTROL_TIMEOUT_S (parallel/mesh.py CONTROL_TIMEOUT_S), the
# leader's heartbeat comes every SERVE_HEARTBEAT_S (serving/server.py
# HEARTBEAT_S), and the first run's leader idles SERVE_IDLE_S once
SERVE_CONTROL_TIMEOUT_S = 5.0
SERVE_HEARTBEAT_S = 1.0
SERVE_IDLE_S = 7.0
SERVE_MESH_TIMEOUT_S = 600
SERVE_B1 = ("flash",) + tuple(f"flash_kernel_{k}" for k in B1_KERNELS)


def _b1_counts(counts):
    return {k: counts[k] for k in SERVE_B1}


def _add_counts(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def _log_jobs(server, counters, jobs):
    """Record each job this rank's server dispatches: its kind, payloads,
    wall and B1 launches (every rank dispatches the same jobs in the same
    order, so the leader's job indices name the followers' too)."""
    import torch

    dispatch = server._dispatch

    def logged(batch):
        torch.cuda.synchronize()
        before = _read_counters(counters)
        t0 = time.perf_counter()
        try:
            dispatch(batch)
        finally:
            torch.cuda.synchronize()
            after = _read_counters(counters)
            jobs.append(dict(kind=batch[0].kind, n=len(batch),
                             wall=time.perf_counter() - t0,
                             b1={k: after[k] - before[k] for k in SERVE_B1}))

    server._dispatch = logged


def _serve_mesh_client(base, server, lvu, video, other, jobs, idle_s):
    """The leader's requests of phase 3k, from its own HTTP clients while
    its worker serves them (and every follower follows): a burst of
    BATCH_QUESTIONS behind the paused worker, one SSE stream, and under pp
    a session refused; otherwise two sessions with one spill and resume,
    then (idle_s) an idle gap beyond the control timeout, then
    /v1/chat/completions with a video_url part. Returns what it saw."""
    import threading

    out = {}
    questions = BATCH_QUESTIONS
    server.pause()
    got = {}

    def ask(i):
        got[i] = _http(base, "/v1/generate", {
            "video": video, "question": questions[i], "max_new_tokens": 8})

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(questions))]
    for t in threads:
        t.start()
    for _ in range(600):
        if server._q.qsize() >= len(questions) - 1:
            break
        time.sleep(0.05)
    time.sleep(0.2)
    i0, t0 = len(jobs), time.perf_counter()
    server.resume()
    for t in threads:
        t.join(timeout=900)
    out["burst"] = dict(
        wall=time.perf_counter() - t0, jobs=[i0, len(jobs)],
        codes=[got[i][0] for i in range(len(questions))],
        answers=[got[i][1].get("answer") for i in range(len(questions))],
        batches=dict(_http(base, "/v1/stats")[1]["batches"]))
    status, ctype, frames, done = _sse(base, "/v1/generate", {
        "video": video, "question": questions[1], "max_new_tokens": 8})
    out["stream"] = dict(
        status=status, ctype=ctype, done=done, frames=len(frames),
        joined="".join(f["delta"] for f in frames if "delta" in f),
        final=[f["answer"] for f in frames if "answer" in f])
    if lvu.mesh.pp > 1:
        out["session_refused"] = _http(base, "/v1/sessions", {"video": video})
        return out
    # session 1 asks, session 2's creation spills it (max_resident_sessions
    # = 1), its next ask resumes it from the file
    q1, q2 = SESSION_QUESTIONS[:2]
    code1, s1 = _http(base, "/v1/sessions", {"video": video})
    sid1 = s1.get("session_id")
    code2, a1 = _http(base, f"/v1/sessions/{sid1}/ask",
                      {"question": q1, "max_new_tokens": 8})
    t0 = time.perf_counter()
    code3, s2 = _http(base, "/v1/sessions", {"video": other})
    spill_wall = time.perf_counter() - t0
    spill_files = sorted(os.listdir(server.spill_dir))
    t0 = time.perf_counter()
    code4, a2 = _http(base, f"/v1/sessions/{sid1}/ask",
                      {"question": q2, "max_new_tokens": 8})
    resume_wall = time.perf_counter() - t0
    stats = _http(base, "/v1/stats")[1]
    closed = [_http(base, f"/v1/sessions/{sid}", method="DELETE")[0]
              for sid in (sid1, s2.get("session_id"))]
    out["sessions"] = dict(
        codes=[code1, code2, code3, code4] + closed,
        answers=[a1.get("answer"), a2.get("answer")],
        spills=stats["spills"], resumes=stats["resumes"],
        spill_wall=spill_wall, resume_wall=resume_wall,
        spill_files=spill_files)
    if idle_s:  # the next request comes after an idle gap
        time.sleep(idle_s)
        out["idle_s"] = idle_s
    code, body = _http(base, "/v1/chat/completions", {
        "model": lvu.config.model_name_or_path, "max_tokens": 8,
        "messages": [{
            "role": "user", "content": [
                {"type": "video_url", "video_url": {"url": f"file://{video}"}},
                {"type": "text", "text": questions[0]}]}]})
    out["chat"] = dict(code=code, object=body.get("object"), content=(
        body.get("choices") or [{}])[0].get("message", {}).get("content"))
    return out


def _serve_mesh_run(dev, run, rank, work, idle_s):
    """One run of phase 3k on this rank: the LVU on the mesh (seeded
    bf16 weights, this rank's part), its direct calls (BATCH_QUESTIONS by
    LVU.generate; without pp a live session's two turns), then
    make_http_server: the leader serves _serve_mesh_client's requests, a
    follower follows until the leader's shutdown. Returns the rank's
    record, with the B1 launches the served burst must make on this rank:
    under pp the direct calls' (served one by one), otherwise the
    micro-batch's from its rows (the groups once, then each question's
    suffix and decode steps, as phase 3g counts them)."""
    import threading

    import torch

    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.parallel import mesh as tmesh
    from quickvideo_tpu_torch.serving import server as tserver

    tag, mesh_kw, model = run.tag, run.mesh, run.model
    tmesh.CONTROL_TIMEOUT_S = SERVE_CONTROL_TIMEOUT_S
    tserver.HEARTBEAT_S = SERVE_HEARTBEAT_S
    video, other = (os.path.join(work, n) for n in ("serve.mp4", "other.mp4"))
    counters = _kernel_counters()
    run = _Run(counters)
    torch.cuda.reset_peak_memory_stats()
    with seeded_videos():
        lvu = _spelled(make_lvu(
            dev, "bfloat16", mesh=MeshConfig(**mesh_kw), model=model,
            extra_kwargs={"max_pixels": FRAME_HW * FRAME_HW}))
        torch.cuda.synchronize()
        rec = dict(tag=tag, rank=rank, stage=lvu.mesh.stage,
                   resident_gib=torch.cuda.memory_allocated() / 2**30)
        peak = torch.cuda.max_memory_allocated() / 2**30
        direct, counts, wall, n_tok = [], {}, 0.0, []
        for q in BATCH_QUESTIONS:
            direct.append(run(lvu.generate, q, video, max_new_tokens=8)[0])
            n_tok.append(len(lvu.last_result.tokens))
            _add_counts(counts, _b1_counts(run.counts))
            wall, peak = wall + run.wall, max(peak, run.peak)
        rec.update(direct=direct, direct_b1=counts, direct_wall=wall)
        if lvu.mesh.pp == 1:
            n = lvu.model_config.text.num_hidden_layers
            steps = list(_video_request_rows(lvu, BATCH_QUESTIONS[0],
                                             video)[0])
            for q, k in zip(BATCH_QUESTIONS, n_tok):
                steps += ([_video_request_rows(lvu, q, video)[1]] * n
                          + [1] * ((k - 1) * n))
            live = lvu.start_chat(video)
            rec["live"] = [live.ask(q, max_new_tokens=8)
                           for q in SESSION_QUESTIONS[:2]]
            # the cache "auto" resolved to for this video (the 72B's:
            # int8, ROADMAP C26)
            variant = {False: "bf16", True: "int8", "k": "int8k"}[
                live._cache.quantized]
            want = b1_kernels(lvu, steps, variant)
            rec["burst_want_b1"] = dict(want, flash=sum(want.values()))
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            del live
        else:
            rec["burst_want_b1"] = counts
        cfg = tserver.ServerConfig(
            port=0, spill_dir=os.path.join(work, f"spill-{tag}"),
            max_resident_sessions=1, default_max_new_tokens=8,
            request_timeout_s=900)
        httpd, server = tserver.make_http_server(lvu, cfg)
        jobs = []
        _log_jobs(server, counters, jobs)
        rec["leader"] = server.is_leader
        if server.is_leader:
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                rec.update(_serve_mesh_client(base, server, lvu, video, other,
                                              jobs, idle_s))
            finally:
                httpd.shutdown()
                server.shutdown()
                httpd.server_close()
            rec["worker_alive"] = server._worker.is_alive()
        else:
            httpd.serve_forever()  # returns at the leader's stop
            server.shutdown()
        torch.cuda.synchronize()
        rec.update(jobs=jobs, stats=server.stats, peak_gib=max(
            peak, torch.cuda.max_memory_allocated() / 2**30))
    del lvu, server, httpd
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _serve_lines(tag, mesh_kw, recs, one_rank, label):
    """Phase 3k's checks of one run, every rank's record against the
    leader's requests; prints them. Returns ok."""
    lead = next(r for r in recs if r["leader"])
    pp = mesh_kw.get("pp", 1) > 1
    ok = True

    def line(what, this_ok):
        nonlocal ok
        ok &= bool(this_ok)
        log(f"[3k {tag}] {what} {'OK' if this_ok else 'FAIL'}")

    agree = all(r["direct"] == lead["direct"] for r in recs)
    burst = lead["burst"]
    i0, i1 = burst["jobs"]
    served = [_add_counts({}, {}) for _ in recs]
    for r, total in zip(recs, served):
        for job in r["jobs"][i0:i1]:
            _add_counts(total, job["b1"])
    n = len(BATCH_QUESTIONS)
    # the leader drains the burst into one job of n payloads on every rank
    same_jobs = all([(j["kind"], j["n"]) for j in r["jobs"][i0:i1]]
                    == [("generate", n)] for r in recs)
    want_b1 = [r["burst_want_b1"] for r in recs]
    if pp:
        # served one by one: launches as the n direct generate calls'; one
        # rank's answers bit for bit where no tp changes the sums
        exact = burst["answers"] == one_rank
        answers_ok = (burst["answers"] == lead["direct"]
                      and (exact or mesh_kw.get("tp", 1) > 1))
        what = (f"one by one (BatchedQAEngine refused under pp, C23): "
                f"answers {burst['answers']} vs one rank's {one_rank} "
                f"(bit for bit {exact})")
    else:
        answers_ok = burst["answers"] == lead["direct"]
        what = (f"as one micro-batch on every rank: answers "
                f"{burst['answers']} vs the mesh's {n} direct LVU.generate "
                f"calls {lead['direct']}")
    line(f"burst of {n} /v1/generate on one video {what}; statuses "
         f"{burst['codes']}; batch histogram {burst['batches']}; every rank "
         f"ran the same jobs {same_jobs}; direct answers agree over the "
         f"ranks {agree}", answers_ok and agree and same_jobs
         and burst["codes"] == [200] * n and burst["batches"] == {str(n): 1})
    for r, got, want in zip(recs, served, want_b1):
        line(f"rank {r['rank']} (stage {r['stage']}): B1 launches of the "
             f"served burst {_kern({k: got.get(k, 0) for k in SERVE_B1[1:]})}"
             f", flash {got.get('flash', 0)}, vs the direct calls' "
             f"{_kern({k: want[k] for k in SERVE_B1[1:]})}, flash "
             f"{want['flash']} ("
             + ("measured on the direct calls" if pp
                else "the micro-batch's rows") + ")",
             got == want and want["flash"] > 0)
    log(f"[3k {tag}] walls ({label}): served burst {burst['wall']:.4f} s vs "
        f"{lead['direct_wall']:.4f} s for the {n} direct LVU.generate calls;"
        f" memory per rank "
        + "; ".join(f"rank {r['rank']} resident {r['resident_gib']:.2f} GiB "
                    f"peak {r['peak_gib']:.2f} GiB" for r in recs))
    st = lead["stream"]
    line(f"SSE on /v1/generate: {st['frames']} frames joining to "
         f"{st['joined']} vs the unstreamed {lead['direct'][1]}",
         st["status"] == 200 and st["done"]
         and st["ctype"] == "text/event-stream"
         and st["joined"] == lead["direct"][1]
         and st["final"] == [lead["direct"][1]])
    if pp:
        code, body = lead["session_refused"]
        line(f"/v1/sessions refused on every rank: HTTP {code} "
             f"{body.get('error')!r}", code == 500
             and "chat sessions do not support pipeline parallelism"
             in body.get("error", ""))
    else:
        ss = lead["sessions"]
        line(f"two sessions, max_resident_sessions=1: session 1's answers "
             f"{ss['answers']} vs a session that never spilled "
             f"{lead['live']}; statuses {ss['codes']}; spills {ss['spills']}"
             f", resumes {ss['resumes']}; session 2's creation (spilling "
             f"session 1: a gather and one .npz, {ss['spill_files']}) "
             f"{ss['spill_wall']:.4f} s, session 1's resumed ask "
             f"{ss['resume_wall']:.4f} s",
             ss["answers"] == lead["live"]
             and all(r["live"] == lead["live"] for r in recs)
             and ss["codes"] == [200] * 6 and ss["spills"] >= 1
             and ss["resumes"] >= 1 and len(ss["spill_files"]) == 1)
        ch = lead["chat"]
        idle = (f"after {lead['idle_s']} s idle (control timeout lowered to "
                f"{SERVE_CONTROL_TIMEOUT_S} s, heartbeat every "
                f"{SERVE_HEARTBEAT_S} s) " if "idle_s" in lead else "")
        line(f"{idle}/v1/chat/completions with a video_url part: HTTP "
             f"{ch['code']} {ch['content']} vs {lead['direct'][0]}",
             ch["code"] == 200 and ch["object"] == "chat.completion"
             and ch["content"] == lead["direct"][0])
    keys = ("requests", "errors", "spills", "resumes")
    line("every follower ran every job: " + "; ".join(
        f"rank {r['rank']} {[r['stats'][k] for k in keys]}" for r in recs)
        + f" ({'/'.join(keys)}); the leader's worker ended: "
        f"{not lead['worker_alive']}",
        all([r["stats"][k] for k in keys] == [lead["stats"][k] for k in keys]
            and len(r["jobs"]) == len(lead["jobs"]) for r in recs)
        and not lead["worker_alive"])
    return ok


def _serve_mesh_phase(dev, params, world, backend, runs, label):
    """Start `world` rank processes of phase 3k (or of `--mesh-cards
    --mesh-runs serve`), hold each run against its checks and, under pp,
    against one rank's answers (the bf16 weights `params` on this
    process's card). Returns (ok, each run's records)."""
    import torch

    work = tempfile.mkdtemp(prefix="qv-serve-")
    for name in ("serve.mp4", "other.mp4"):  # the routes check paths exist
        open(os.path.join(work, name), "wb").close()
    video = os.path.join(work, "serve.mp4")
    one_rank = None
    if any(r.mesh.get("pp", 1) > 1 for r in runs):  # the 7B's
        with seeded_videos():
            one = _spelled(_path_lvu(dev, params))
            one_rank = [one.generate(q, video, max_new_tokens=8)[0]
                        for q in BATCH_QUESTIONS]
            del one
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = ["--mesh-rank", "{r}", "--mesh-dir", work, "--mesh-world",
            str(world), "--mesh-backend", backend, "--mesh-phase", "3k"]
    if backend != "gloo":
        args += ["--mesh-runs", ",".join(r.tag for r in runs)]
    done = _spawn(args, world, SERVE_MESH_TIMEOUT_S, work)
    phase_s = time.perf_counter() - t0
    records = []
    for r, (rc, out) in enumerate(done):
        if rc != 0:
            log(out[-3000:])
            log(f"[3k] rank {r} exited with {rc} (None: killed at "
                f"{SERVE_MESH_TIMEOUT_S} s; every rank must exit 0 after "
                "the leader's shutdown) FAIL")
            return False, []
        with open(os.path.join(work, f"rank{r}.json")) as f:
            records.append(json.load(f))
    log(f"[3k] {world} ranks ({label}) exited 0 after shutdown: phase "
        f"{phase_s:.1f} s")
    ok, done_runs = True, []
    for i, run in enumerate(runs):
        recs = [rec["runs"][i] for rec in records]
        ok &= _serve_lines(run.tag, run.mesh, recs, one_rank, label)
        done_runs.append(recs)
    return ok, done_runs


def run_serving_mesh(dev, params):
    """Phase 3k: the HTTP server over two gloo ranks sharing the card (tp =
    2, then pp = 2) on the 7B at full width and depth, bf16 weights
    `params` for the one-rank answers. Returns (ok, each run's records)."""
    return _serve_mesh_phase(
        dev, params, MESH_WORLD, "gloo", SERVE_MESH_RUNS,
        "gloo on one card: its walls say nothing of NCCL between cards")


# -- phase 3l: the other two model sizes --------------------------------------

# (preset, decoder layers (None: all of them), param_dtype, kv_cache_dtype,
# the cache variant B1 must run: "auto" resolves to bf16 for the 64-frame
# request on one card, the 72B's 8 layers counted as the whole model)
SIZE_RUNS = (
    ("qwen25-vl-3b", None, "bfloat16", "auto", "bf16"),
    ("qwen25-vl-3b", None, "int8", "auto", "bf16"),
    ("qwen25-vl-3b", None, "bfloat16", "int8", "int8"),
    ("qwen25-vl-72b", 8, "bfloat16", "auto", "bf16"),
    ("qwen25-vl-72b", 8, "int8", "auto", "bf16"),
    ("qwen25-vl-72b", 8, "bfloat16", "int8", "int8"),
)


def _counted_request(lvu, tag, param_dtype, variant, counters, base,
                     init_s, resident):
    """Request 0 of phase 3 twice through LVUEngine.generate on `lvu`, the
    second timed and counted: B1 launches per variant, mode and kernel
    against the config's rules (B3 / B4 launched with int8 weights), cache
    lengths per layer, tokens in the vocabulary, the cache the request
    resolved to (B1 `variant`), finite final-prefill logits; logged beside
    the init wall and resident memory (GiB above `base`). Returns (ok, the
    counted request's launch counts)."""
    import torch

    from quickvideo_tpu_torch.prefill.engine import tensor_leaves

    n_params = sum(t.numel() for t in tensor_leaves(lvu.params))
    mcfg = lvu.model_config
    inputs = make_request(mcfg, lvu.tokenizer, QUESTIONS[0], seed=0)
    walls = []
    for _ in range(2):  # the second is timed and counted
        _reset_counters(counters)
        t0 = time.perf_counter()
        res = lvu.engine.generate(
            inputs, max_new_tokens=8,
            eos_token_ids=[lvu.tokenizer.eos_token_id])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = _read_counters(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    n = len(res.tokens)
    want = expected_b1(lvu, inputs, n, variant)
    want.update(expected_kernels(lvu, inputs, n, variant))
    counts_ok = (
        {k: counts[k] for k in want} == want
        and counts["flash"] == counts[f"flash_{variant}"] == sum(
            c for k, c in want.items() if not k.startswith("flash_kernel"))
        and counts["vision_2d"] > 0
        and (param_dtype != "int8"
             or min(counts["ln_gemm"], counts["ln_mlp"]) > 0))
    want_len, want_layers = expected_lengths(lvu, inputs, n)
    lens_ok = (res.cache_length == want_len
               and res.layer_lengths == want_layers)
    vocab = mcfg.text.vocab_size
    toks_ok = bool(n >= 1 and ((res.tokens >= 0)
                               & (res.tokens < vocab)).all())
    cache, st = lvu.engine.prefill(inputs)
    logits = lvu.engine.final_prefill(cache, st).float()
    cache_ok = (cache.quantized is (variant == "int8")
                and st["kv_dtype"] == ("int8" if variant == "int8"
                                       else "bfloat16"))
    finite = bool(torch.isfinite(logits).all()
                  and logits.shape[-1] == vocab)
    run_ok = counts_ok and lens_ok and toks_ok and cache_ok and finite
    t = mcfg.text
    log(f"{tag} {t.num_hidden_layers} layers, hidden {t.hidden_size}, "
        f"heads {t.num_attention_heads} / {t.num_key_value_heads}: init "
        f"{init_s:.2f} s, {n_params / 1e9:.3f} B parameter values, "
        f"resident {resident:.2f} GiB, peak {peak:.2f} GiB; request wall "
        f"{walls[0]:.3f} s then {walls[1]:.3f} s (timed); decode "
        f"{1e3 * res.timings['decode'] / max(n - 1, 1):.2f} ms/token; "
        f"tokens {res.tokens.tolist()} {toks_ok}; cache "
        f"{st['kv_dtype']} (B1 {variant}) {cache_ok}; cache_length "
        f"{res.cache_length} (expected {want_len}), per-layer "
        f"{sorted(set(res.layer_lengths))} {lens_ok}; final-prefill "
        f"logits finite over {vocab} {finite}; B1 launches "
        + ", ".join(f"{k[6:]} {counts[k]}" for k in sorted(want)
                    if want[k] or counts[k])
        + f" (expected " + ", ".join(f"{k[6:]} {c}" for k, c in
                                     sorted(want.items()) if c)
        + f") {counts_ok}; spans(s) "
        f"{ {k: round(v, 4) for k, v in sorted(res.timings.items())} } "
        f"{'OK' if run_ok else 'FAIL'}")
    return run_ok, counts


def run_sizes(dev):
    """Phase 3l: qwen25-vl-3b at full width and depth, and qwen25-vl-72b at
    full width and 8 of its 80 layers (seeded weights, one card), each with
    bf16 weights, int8 weights and an int8 KV cache: request 0 of phase 3
    twice through LVUEngine.generate, the second timed and counted
    (_counted_request); init wall, parameter count, resident and peak
    memory. Returns (ok, each counted request's launch counts)."""
    import torch

    counters = _kernel_counters()
    ok, runs = True, []
    t_phase = time.perf_counter()
    for model, layers, param_dtype, kv_dtype, variant in SIZE_RUNS:
        tag = (f"[3l {model}{'' if layers is None else f', {layers} layers'}"
               f", {param_dtype} weights, {kv_dtype} KV]")
        gc.collect()  # the previous run's LVU, in a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        lvu = make_lvu(dev, param_dtype, kv_dtype, model=model,
                       layers=layers)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated() / 2**30 - base
        run_ok, counts = _counted_request(lvu, tag, param_dtype, variant,
                                          counters, base, init_s, resident)
        ok &= run_ok
        runs.append(counts)
        del lvu
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[3l] phase {time.perf_counter() - t_phase:.1f} s")
    return ok, runs


# -- phase 3m: the preset path's deterministic weights -------------------------

# (preset, param_dtype), "auto" KV (bf16 for the 64-frame request on one
# card): first the 7B with int8 weights, bench.py:36-39's configuration,
# which the port's bench is to run through its checkpoint-less LVU
FAST_RUNS = (
    (MODEL_7B, "int8"),
    (MODEL_7B, "bfloat16"),
    ("qwen25-vl-3b", "bfloat16"),
)


def _capture_preset(trees: list):
    """A context inside which the port's preset path runs as it is, each
    tree it makes appended to `trees` (the tree before the engine's weight
    prep, which builds its own beside an int8 tower)."""
    from unittest import mock

    from quickvideo_tpu_torch import api

    preset = api.preset_params

    def capture(*args):
        trees.append(preset(*args))
        return trees[-1]

    return mock.patch.object(api, "preset_params", capture)


def _fast_whole(dev, tree, cfg, int8):
    """The leaves of a one-card preset tree (before the engine's prep)
    against the JAX package's, each computed whole on the card as the JAX
    package computes it: a flat int32 iota over the JAX leaf's shape,
    stacked leaves from their layer's offset (model.py::init_params_fast,
    quantization.py::init_params_fast_quantized), compared in the JAX
    layout, so that a slip of the port's layouts, offsets or chunks shows.
    Returns (leaves, values, the paths that differ or are missing, and a
    count of extra leaves)."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.convert import (
        FAST_MATMUL_KEYS,
        FAST_SCALE,
        leaf_shapes,
    )
    from quickvideo_tpu_torch.ops.quantization import is_quantized
    from quickvideo_tpu_torch.testing import leaf_items

    t, v = cfg.text, cfg.vision
    layer, block, merger = leaf_shapes(cfg)
    want = [(("language", "embed"), (t.vocab_size, t.hidden_size), 0)]
    want += [(("language", "layers", li, k), s, li * int(np.prod(s)))
             for li in range(t.num_hidden_layers) for k, s in layer.items()]
    want += [(("language", "norm"), (t.hidden_size,), 0),
             (("language", "lm_head"), (t.hidden_size, t.vocab_size), 0),
             (("vision", "patch_embed"), (v.patch_input_dim, v.hidden_size),
              0)]
    want += [(("vision", "blocks", b, k), s, b * int(np.prod(s)))
             for b in range(v.depth) for k, s in block.items()]
    want += [(("vision", "merger", k), s, 0) for k, s in merger.items()]
    n_leaves, n_values, bad = 0, 0, []
    for path, shape, offset in want:
        name = "/".join(map(str, path))
        leaf = tree
        for p in path:
            leaf = leaf[p] if leaf is not None and (
                p in leaf if isinstance(leaf, dict) else p < len(leaf)) \
                else None
        if leaf is None:
            bad.append(f"{name} (missing)")
            continue
        i = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                         device=dev).add_(offset).to(torch.int32).view(shape)
        if int8 and (path[-1] == "embed" or path[-1] in FAST_MATMUL_KEYS):
            if not is_quantized(leaf):
                bad.append(f"{name} (not int8)")
                continue
            n_sc = shape[0] if path[-1] == "embed" else shape[1]
            pairs = ((leaf["q8"], (i % 255 - 127).to(torch.int8)),
                     (leaf["sc"], torch.full((n_sc,), FAST_SCALE,
                                             dtype=torch.float32,
                                             device=dev)))
        else:
            f32 = ((i % 17 - 8).to(torch.float32)
                   * torch.full((), 0.01, dtype=torch.float32, device=dev))
            pairs = ((leaf, f32.to(torch.bfloat16)),)
            del f32
        del i
        for got, exp in pairs:
            n_leaves += 1
            n_values += exp.numel()
            if (got.dtype, got.shape) != (exp.dtype, exp.shape) or (
                    not torch.equal(got, exp)):
                bad.append(name)
        del pairs
    extra = sum(1 for _ in leaf_items(tree)) - n_leaves
    return n_leaves, n_values, bad, extra


def run_fast_init(dev):
    """Phase 3m: the LVU of a preset name without a checkpoint, as
    bench.py builds it (the JAX package's deterministic weights, made on
    the card from their indices), for each of FAST_RUNS at full width and
    depth: every leaf the preset path made equals, bit for bit, the JAX
    leaf computed whole on the card (_fast_whole), and at sampled blocks
    of every leaf the index function's on the CPU (fast_samples); every
    leaf has the dtype, shape and strides of the seeded path's
    (init_params on the card), so the parameters' bytes are equal; request
    0 of phase 3 twice, the second timed and counted (_counted_request;
    its peak over the request). Returns (ok, each counted request's launch
    counts)."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves
    from quickvideo_tpu_torch.testing import leaf_items

    def layout(tree):
        return {p: (x.dtype, tuple(x.shape), x.stride())
                for p, x in leaf_items(tree)}

    def nbytes(tree):
        return sum(x.nbytes for x in tensor_leaves(tree))

    counters = _kernel_counters()
    ok, runs = True, []
    t_phase = time.perf_counter()
    for model, param_dtype in FAST_RUNS:
        tag = f"[3m {model}, {param_dtype} weights, preset path]"
        gc.collect()  # the previous LVU, in a cycle
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        trees = []
        t0 = time.perf_counter()
        with _capture_preset(trees):
            lvu = make_lvu(dev, param_dtype, model=model, fast=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tree, mcfg = trees.pop(), lvu.model_config
        t0 = time.perf_counter()
        n_leaves, n_values, bad, extra = _fast_whole(
            dev, tree, mcfg, param_dtype == "int8")
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        whole_ok = not bad and extra == 0 and n_leaves > 0
        n_sampled, _, bad_samples = fast_samples(tree, mcfg, None)
        samples_ok = not bad_samples and n_sampled > 0
        seeded = init_params(mcfg, 0, torch.bfloat16, dev,
                             param_dtype=param_dtype)
        layout_ok = layout(tree) == layout(seeded)
        fast_bytes, seeded_bytes = nbytes(tree), nbytes(seeded)
        bytes_ok = fast_bytes == seeded_bytes
        del tree, seeded  # the int8 tower's leaves the prep replaced
        gc.collect()
        torch.cuda.empty_cache()
        resident = (torch.cuda.memory_allocated() - base) / 2**30
        ok &= whole_ok and samples_ok and layout_ok and bytes_ok
        log(f"{tag} {n_leaves} tensors, {n_values / 1e9:.3f} B values "
            f"equal, bit for bit, the JAX leaves computed whole on the card "
            f"({whole_s:.2f} s)"
            f"{'' if not bad else f': differ {bad[:8]}'}"
            f"{'' if not extra else f', {extra} extra'} "
            f"{'OK' if whole_ok else 'FAIL'}; {n_sampled} sampled values "
            f"equal the index function's on the CPU"
            f"{'' if not bad_samples else f': differ {bad_samples[:8]}'} "
            f"{'OK' if samples_ok else 'FAIL'}; dtypes, shapes and strides "
            f"those of the seeded path's tree {layout_ok}, parameter bytes "
            f"{fast_bytes} vs {seeded_bytes} "
            f"{'OK' if bytes_ok else 'FAIL'} (after the engine's prep "
            f"{nbytes(lvu.params)})")
        torch.cuda.reset_peak_memory_stats()
        run_ok, counts = _counted_request(
            lvu, tag, param_dtype, "bf16", counters, base / 2**30, init_s,
            resident)
        ok &= run_ok
        runs.append(counts)
        del lvu
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[3m] phase {time.perf_counter() - t_phase:.1f} s")
    return ok, runs


# -- phase 4: card vs CPU ----------------------------------------------------


def narrow_config(q_heads=7, rms_norm_eps=1e-6, tokens_per_second=2.0):
    """2 decoder layers at head_dim 128 (`q_heads` q heads / 1 kv head: 7,
    the 7B's GQA ratio, or 8, the 3B's and the 72B's) and 2 vision blocks at
    head_dim 80 (block 0 window, block 1 full); the text rmsnorm eps and
    the vision tokens_per_second as given (the 72B's: 1e-5, 4.0)."""
    from quickvideo_tpu_torch.models.qwen25_vl.config import (
        ModelConfig,
        TextConfig,
        VisionConfig,
    )

    hidden = 128 * q_heads
    return ModelConfig(
        name="narrow128",
        vision=VisionConfig(
            depth=2, hidden_size=160, intermediate_size=256, num_heads=2,
            fullatt_block_indexes=(1,), out_hidden_size=hidden,
            tokens_per_second=tokens_per_second,
        ),
        text=TextConfig(
            vocab_size=2048, hidden_size=hidden, intermediate_size=1024,
            num_hidden_layers=2, num_attention_heads=q_heads,
            num_key_value_heads=1, rms_norm_eps=rms_norm_eps,
        ),
        image_token_id=2040,
        video_token_id=2041,
        vision_start_token_id=2042,
        vision_end_token_id=2043,
    )


def _agreement(st_g, st_c):
    """Per (group, layer): the share of the CPU run's retained indices the
    card run retained too."""
    return [
        len(set(a.cpu().tolist()) & set(b.tolist())) / len(b)
        for ig, ic in zip(st_g["retained"], st_c["retained"])
        for a, b in zip(ig, ic) if b is not None
    ]


def run_card_vs_cpu(dev):
    import torch

    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.tokenization import load_tokenizer
    from quickvideo_tpu_torch.models.qwen25_vl.convert import (
        init_params,
        params_to,
    )
    from quickvideo_tpu_torch.prefill import LVUEngine

    from quickvideo_tpu_torch.ops.quantization import quantize_model_params

    mcfg = narrow_config()
    base = init_params(mcfg, seed=3, dtype=torch.bfloat16, device="cpu")
    p_gpu = params_to(base, device=dev)
    p_cpu = params_to(base, dtype=torch.float32)  # the same bf16 values

    tokenizer = load_tokenizer("", mcfg)

    def run(params_gpu, params_cpu, image=None, source_hw=None, cfg=mcfg,
            **kw):
        """Final-prefill logits of one 16-frame request (2 groups of 8; an
        `image` before the video; frames at `source_hw` resized on the
        device) on the card (bf16 activations) and on the CPU (f32): (card
        logits, CPU logits, rel. L2, card state, CPU state, card cache)."""
        lvu_cfg = LVUConfig(model_name_or_path="narrow128",
                            max_decode_tokens=8, **kw)
        out = []
        for params, dtype, device in ((params_gpu, torch.bfloat16, dev),
                                      (params_cpu, torch.float32, "cpu")):
            eng = LVUEngine(params, cfg, lvu_cfg, dtype, device)
            cache, st = eng.prefill(make_request(
                cfg, tokenizer, "What happens in this video?", seed=7,
                n_frames=16, group_frames=8, image=image, source_hw=source_hw,
            ))
            out.append((eng.final_prefill(cache, st).float().cpu(), st, cache))
        (lg, st_g, cache_g), (lc, st_c, _) = out
        rel = ((lg - lc).norm() / lc.norm()).item()
        return lg, lc, rel, st_g, st_c, cache_g

    ok = True
    lg, lc, rel, _, _, _ = run(p_gpu, p_cpu)
    this_ok = bool(rel <= LOGITS_REL_L2 and torch.isfinite(lg).all())
    ok &= this_ok
    log(f"card vs CPU, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_L2}), argmax card "
        f"{int(lg.argmax())} cpu {int(lc.argmax())} "
        f"{'OK' if this_ok else 'FAIL'}")
    _, _, rel, st_g, st_c, _ = run(p_gpu, p_cpu, top_p=0.5)
    agree = _agreement(st_g, st_c)
    log(f"card vs CPU, top_p=0.5, key_norms_small: logits rel L2 {rel:.3e} "
        f"(not asserted); retained-index agreement "
        f"{' '.join(f'{a:.3f}' for a in agree)}")

    # B1's lse (salient_tokens) and pure-past + lse (query-based) modes on
    # the card, their plain versions on the CPU
    for kw in (dict(top_k_predict_type="salient_tokens"),
               dict(top_k_predict_type="query_attention_weights",
                    query_based=True)):
        lg, lc, rel, st_g, st_c, _ = run(p_gpu, p_cpu, top_p=0.5, **kw)
        agree = _agreement(st_g, st_c)
        this_ok = bool(rel <= PRUNED_LOGITS_REL_L2
                       and torch.isfinite(lg).all()
                       and min(agree) >= RETAINED_AGREE)
        ok &= this_ok
        log(f"card vs CPU, top_p=0.5, {kw['top_k_predict_type']}: "
            f"final-prefill logits rel L2 {rel:.3e} (tol "
            f"{PRUNED_LOGITS_REL_L2}), retained-index agreement "
            f"{' '.join(f'{a:.3f}' for a in agree)} (each >= "
            f"{RETAINED_AGREE}), argmax card {int(lg.argmax())} cpu "
            f"{int(lc.argmax())} {'OK' if this_ok else 'FAIL'}")

    # the on-device resize: 480 x 854 yuv420 frames resampled to the grid
    # (lanczos3_resize's two f32 products on each side)
    lg, lc, rel, _, _, _ = run(p_gpu, p_cpu, source_hw=RESIZE_SOURCE_HW,
                               resize_on_device=True)
    this_ok = bool(rel <= LOGITS_REL_L2 and torch.isfinite(lg).all())
    ok &= this_ok
    log(f"card vs CPU, resize_on_device from {RESIZE_SOURCE_HW[0]}x"
        f"{RESIZE_SOURCE_HW[1]}, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_L2}), argmax card {int(lg.argmax())} cpu "
        f"{int(lc.argmax())} {'OK' if this_ok else 'FAIL'}")

    # int8 weights: the same int8 codes on both sides (quantized once on
    # the host), bf16 activations on the card, f32 on the CPU
    q = quantize_model_params(params_to(base))
    lg, lc, rel, _, _, _ = run(params_to(q, device=dev),
                               params_to(q, dtype=torch.float32),
                               param_dtype="int8")
    this_ok = bool(rel <= INT8_LOGITS_REL_L2 and torch.isfinite(lg).all())
    ok &= this_ok
    log(f"card vs CPU, int8 weights, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {INT8_LOGITS_REL_L2}), argmax card "
        f"{int(lg.argmax())} cpu {int(lc.argmax())} "
        f"{'OK' if this_ok else 'FAIL'}")

    # int8 KV cache, bf16 weights: B1's int8 variant on the card, its
    # plain version on the CPU
    lg, lc, rel, _, _, cache_g = run(p_gpu, p_cpu, kv_cache_dtype="int8")
    this_ok = bool(rel <= INT8_KV_LOGITS_REL_L2 and torch.isfinite(lg).all()
                   and cache_g.k.dtype == cache_g.v.dtype == torch.int8)
    ok &= this_ok
    log(f"card vs CPU, int8 KV, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {INT8_KV_LOGITS_REL_L2}), argmax card "
        f"{int(lg.argmax())} cpu {int(lc.argmax())} "
        f"{'OK' if this_ok else 'FAIL'}")

    # the head-major route (B5 on the card, its plain version on the CPU):
    # forced, with bf16 and with int8 weights (the unfused MLP chain: both
    # engines skip the B4 prep under QV_VISION_2D=0); and by default for an
    # image before the video, whose grid the tiling rule refuses
    from quickvideo_tpu_torch.ops.vision_attention import block_diag_attention

    for what, gpu, cpu, kw, tol, route in (
        ("QV_VISION_2D=0", p_gpu, p_cpu, {}, LOGITS_REL_L2, "0"),
        ("QV_VISION_2D=0, int8 weights", params_to(q, device=dev),
         params_to(q, dtype=torch.float32), dict(param_dtype="int8"),
         INT8_LOGITS_REL_L2, "0"),
        (f"image {IMAGE_HW[0]}x{IMAGE_HW[1]} before the video", p_gpu, p_cpu,
         dict(image=seeded_image(3)), LOGITS_REL_L2, None),
    ):
        with vision_route(route):
            before = block_diag_attention.launches
            lg, lc, rel, _, _, _ = run(gpu, cpu, **kw)
            b5 = block_diag_attention.launches - before
        this_ok = bool(rel <= tol and torch.isfinite(lg).all() and b5 > 0)
        ok &= this_ok
        log(f"card vs CPU, {what}, top_p=1: final-prefill logits rel L2 "
            f"{rel:.3e} (tol {tol}), B5 launches on the card {b5}, argmax "
            f"card {int(lg.argmax())} cpu {int(lc.argmax())} "
            f"{'OK' if this_ok else 'FAIL'}")

    # the 3B's and the 72B's GQA ratio (8 q heads per kv head: B1 at rep 8)
    # with the 72B's text eps and M-RoPE time scale
    rcfg = narrow_config(q_heads=8, rms_norm_eps=1e-5, tokens_per_second=4.0)
    rbase = init_params(rcfg, seed=3, dtype=torch.bfloat16, device="cpu")
    lg, lc, rel, _, _, _ = run(params_to(rbase, device=dev),
                               params_to(rbase, dtype=torch.float32),
                               cfg=rcfg)
    this_ok = bool(rel <= LOGITS_REL_L2 and torch.isfinite(lg).all())
    ok &= this_ok
    log(f"card vs CPU, 8 q heads / 1 kv head, text eps 1e-5, "
        f"tokens_per_second 4.0, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_L2}), argmax card {int(lg.argmax())} "
        f"cpu {int(lc.argmax())} {'OK' if this_ok else 'FAIL'}")

    # the preset path's deterministic weights (phase 3m), made on the card
    # and on the CPU by the index function, bf16 and int8
    from quickvideo_tpu_torch.models.qwen25_vl.convert import (
        init_params_fast,
        init_params_fast_quantized,
    )

    for what, make, kw in (
        ("bf16", init_params_fast, {}),
        ("int8", init_params_fast_quantized, dict(param_dtype="int8")),
    ):
        lg, lc, rel, _, _, _ = run(
            make(mcfg, torch.bfloat16, dev),
            params_to(make(mcfg, torch.bfloat16, "cpu"), dtype=torch.float32),
            **kw)
        this_ok = bool(rel <= FAST_LOGITS_REL_L2 and torch.isfinite(lg).all())
        ok &= this_ok
        log(f"card vs CPU, the preset's deterministic {what} weights, "
            f"top_p=1: final-prefill logits rel L2 {rel:.3e} (tol "
            f"{FAST_LOGITS_REL_L2}), argmax card {int(lg.argmax())} cpu "
            f"{int(lc.argmax())} {'OK' if this_ok else 'FAIL'}")
    return ok


def _fused_rows(fused_rows, label):
    """(B3/B4/B6 rows of `label`, the main path's S = 14,400 timed row)."""
    rows = [r for r in fused_rows if r["name"] == label]
    return rows, next(r for r in rows if r["s"] == 14400 and "ms" in r)


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--profile", action="store_true",
        help="instead of the smoke test, profile one warm 7B request with "
             "bf16 weights, int8 weights and an int8 KV cache "
             "(torch.profiler) and print where the device time goes",
    )
    ap.add_argument(
        "--compare-b1", action="store_true",
        help="instead of the smoke test, print B1's device times at the "
             "main path's shapes (decode, int8 and int8k prefill)",
    )
    ap.add_argument(
        "--compare-fused", action="store_true",
        help="instead of the smoke test, print B3, B4 and B6's device times "
             "by launch part at S = 14,400 and 250",
    )
    ap.add_argument(
        "--root", default=ROOT,
        help="with --compare-b1 or --compare-fused: the checkout whose "
             "quickvideo_tpu_torch to time (default: this one), e.g. an "
             "unpacked older commit",
    )
    # phase 3i's own processes (run_mesh starts them)
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nccl-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=MESH_WORLD,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-phase", default="3i", help=argparse.SUPPRESS)
    ap.add_argument(
        "--mesh-runs", default=None,
        help="with --mesh-cards: the comma-separated tags of the runs to "
             "make (CARD_MESH_RUNS, TAGGED_RUNS, CARD_SERVE_RUNS; default: "
             "every run of CARD_MESH_RUNS for the number of cards); serve: "
             "every server run (phase 3k's checks over NCCL)",
    )
    ap.add_argument(
        "--mesh-cards", action="store_true",
        help="instead of the smoke test, run phase 3i's checks and requests "
             "with NCCL, one rank per card (2 or 4 cards)",
    )
    ap.add_argument(
        "--one-card", action="store_true",
        help="with --mesh-cards and --mesh-runs: run the tagged runs (up to "
             "4 ranks) as gloo ranks sharing card 0",
    )
    args = ap.parse_args()
    if args.one_card and not (args.mesh_cards and args.mesh_runs):
        ap.error("--one-card goes with --mesh-cards and --mesh-runs")
    if args.root != ROOT:
        if not (args.compare_b1 or args.compare_fused):
            ap.error("--root goes with --compare-b1 or --compare-fused")
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py: torch.cuda.is_available() is False; this smoke "
            "test runs only on a CUDA card"
        )
    from quickvideo_tpu_torch import _build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.mesh_dir is not None:  # a process of phase 3i
        if args.mesh_backend == "nccl":  # one rank per card
            dev = torch.device("cuda", args.mesh_rank)
        torch.cuda.set_device(dev)
        if args.mesh_rank is not None:
            run_mesh_rank(dev, args.mesh_rank, args.mesh_world,
                          args.mesh_dir, args.mesh_backend, args.mesh_phase,
                          args.mesh_runs)
        elif args.nccl_one:
            run_nccl_one(dev, args.mesh_dir)
        return
    gpu = _gpu_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(lib_path, ROOT)}")
    if args.profile:
        for param_dtype, kv_cache_dtype, pruning in (
            ("bfloat16", "auto", {}), ("int8", "auto", {}),
            ("bfloat16", "int8", {}),
            ("bfloat16", "auto", dict(top_k_predict_type="salient_tokens")),
            ("bfloat16", "auto",
             dict(top_k_predict_type="query_attention_weights")),
            ("bfloat16", "auto", dict(route="0")),  # head-major, B5
        ):
            run_profile(dev, param_dtype, kv_cache_dtype, **pruning)
        return
    if args.compare_b1:
        ok = compare_b1(dev, os.path.relpath(args.root, ROOT))
        if args.root == ROOT:
            ok &= flash_kernel_info()
        log(f"compare-b1: {'OK' if ok else 'FAIL'}")
        sys.exit(0 if ok else 1)
    if args.mesh_cards:
        for i, line in enumerate(_gpu_lines()):
            log(f"gpu {i}: {line}")
        ok = run_card_mesh(dev, args.mesh_runs, args.one_card)
        log(f"mesh-cards: {'OK' if ok else 'FAIL'} ({gpu}, "
            f"{torch.cuda.device_count()} cards)")
        sys.exit(0 if ok else 1)
    if args.compare_fused:
        ok = compare_fused(dev, os.path.relpath(args.root, ROOT))
        if args.root == ROOT:
            ok &= fused_kernel_info()
        log(f"compare-fused: {'OK' if ok else 'FAIL'}")
        sys.exit(0 if ok else 1)

    flash_cases = [
        (3600, 1807, 16384),  # group 2 step of the 7B main path
        (3600, 0, 8192),      # group 1: empty past
        (1, 4000, 8192),      # decode
        (1, 57344, 65536),    # decode at the 1024-frame headline's occupancy
        (37, 3607, 8192),     # final prefill: not a tile multiple
        (100, 1000, 4096),    # length + G ends mid-tile
        (27, 1000, 4096),     # 189 packed rows: the decode kernel's largest
        (28, 1000, 4096),     # 196 packed rows: one prefill row tile
    ]
    # a tp rank's heads on the 7B (tp = 2: 14 / 2, tp = 4: 7 / 1) at the
    # group step and at decode (phase 3i)
    tp_cases = [(g, length, cap, hq, hkv) for hq, hkv in ((14, 2), (7, 1))
                for g, length, cap in ((3600, 1807, 16384), (1, 4000, 8192))]
    headline = (3600, 53744, 65536)  # the 1024-frame headline's last step
    flash_rows = check_flash(dev, flash_cases + [headline] + tp_cases
                             + REP8_CASES)
    flash_int8_rows = check_flash_int8(dev, flash_cases + [
        headline,
        (1, 122880, 131072),   # hour-scale decode
    ] + tp_cases + REP8_CASES)
    mode_rows = check_flash_modes(dev, [
        (False, 3620, 1807, 16384),  # the 7B query-based group, 20-token prompt
        (False, 3620, 53744, 65536),  # ... at the 1024-frame headline's last step
        (False, 20, 0, 4096),  # empty past (the query-based group 0)
        (False, 20, 1807, 4096),  # 20 rows over a past (the decode kernel)
        (True, 3600, 1807, 16384),  # the hot path's group step with lse
        (True, 3600, 53744, 65536),
        # context parallelism (phase 3i): a window of 4096 slots at the
        # 64-frame request's second group step, decode over a window, and
        # over an empty one; the in-group partial over the raw group
        (False, 3600, 1805, 4096),
        (False, 1, 4000, 4096),
        (False, 1, 0, 4096),
        (True, 3600, 0, 3600),
    ] + [(causal, 3600, 1807, 16384, hq, hkv) for hq, hkv in REP8_HEADS
         for causal in (True, False)])
    check_b1_headline_sdpa(dev)
    vision_rows = check_vision(dev, [
        (64, 14400), (48, 3600), (36, 3600), (4, 3600), (900, 14400),
        (2304, 9216),
    ])
    b5_rows = check_b5(dev, [
        # the 420x420 group's window buckets and frames (S = 14,400)
        (64, 14400, False), (48, 14400, False), (36, 14400, False),
        (900, 14400, False),
        # the 476x644 image's buckets (20 x 64, 4 x 48, 5 x 16, 1 x 12) and
        # its one 1564-row frame
        (64, 1280, False), (48, 192, False), (16, 80, False), (12, 12, False),
        (1564, 1564, False),
        # ragged column validity, and a span above the TPU's 1536-row cap
        (64, 14400, True), (2304, 9216, False),
    ])
    rotary_row = check_rotary(dev, 14400)
    ok = all(r["ok"] for r in flash_rows + flash_int8_rows + mode_rows
             + vision_rows + b5_rows + [rotary_row])
    ok &= vision_kernel_info()
    ok &= flash_kernel_info()

    fused_rows = check_fused(dev)
    ok &= all(r["ok"] for r in fused_rows)
    ok &= fused_kernel_info()
    int_mm_yardstick(dev)

    lvu, main_ok, launches, logits_bf16 = run_main_path(dev)
    ok &= main_ok
    ok &= run_video_file(lvu)
    runs = [launches]  # every main-path run's launch counts
    modes_ok, mode_runs = run_modes(dev, lvu.params)
    ok &= modes_ok
    runs += mode_runs
    hm_ok, hm_runs = run_head_major(dev, lvu.params, logits_bf16)
    ok &= hm_ok
    runs += hm_runs
    api_ok, api_runs = run_api_paths(dev, lvu.params)
    ok &= api_ok
    runs += api_runs
    for phase in (run_front_end, run_device_resize):
        phase_ok, phase_runs = phase(dev, lvu.params)
        ok &= phase_ok
        runs += phase_runs
    serve_ok, serve_runs = run_serving_mesh(dev, lvu.params)
    ok &= serve_ok
    del lvu
    torch.cuda.empty_cache()
    for param_dtype, kv_dtype, what in (
        ("int8", "auto", "int8 vs bf16 weights"),
        ("bfloat16", "int8", "int8 vs bf16 KV"),
        ("bfloat16", "int8k", "int8k vs bf16 KV"),
    ):
        lvu, main_ok, counts, logits = run_main_path(dev, param_dtype,
                                                     kv_dtype)
        ok &= main_ok
        runs.append(counts)
        del lvu
        torch.cuda.empty_cache()
        rel = ((logits - logits_bf16).norm() / logits_bf16.norm()).item()
        log(f"7B final-prefill logits, {what} of one seed: rel L2 "
            f"{rel:.3e} (printed, not asserted); argmax "
            f"{int(logits.argmax())} vs {int(logits_bf16.argmax())}")
    auto_ok, counts = run_auto_hour_capacity(dev)
    ok &= auto_ok
    runs.append(counts)
    torch.cuda.empty_cache()
    mesh_ok, mesh_kernel_rows, mesh_runs = run_mesh(dev)
    ok &= mesh_ok
    pp_ok, pp_runs = run_pipeline(dev)
    ok &= pp_ok
    sizes_ok, size_runs = run_sizes(dev)
    ok &= sizes_ok
    runs += size_runs
    fast_ok, fast_runs = run_fast_init(dev)
    ok &= fast_ok
    runs += fast_runs
    launches = {k: sum(r[k] for r in runs) for k in launches}
    ok &= run_card_vs_cpu(dev)

    def entry(name, source, line, launched, rows, row, library_ms=None):
        """One kernel of the result line: launches on the main path, the
        largest error over its phase-2 rows, the times and bound of `row`
        (the main path's shape)."""
        return {
            "name": name,
            "route": "cuda",
            "source": f"quickvideo_tpu_torch/csrc/{source}",
            "replaces": f"quickvideo_tpu/ops/{line}",
            "launches": launched,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": library_ms,
        }

    flash = ("flash_attention.cu", "flash_attention.py:38")
    # B1's kernels by their device times: the bf16 prefill kernel at the
    # 64-frame group step (explicit-mask SDPA beside it, host-timed), the
    # int8-QK prefill kernel there (no PyTorch call takes an int8 cache),
    # the decode kernel at G = 1 over 57,344 slots (SDPA's device time)
    kernels = []
    rows = [r for r in flash_rows if r["kernel"] == "bf16_prefill"]
    row = next(r for r in rows if (r["g"], r["length"]) == (3600, 1807))
    kernels.append(entry(
        "flash_past_attention (B1, bf16 KV, prefill kernel, wgmma)", *flash,
        launches["flash_kernel_bf16_prefill"], rows, row, row["library_ms"],
    ))
    rows = [r[v] for r in flash_int8_rows for v in ("int8", "int8k")
            if r[v]["kernel"] == "int8_prefill"]
    kernels.append(entry(
        "flash_past_attention (B1, int8 / int8k KV, int8-QK prefill kernel, "
        "wgmma)", *flash, launches["flash_kernel_int8_prefill"], rows,
        flash_int8_rows[0]["int8"],
    ))
    rows = ([r for r in flash_rows if r["kernel"] == "decode"]
            + [r[v] for r in flash_int8_rows for v in ("int8", "int8k")
               if r[v]["kernel"] == "decode"])
    row = next(r for r in flash_rows if (r["g"], r["length"]) == (1, 57344))
    kernels.append(entry(
        "flash_past_attention (B1, every cache, decode kernel)", *flash,
        launches["flash_kernel_decode"], rows, row, row["library_dev_ms"],
    ))
    for variant in B1_VARIANTS:
        if variant != "bf16":
            rows = [r[variant] for r in flash_int8_rows]
            kernels.append(entry(
                f"flash_past_attention (B1, {variant} KV, int8-QK)", *flash,
                launches[f"flash_{variant}_unified"], rows, rows[0],
            ))
        for mode, what in (("unified+lse", "lse"),
                           ("past+lse", "pure past + lse")):
            rows = [r for r in mode_rows
                    if r["variant"] == variant and r["mode"] == mode]
            # rows[0] is the 7B group step's shape; memory-efficient SDPA
            # returns the lse on bf16 operands (sdpa_lse_ms), and no call
            # takes an int8 cache
            kernels.append(entry(
                f"flash_past_attention (B1, {variant} KV, {what})", *flash,
                launches[f"flash_{variant}_{mode}"], rows, rows[0],
                rows[0]["library_ms"],
            ))
    # phase 3i's B1 modes, launched in its rank processes (counted there
    # per request): the past on a CP window (timed at the 64-frame request's
    # second group step on a 4096-slot window) and the in-group partial
    # (timed at G = 3600 over the raw group)
    mesh_counts = [r["counts"] for recs in mesh_runs for r in recs]
    for what, mode, key, case in (
        ("per CP window: pure past + lse at the window's local length, "
         "merged over sp", "past+lse", "cp_past", (3600, 1805)),
        ("in-group partial under sp: unified + lse over an empty past",
         "unified+lse", "in_group", (3600, 0)),
    ):
        rows = [r for r in mode_rows if r["variant"] == "bf16"
                and r["mode"] == mode and (r["g"], r["length"]) == case]
        launched = sum(c.get(f"flash_{v}_{mode}", 0) for c in mesh_counts
                       for v in B1_VARIANTS if mode == "past+lse"
                       or v == "bf16")
        errs = [r for r in mesh_kernel_rows if r.get("what") == key]
        kernels.append(entry(f"flash_past_attention (B1, {what})", *flash,
                             launched, errs + rows, rows[0],
                             rows[0]["library_ms"]))
    # phase 3j's B1 launches, in its rank processes: each stage runs its
    # L / pp layers of every step (its count one rank's / pp, checked
    # there); the kernel and shapes are the main path's, so its times are
    # the group step's row
    pp_total = sum(n for recs in pp_runs for r in recs
                   for k, n in r["counts"].items()
                   if not k.startswith("flash_kernel"))
    rows = [r for r in flash_rows if r["kernel"] == "bf16_prefill"]
    row = next(r for r in rows if (r["g"], r["length"]) == (3600, 1807))
    kernels.append(entry(
        "flash_past_attention (B1, per pp stage: the stage's layers of "
        "every step)", *flash, pp_total, rows, row, row["library_ms"]))
    # phase 3k's B1 launches, in its rank processes: every job of the
    # served requests on every rank (the served burst's per rank checked
    # there against the same work called directly)
    serve_total = sum(job["b1"]["flash"] for recs in serve_runs
                      for r in recs for job in r["jobs"])
    kernels.append(entry(
        "flash_past_attention (B1, served on a mesh: each rank's jobs, tp "
        "heads or pp stage)", *flash, serve_total, rows, row,
        row["library_ms"]))
    fused = "fused_vision_mlp.cu"
    kernels += [
        entry("block_diag_attention_2d (B2)", "vision_attention.cu",
              "vision_attention.py:140", launches["vision_2d"], vision_rows,
              vision_rows[0], vision_rows[0]["library_ms"]),
        # B5's row: the 64-row windows at S = 14,400; batched SDPA over the
        # spans computes its function
        entry("block_diag_attention (B5)", "vision_attention.cu",
              "vision_attention.py:71", launches["vision_hm"], b5_rows,
              b5_rows[0], b5_rows[0]["library_ms"]),
        # the rotary of _kernel2d (vision_attention.py:165-168) and of the
        # head-major route, as one pass; no PyTorch call computes it
        entry("vision_rotary (rotary pass of B2 and the head-major route)",
              "vision_attention.cu", "vision_attention.py:165",
              launches["rotary"], [rotary_row], rotary_row),
        entry("ln_gemm_bias (B3)", fused, "fused_vision_mlp.py:272",
              launches["ln_gemm"], *_fused_rows(fused_rows, "B3")),
        entry("ln_dual_gemm_silu_quant (B4)", fused, "fused_vision_mlp.py:162",
              launches["ln_mlp"], *_fused_rows(fused_rows, "B4")),
        # B6 has no caller on the main path (nor in the JAX package, but
        # its module's probe): 0 launches there, checked in phase 2
        entry("dual_gemm_silu_quant (B6)", fused, "fused_vision_mlp.py:126",
              launches["mlp_pre"], *_fused_rows(fused_rows, "B6")),
    ]
    if not ok:
        log("chip_smoke: FAILED (see the lines marked FAIL)")
        sys.exit(1)
    print(gpu)  # nvidia-smi's "name, power.limit" line, as it gave it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
