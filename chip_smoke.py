#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (quickvideo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and `nvcc`; imports nothing of
JAX. It fails (non-zero exit, no result line) without CUDA and outside a
checkout of the repository. Phases:

  1. the card's name and power limit; build of the kernels from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     production head dims and the main path's shapes, with times: B1 (bf16
     cache, and its int8-QK variants for the int8 and int8k caches, up to
     the 1024-frame headline's last group step and hour-scale decode), B2,
     and the int8 vision kernels B3, B4, B6 at the 7B tower's widths;
  3. the main path at the full width and depth of qwen25-vl-7b (bf16
     random weights): three `generate` requests through LVU / LVUEngine on
     64 seeded 420x420 yuv420 frames, groups of 32, key_norms_small at
     top_p=0.5; launch counts, cache lengths and per-span timings;
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
  4. the same prefill on the card and (plain versions) on the CPU for a
     narrow config with production head dims, with bf16 and with int8
     weights, and with an int8 KV cache: final-prefill logits agree.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

runs phase 1, then one warm 7B request (request 0 of phase 3) with bf16
weights, with int8 weights, and with bf16 weights and an int8 KV cache
under torch.profiler, and prints the wall time, the busy share of the card,
the spans, kernel time by kind and the top kernels. It prints no result
line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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

REQUEST_FRAMES = 64
FRAME_HW = 420  # 30 x 30 patches: ragged 64/48/36-patch window buckets
GROUP_FRAMES = 32


def log(msg):
    print(msg, flush=True)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def _device_ms(fn, names, reps: int) -> float:
    """Device time per call of fn of the kernels whose names hold one of
    `names`, from torch.profiler: the kernels alone, without the host's
    launch gaps that _time_ms sees when a call is host-bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in names))
    return us / 1e3 / reps


# -- phase 2: kernels vs plain --------------------------------------------


def _compare(got, ref):
    """(max abs error, within the stated tolerance and finite)."""
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    within = bool(torch.isfinite(got).all() and (diff <= bound).all())
    return diff.max().item(), within


def check_flash(dev, cases):
    """B1 on a 2-layer stacked cache, layer 1, Hq=28 / Hkv=4 / D=128."""
    import torch

    from quickvideo_tpu_torch.ops.attention import unified_causal_attention
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for g, length, cap in cases:
        k_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
        v_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
        # q as the projection lays it out: (G, Hq, D) storage, (Hq, G, D) view
        q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)
        scale = 128 ** -0.5
        got = flash_past_attention(q, k_all[1], v_all[1], length, scale)
        ref = unified_causal_attention(q, k_all[1], v_all[1], length, scale)
        err, within = _compare(got, ref)
        ms = _time_ms(
            lambda: flash_past_attention(q, k_all[1], v_all[1], length, scale),
            20,
        )
        plain_ms = _time_ms(
            lambda: unified_causal_attention(
                q, k_all[1], v_all[1], length, scale
            ),
            3,
        )
        ok = within
        log(f"B1 G={g} length={length} cap={cap}: max_abs_err={err:.3e} "
            f"(tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{'OK' if ok else 'FAIL'}")
        rows.append(dict(g=g, length=length, err=err, ms=ms,
                         plain_ms=plain_ms, ok=ok))
        del k_all, v_all
    return rows


def check_flash_int8(dev, cases):
    """B1's int8-QK variants (int8 K and V; int8 K with bf16 V) against
    their plain version on the same int8 codes, on a 2-layer stacked cache
    quantized from seeded bf16 rows, layer 1, Hq=28 / Hkv=4 / D=128; and
    the bf16 kernel's time at the same shape (bf16 cache of the same rows).
    Both plain versions round the PV operand (p, or p * vs) to bf16 as the
    kernels do, so B1's bf16 tolerance holds."""
    import torch

    from quickvideo_tpu_torch.ops.attention import (
        quantize_q,
        unified_causal_attention_int8,
    )
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    scale = 128 ** -0.5
    rows = []
    for g, length, cap in cases:
        k = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
        q = q.transpose(0, 1)
        def bf16():
            return flash_past_attention(q, k, v, length, scale)

        bf16_ms = _time_ms(bf16, 10)
        bf16_dev = _device_ms(bf16, ("flash_fwd_kernel", "flash_merge"), 10)
        q_ms = _time_ms(lambda: quantize_q(q, scale), 10)
        row = dict(g=g, length=length, bf16_ms=bf16_ms, q_ms=q_ms, ok=True)
        for variant, mode in (("int8", True), ("int8k", "k")):
            cache = init_cache(2, 4, cap, 128, device=dev, quantized=mode)
            stacked_append(cache, 1, 0, k, v)
            ks = cache.k_scale[1]
            vs = None if cache.v_scale is None else cache.v_scale[1]

            def kernel():
                return flash_past_attention(q, cache.k[1], cache.v[1], length,
                                            scale, k_scale=ks, v_scale=vs)

            def plain():
                q8, qs = quantize_q(q, scale)
                return unified_causal_attention_int8(
                    q8, qs, cache.k[1], ks, cache.v[1], vs, length,
                    torch.bfloat16,
                )

            err, within = _compare(kernel(), plain())
            ms = _time_ms(kernel, 10)
            dev_ms = _device_ms(kernel, ("flash_fwd_int8", "flash_merge"), 10)
            plain_ms = _time_ms(plain, 2)
            row.update({variant: dict(err=err, ms=ms, plain_ms=plain_ms)})
            row["ok"] &= within
            log(f"B1 {variant} G={g} length={length} cap={cap}: "
                f"max_abs_err={err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}"
                f"*|plain|) kernel {ms:.4f} ms (with the q quantize, alone "
                f"{q_ms:.4f} ms; device time of the B1 kernels "
                f"{dev_ms:.4f} ms) plain {plain_ms:.4f} ms, bf16 kernel "
                f"{bf16_ms:.4f} ms (device {bf16_dev:.4f} ms) "
                f"{'OK' if within else 'FAIL'}")
            del cache
        rows.append(row)
        del k, v, q
        torch.cuda.empty_cache()
    return rows


def check_vision(dev, cases):
    """B2 at nh=16, hd=80 on strided q/k/v views of one fused projection."""
    import torch

    from quickvideo_tpu_torch.ops.vision_attention import (
        block_diag_attention,
        block_diag_attention_plain,
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
        cos, sin = torch.cos(emb), torch.sin(emb)
        scale = 80 ** -0.5
        got = block_diag_attention(q, k, v, cos, sin, span, scale)
        ref = block_diag_attention_plain(q, k, v, cos, sin, span, scale)
        err, within = _compare(got, ref)
        ms = _time_ms(
            lambda: block_diag_attention(q, k, v, cos, sin, span, scale), 20
        )
        plain_ms = _time_ms(
            lambda: block_diag_attention_plain(q, k, v, cos, sin, span, scale),
            3,
        )
        ok = within
        log(f"B2 span={span} S={s_len}: max_abs_err={err:.3e} "
            f"(tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{'OK' if ok else 'FAIL'}")
        rows.append(dict(span=span, s=s_len, err=err, ms=ms,
                         plain_ms=plain_ms, ok=ok))
    return rows


def check_fused(dev, cases):
    """B3, B4, B6 at the 7B tower's widths (C 1280, QKV N 3840, MLP I 3420
    padded to 3456) for each row count."""
    import torch

    from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
    from quickvideo_tpu_torch.ops.quantization import quantize_act
    from quickvideo_tpu_torch.testing import (
        bf16_rows_close,
        fused_block,
        quantized_close,
    )

    rows = []
    for s_len in cases:
        bp = fused_block(dev, 1280, 3840, 3420, s_len)
        gen = torch.Generator(device=dev)
        gen.manual_seed(s_len + 1)
        x = torch.randn(s_len, 1280, generator=gen, device=dev).bfloat16()
        xq, xs = quantize_act(x)
        eps = 1e-6
        for name, kernel, plain, args, compare in (
            ("B3", fm.ln_gemm_bias, fm.ln_gemm_bias_plain,
             (x, bp["ln"], bp["wqkv"], bp["bqkv"], eps), bf16_rows_close),
            ("B4", fm.ln_dual_gemm_silu_quant,
             fm.ln_dual_gemm_silu_quant_plain,
             (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], eps), quantized_close),
            ("B6", fm.dual_gemm_silu_quant, fm.dual_gemm_silu_quant_plain,
             (xq, xs, bp["wgu_p"], bp["bgu_p"]), quantized_close),
        ):
            err, ok, why = compare(kernel(*args), plain(*args))
            ms = _time_ms(lambda: kernel(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), 5)
            log(f"{name} S={s_len}: max_abs_err={err:.3e} (rule: "
                f"quickvideo_tpu_torch/testing.py FUSED_*) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms {'OK' if ok else 'FAIL: ' + why}")
            rows.append(dict(name=name, s=s_len, err=err, ms=ms,
                             plain_ms=plain_ms, ok=ok))
        del bp
    return rows


# -- phase 3: the main path ------------------------------------------------


def make_request(cfg, tokenizer, question: str, seed: int,
                 n_frames: int = REQUEST_FRAMES,
                 group_frames: int = GROUP_FRAMES):
    """PrefillInputs for `n_frames` seeded-noise 420x420 yuv420 frames in
    groups of `group_frames`, with the chat template around them."""
    from quickvideo_tpu.tokenization import build_chat_ids
    from quickvideo_tpu_torch.prefill import PrefillInputs

    ps, ms = cfg.vision.patch_size, cfg.vision.spatial_merge_size
    tps = cfg.vision.temporal_patch_size
    gh = gw = FRAME_HW // ps
    rng = np.random.default_rng(seed)
    frames = rng.integers(
        0, 256, (n_frames, FRAME_HW * FRAME_HW * 3 // 2), dtype=np.uint8
    )
    groups, grids = [], []
    for off in range(0, n_frames, group_frames):
        groups.append(frames[off : off + group_frames])
        grids.append((group_frames // tps, gh, gw))
    n_vid = sum(t * (h // ms) * (w // ms) for t, h, w in grids)
    ids = build_chat_ids(tokenizer, cfg, question, n_vid)
    return PrefillInputs(
        input_ids=ids,
        video_grid_thw=(n_frames // tps, gh, gw),
        pixel_groups=groups,
        group_grids=grids,
        second_per_grid_ts=1.0,
    )


def expected_cache_length(lvu, inputs, n_tokens) -> int:
    from quickvideo_tpu.config import resolve_effective_top_k

    cfg = lvu.model_config
    ids = np.asarray(inputs.input_ids)
    vid = np.nonzero(ids == cfg.video_token_id)[0]
    n = cfg.text.num_hidden_layers
    ms = cfg.vision.spatial_merge_size
    lens = [t * (h // ms) * (w // ms) for t, h, w in inputs.group_grids]
    lens[0] += int(vid[0])
    kept = sum(resolve_effective_top_k(lvu.config, 0, n, g) or g for g in lens)
    return kept + (len(ids) - int(vid[-1]) - 1) + max(0, n_tokens - 1)


def _reset_counters(counters):
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    for fn in counters.values():
        fn.launches = 0
    for variant in flash_past_attention.variant_launches:
        flash_past_attention.variant_launches[variant] = 0


def _read_counters(counters):
    """Each wrapper's launches, and B1's per variant ("flash_bf16",
    "flash_int8", "flash_int8k")."""
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    counts = {k: fn.launches for k, fn in counters.items()}
    for variant, n in flash_past_attention.variant_launches.items():
        counts[f"flash_{variant}"] = n
    return counts


def _kernel_counters():
    from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
    from quickvideo_tpu_torch.ops.vision_attention import block_diag_attention

    return {
        "flash": flash_past_attention,
        "vision": block_diag_attention,
        "ln_gemm": fm.ln_gemm_bias,
        "ln_mlp": fm.ln_dual_gemm_silu_quant,
        "mlp_pre": fm.dual_gemm_silu_quant,
    }


def make_lvu(dev, param_dtype, kv_cache_dtype="auto", kv_cache_capacity=None):
    """LVU for qwen25-vl-7b at full width and depth, random weights from
    seed 0, as the main path runs it ("auto" KV, which resolves to bf16 for
    the 64-frame requests)."""
    from quickvideo_tpu.config import LVUConfig
    from quickvideo_tpu_torch.api import LVU

    cfg = LVUConfig(
        model_name_or_path="qwen25-vl-7b",
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
    )
    return LVU(cfg, device=dev)


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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvu = make_lvu(dev, param_dtype, kv_cache_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tensor_leaves(lvu.params))
    log(f"[{tag}] 7B init on the card: {time.perf_counter() - t0:.2f} s, "
        f"{n_params / 1e9:.3f} B parameter values, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
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
        exp["vision"] += n_groups * b2_per_group
        if param_dtype == "int8":
            exp["ln_gemm"] += n_groups * mcfg.vision.depth
            exp["ln_mlp"] += n_groups * mcfg.vision.depth
        want_len = expected_cache_length(lvu, inputs, len(res.tokens))
        exp[f"flash_{variant}"] = exp["flash"]
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
    counts_ok = counts == exp and counts["flash"] > 0 and counts["vision"] > 0
    ok &= counts_ok
    log(f"[{tag}] main-path launches: "
        + ", ".join(f"{k} {counts[k]} (expected {exp[k]})" for k in counts)
        + f" {'OK' if counts_ok else 'FAIL'}")
    log(f"[{tag}] peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    want_len = expected_cache_length(lvu, inputs, len(res.tokens))
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


def run_video_file(lvu):
    """LVU.generate(question, video_path) through the CPU decoder, where its
    library is built (it needs FFmpeg)."""
    from quickvideo_tpu.video import quickdecode as qd

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
    ("flash_fwd_kernel", "B1 flash"),
    ("flash_fwd_int8_kernel", "B1 flash int8-QK"),
    ("flash_merge_kernel", "B1 split-K merge"),
    ("vision_attn_kernel", "B2 vision attn"),
    ("fused_gemm_kernel<false>", "B3 GEMM"),
    ("fused_gemm_kernel<true>", "B4/B6 GEMM"),
    ("requantize_kernel", "B4/B6 requantize"),
    ("ln_quantize_kernel", "B3/B4 prologue"),
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


def run_profile(dev, param_dtype, kv_cache_dtype="auto"):
    """One warm 7B request (request 0 of the main path) under
    torch.profiler: wall time, the sum of kernel times, the busy share (the
    union of kernel intervals over the wall time), the spans, kernel time by
    kind and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lvu = make_lvu(dev, param_dtype, kv_cache_dtype)
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
        if e.device_type != DeviceType.CUDA:
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
    log(f"== {param_dtype} weights, {kv_cache_dtype} KV: wall {wall:.4f} s "
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


# -- phase 4: card vs CPU ----------------------------------------------------


def narrow_config():
    """2 decoder layers at head_dim 128 (7 q heads / 1 kv head, the 7B's GQA
    ratio) and 2 vision blocks at head_dim 80 (block 0 window, block 1 full)."""
    from quickvideo_tpu.models.qwen25_vl.config import (
        ModelConfig,
        TextConfig,
        VisionConfig,
    )

    return ModelConfig(
        name="narrow128",
        vision=VisionConfig(
            depth=2, hidden_size=160, intermediate_size=256, num_heads=2,
            fullatt_block_indexes=(1,), out_hidden_size=896,
        ),
        text=TextConfig(
            vocab_size=2048, hidden_size=896, intermediate_size=1024,
            num_hidden_layers=2, num_attention_heads=7,
            num_key_value_heads=1,
        ),
        image_token_id=2040,
        video_token_id=2041,
        vision_start_token_id=2042,
        vision_end_token_id=2043,
    )


def run_card_vs_cpu(dev):
    import torch

    from quickvideo_tpu.config import LVUConfig
    from quickvideo_tpu.tokenization import load_tokenizer
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

    def request():  # 16 frames in 2 groups of 8
        return make_request(mcfg, tokenizer, "What happens in this video?",
                            seed=7, n_frames=16, group_frames=8)

    ok = True
    for top_p in (None, 0.5):
        lvu_cfg = LVUConfig(
            model_name_or_path="narrow128", top_p=top_p, max_decode_tokens=8
        )
        eg = LVUEngine(p_gpu, mcfg, lvu_cfg, torch.bfloat16, dev)
        ec = LVUEngine(p_cpu, mcfg, lvu_cfg, torch.float32, "cpu")
        cache_g, st_g = eg.prefill(request())
        lg = eg.final_prefill(cache_g, st_g).float().cpu()
        cache_c, st_c = ec.prefill(request())
        lc = ec.final_prefill(cache_c, st_c).float()
        rel = ((lg - lc).norm() / lc.norm()).item()
        if top_p is None:
            this_ok = bool(rel <= LOGITS_REL_L2 and torch.isfinite(lg).all())
            ok &= this_ok
            log(f"card vs CPU, top_p=1: final-prefill logits rel L2 "
                f"{rel:.3e} (tol {LOGITS_REL_L2}), argmax card "
                f"{int(lg.argmax())} cpu {int(lc.argmax())} "
                f"{'OK' if this_ok else 'FAIL'}")
        else:
            overlaps = []
            for gi, (ig, ic) in enumerate(zip(st_g["retained"], st_c["retained"])):
                for li, (a, b) in enumerate(zip(ig, ic)):
                    sa, sb = set(a.cpu().tolist()), set(b.tolist())
                    overlaps.append(f"g{gi}l{li}={len(sa & sb) / len(sb):.3f}")
            log(f"card vs CPU, top_p=0.5: logits rel L2 {rel:.3e} (not "
                f"asserted); retained-set overlap {' '.join(overlaps)}")

    # int8 weights: the same int8 codes on both sides (quantized once on
    # the host), bf16 activations on the card, f32 on the CPU
    q = quantize_model_params(params_to(base))
    lvu_cfg = LVUConfig(model_name_or_path="narrow128", max_decode_tokens=8,
                        param_dtype="int8")
    eg = LVUEngine(params_to(q, device=dev), mcfg, lvu_cfg, torch.bfloat16,
                   dev)
    ec = LVUEngine(params_to(q, dtype=torch.float32), mcfg, lvu_cfg,
                   torch.float32, "cpu")
    cache_g, st_g = eg.prefill(request())
    lg = eg.final_prefill(cache_g, st_g).float().cpu()
    cache_c, st_c = ec.prefill(request())
    lc = ec.final_prefill(cache_c, st_c).float()
    rel = ((lg - lc).norm() / lc.norm()).item()
    this_ok = bool(rel <= INT8_LOGITS_REL_L2 and torch.isfinite(lg).all())
    ok &= this_ok
    log(f"card vs CPU, int8 weights, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {INT8_LOGITS_REL_L2}), argmax card "
        f"{int(lg.argmax())} cpu {int(lc.argmax())} "
        f"{'OK' if this_ok else 'FAIL'}")

    # int8 KV cache, bf16 weights: B1's int8 variant on the card, its
    # plain version on the CPU
    lvu_cfg = LVUConfig(model_name_or_path="narrow128", max_decode_tokens=8,
                        kv_cache_dtype="int8")
    eg = LVUEngine(p_gpu, mcfg, lvu_cfg, torch.bfloat16, dev)
    ec = LVUEngine(p_cpu, mcfg, lvu_cfg, torch.float32, "cpu")
    cache_g, st_g = eg.prefill(request())
    lg = eg.final_prefill(cache_g, st_g).float().cpu()
    cache_c, st_c = ec.prefill(request())
    lc = ec.final_prefill(cache_c, st_c).float()
    rel = ((lg - lc).norm() / lc.norm()).item()
    this_ok = bool(rel <= INT8_KV_LOGITS_REL_L2 and torch.isfinite(lg).all()
                   and cache_g.k.dtype == cache_g.v.dtype == torch.int8)
    ok &= this_ok
    log(f"card vs CPU, int8 KV, top_p=1: final-prefill logits rel L2 "
        f"{rel:.3e} (tol {INT8_KV_LOGITS_REL_L2}), argmax card "
        f"{int(lg.argmax())} cpu {int(lc.argmax())} "
        f"{'OK' if this_ok else 'FAIL'}")
    return ok


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py: torch.cuda.is_available() is False; this smoke "
            "test runs only on a CUDA card"
        )
    from quickvideo_tpu_torch import _build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
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
        for param_dtype, kv_cache_dtype in (
            ("bfloat16", "auto"), ("int8", "auto"), ("bfloat16", "int8"),
        ):
            run_profile(dev, param_dtype, kv_cache_dtype)
        return

    flash_cases = [
        (3600, 1807, 16384),  # group 2 step of the 7B main path
        (3600, 0, 8192),      # group 1: empty past
        (1, 4000, 8192),      # decode
        (1, 57344, 65536),    # decode at the 1024-frame headline's occupancy
        (37, 3607, 8192),     # final prefill: not a tile multiple
        (100, 1000, 4096),    # length + G ends mid-tile
    ]
    flash_rows = check_flash(dev, flash_cases)
    flash_int8_rows = check_flash_int8(dev, flash_cases + [
        (3600, 53744, 65536),  # the 1024-frame headline's last group step
        (1, 122880, 131072),   # hour-scale decode
    ])
    vision_rows = check_vision(dev, [
        (64, 14400), (48, 3600), (36, 3600), (4, 3600), (900, 14400),
        (2304, 9216),
    ])
    ok = all(r["ok"] for r in flash_rows + flash_int8_rows + vision_rows)

    fused_rows = check_fused(dev, [14400, 250])
    ok &= all(r["ok"] for r in fused_rows)

    lvu, main_ok, launches, logits_bf16 = run_main_path(dev)
    ok &= main_ok
    ok &= run_video_file(lvu)
    del lvu
    torch.cuda.empty_cache()
    runs = [launches]  # every main-path run's launch counts
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
    launches = {k: sum(r[k] for r in runs) for k in launches}
    ok &= run_card_vs_cpu(dev)

    def fused_entry(name, label, line, key):
        rows = [r for r in fused_rows if r["name"] == label]
        return {
            "name": name,
            "route": "cuda",
            "source": "quickvideo_tpu_torch/csrc/fused_vision_mlp.cu",
            "replaces": f"quickvideo_tpu/ops/fused_vision_mlp.py:{line}",
            "launches": launches[key],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
        }

    def flash_entry(variant):
        rows = [r[variant] for r in flash_int8_rows]
        return {
            "name": f"flash_past_attention (B1, {variant} KV, int8-QK)",
            "route": "cuda",
            "source": "quickvideo_tpu_torch/csrc/flash_attention.cu",
            "replaces": "quickvideo_tpu/ops/flash_attention.py:38",
            "launches": launches[f"flash_{variant}"],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
        }

    kernels = [
        {
            "name": "flash_past_attention (B1, bf16 KV)",
            "route": "cuda",
            "source": "quickvideo_tpu_torch/csrc/flash_attention.cu",
            "replaces": "quickvideo_tpu/ops/flash_attention.py:38",
            "launches": launches["flash_bf16"],
            "max_abs_err": max(r["err"] for r in flash_rows),
            "ms": flash_rows[0]["ms"],
            "plain_ms": flash_rows[0]["plain_ms"],
        },
        flash_entry("int8"),
        flash_entry("int8k"),
        {
            "name": "block_diag_attention (B2)",
            "route": "cuda",
            "source": "quickvideo_tpu_torch/csrc/vision_attention.cu",
            "replaces": "quickvideo_tpu/ops/vision_attention.py:140",
            "launches": launches["vision"],
            "max_abs_err": max(r["err"] for r in vision_rows),
            "ms": vision_rows[0]["ms"],
            "plain_ms": vision_rows[0]["plain_ms"],
        },
        fused_entry("ln_gemm_bias (B3)", "B3", 272, "ln_gemm"),
        fused_entry("ln_dual_gemm_silu_quant (B4)", "B4", 162, "ln_mlp"),
        # B6 has no caller on the main path (nor in the JAX package, but
        # its module's probe): 0 launches there, checked in phase 2
        fused_entry("dual_gemm_silu_quant (B6)", "B6", 126, "mlp_pre"),
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
