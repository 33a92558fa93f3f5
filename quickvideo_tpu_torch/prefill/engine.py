"""Grouped-prefill engine, decode loop and continuation scoring (PyTorch).

Counterpart of quickvideo_tpu/prefill/engine.py on one device: per video
group, vision encode -> embedding scatter -> the decoder stack with
prune-and-append into a preallocated KV cache; then the question suffix as
one final prefill, then decode.

Pruning runs every predictor and mode of the JAX engine: the 19 predict
types (the random ones draw from per-group, per-layer torch generators
seeded from `seed + 1`, the group and the layer, where the JAX engine folds
its rng the same way); the query-based mode (the prompt rows ride with
every group, rotary rows taken contiguously past the group, the JAX
engine's quirk); decay schedules and the cascade (`prefill_prune_starting_
layer`), which give each layer its own spec (`_layer_specs`); local-only
attention (`adaptive_local_attention=False`); and `do_top_k_for_query`,
which prunes the final prefill too.

Eager PyTorch needs none of the JAX engine's shape bucketing: the final
prefill runs the exact suffix length (causality keeps the valid rows the
same as the JAX package's padded bucket), and decode is a Python loop of
q = 1 steps. Cache lengths are host ints, so the group loop never waits on
the device; the first wait is the argmax of the first token.

int8 weights (`param_dtype="int8"`) run the same path: the engine preps the
vision MLP weights for kernel B4 once (not under `QV_VISION_2D=0`, as the
JAX engine skips its prep there, so the tower runs the unfused MLP chain),
and the final prefill act-quantizes whatever the suffix length (the JAX
package's padded bucket always passes its row gate).

Images (quickvideo_tpu/prefill/engine.py:718-756): each image grid runs
through the vision tower (the `vision` span). Images before the video
scatter into group 0 (which absorbs the prefix), images after it into the
final prefill and, in query-based mode, into every group's prompt rows. A
request without a video runs its whole sequence through the final prefill.

The KV cache is bf16 (the compute dtype), int8 K and V, or int8 K only
(`kv_cache_dtype` "bfloat16" / "int8" / "int8k"); "auto" resolves per
request as the JAX package's rule does (`config.resolve_auto_kv_dtype`:
int8 above 65,536 planned slots or when a bf16 cache would not fit beside
the weights), with the card's memory.

Decode (`_generate_from_cache`, shared by `generate`, chat sessions and
batched QA): greedy, or sampled through the JAX filters (`_filter_logits`)
from a torch.Generator seeded once from `LVUConfig.seed`, on the engine's
device (`sample_on_device`, the default) or on the host from logits copied
there. `on_tokens` receives the first token alone, then chunks of
min(32, stream_chunk_tokens) tokens, the JAX engine's sequence of calls
(per token on the host-sampling path, as there).

Continuation scoring (`score_continuations`): one prefill of the request,
then per continuation one exact-length pass of suffix + continuation
against the cache, log-softmax in f32 and the gather on the device; the
per-layer lengths (host ints) are restored between continuations, so each
scores against the same cache.

Frames decoded at the source size (`resize_on_device`) carry their size in
`PrefillInputs.native_hw`, and the vision tower resamples them to the
model grid on the device.

A mesh (`LVUConfig.mesh`, the `mesh` argument: parallel/mesh.py) runs
the same loop on every rank (quickvideo_tpu/prefill/engine.py:174-193,
761-828): context parallelism (sp > 1) splits the cache's capacity over
the sp ranks, whose quantum is 4096 * sp (so capacities, kv_cache_bytes
and the "auto" dtype match the JAX engine's), and every step's past
attention runs on the windows and merges; tensor parallelism holds the
rank's kv heads in the cache (tp must divide both head counts), with sp
and tp composing. dp ranks run their own requests.

Pipeline parallelism (pp > 1; quickvideo_tpu/prefill/engine.py:194-221,
787-806, 916-979, 1127-1159, 1200-1382) runs the same loop on every stage
over a per-request parallel/pipeline.py::PipelinedStack: the cache is the
stage's slab of L / pp layers (`new_cache`), the first stage alone runs
the vision tower and the embeddings (the other stages draw nothing from
`pixel_groups`), each group is pushed through the stages, and the final
prefill, scoring and each decode step run as sequential passes whose
logits live on the last stage: it picks or samples each token with its own
generator and broadcasts it, the final-prefill logits and a score's two
scalars likewise. Tokens, `cache_length`, `kv_cache_bytes` and
`layer_lengths` (gathered over the stages) are one rank's. Each stage
keeps the retained index sets of its own layers: `state["retained"][g][j]`
on stage s is that of global layer s * L / pp + j, so a caller gathers
all of them by collecting every stage's (the sets are host-readable
tensors). pp composes with tp inside a stage and with dp; it refuses sp,
a layer count it does not divide and decay or cascade schedules
(`check_slice`, with the JAX messages).
`attention_impl` is not read: the port's cache attention is kernel B1 (the
JAX package's 'pallas' route).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quickvideo_tpu_torch.config import (
    LVUConfig,
    kv_quant_mode,
    resolve_auto_kv_dtype,
    resolve_effective_top_k,
)
from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig
from quickvideo_tpu_torch.models.qwen25_vl import model as qmodel
from quickvideo_tpu_torch.models.qwen25_vl import rope
from quickvideo_tpu_torch.models.qwen25_vl.language import (
    StepSpec,
    compute_logits,
    decode_step,
    embed_tokens,
    prefill_step,
    prefill_step_unrolled,
)
from quickvideo_tpu_torch.models.qwen25_vl.vision import layout_tensors
from quickvideo_tpu_torch.ops.fused_vision_mlp import fuse_vision_mlp_weights
from quickvideo_tpu_torch.ops import kv_cache as kvc
from quickvideo_tpu_torch.parallel.comm import all_reduce_sum
from quickvideo_tpu_torch.parallel.pipeline import PipelinedStack
from quickvideo_tpu_torch.parallel.sharding import check_tp, global_nbytes
from quickvideo_tpu_torch.utils import timing
from quickvideo_tpu_torch.utils.timing import SpanTimer


@dataclass
class PrefillInputs:
    """Everything the engine needs for one request, host-side.

    `pixel_groups` may be a list or any iterator (streaming mode), of numpy
    arrays or tensors already on the device: per group (T, H*W*3/2) uint8
    yuv420 frames, (T, 3, H, W) uint8 RGB frames, or (S_g, patch_input_dim)
    patchified floats. `image_pixels` holds one such array per image, at
    the image's grid: a (1, 3, H, W) uint8 frame, which the tower repeats
    across the temporal patch, or patchified floats."""

    input_ids: np.ndarray  # (L,) full packed sequence
    video_grid_thw: Optional[Tuple[int, int, int]]  # None without a video
    pixel_groups: Iterable
    group_grids: Sequence[Tuple[int, int, int]]  # per group (t_g, h, w)
    second_per_grid_ts: float = 1.0
    native_hw: Optional[Tuple[int, int]] = None  # source (H, W) of frames
    # that the vision tower resizes on the device (resize_on_device)
    image_grid_thw: Optional[np.ndarray] = None  # (n_img, 3) rows (1, h, w)
    image_pixels: Optional[Sequence[np.ndarray]] = None


@dataclass
class GenerationResult:
    tokens: np.ndarray
    timings: dict = field(default_factory=dict)
    cache_length: int = 0
    prefill_tokens: int = 0
    kv_cache_bytes: int = 0  # retained KV bytes
    kv_unpruned_bytes: int = 0  # what an unpruned cache would hold
    layer_lengths: List[int] = field(default_factory=list)  # per layer, as
    # the cache holds them after the request

    @property
    def kv_memory_fraction(self) -> float:
        return self.kv_cache_bytes / max(self.kv_unpruned_bytes, 1)


def check_slice(lvu: LVUConfig, model_cfg: Optional[ModelConfig] = None
                ) -> None:
    """Raise TypeError for a config that is not the port's LVUConfig,
    NotImplementedError for a configuration outside the port (given the
    model, a tp that does not divide its head counts), and ValueError for
    what pipeline parallelism refuses, with the JAX engine's messages
    (quickvideo_tpu/prefill/engine.py:203-214, 792-797): sp beside it, a
    layer count it does not divide, decay or cascade schedules. Every rank
    runs these checks before any collective."""
    if not isinstance(lvu, LVUConfig):
        raise TypeError(
            "the port takes quickvideo_tpu_torch.config.LVUConfig, got "
            f"{type(lvu).__module__}.{type(lvu).__name__}"
        )
    m = lvu.mesh
    if m.pp > 1:
        if m.sp > 1:
            shape = {a: getattr(m, a) for a in m.axis_names()}
            raise ValueError(
                "pp does not compose with sp inside a stage (context "
                "parallelism is a non-pp mesh mode); tp inside a stage "
                f"IS supported (mesh shape {shape})"
            )
        n = None if model_cfg is None else model_cfg.text.num_hidden_layers
        if n is not None and n % m.pp:
            raise ValueError(
                f"num_hidden_layers={n} not divisible by pp={m.pp}"
            )
        if (lvu.top_k_decay_type is not None
                or lvu.prefill_prune_starting_layer is not None):
            raise ValueError(
                "pipeline parallelism does not support decay/cascade "
                "schedules (per-layer shape changes need the unrolled path; "
                "run with pp=1)"
            )
    if model_cfg is not None:
        check_tp(model_cfg.text, m.tp)


def tensor_leaves(tree):
    """The tensors of a nested dict / list / tuple of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


_END = object()


def _frame_waits(groups: Iterable, n: int):
    """Iterates `groups`; the wait for each of the first `n` (the pixel
    groups the plan expects, which a stream's threads may still be
    decoding or uploading) runs under a "frame_wait" span."""
    it = iter(groups)
    for _ in range(n):
        with timing.span("frame_wait"):
            item = next(it, _END)
        if item is _END:
            return
        yield item
    yield from it


class LVUEngine:
    """One model + one LVUConfig on one device; reusable across requests."""

    def __init__(
        self,
        params: dict,
        model_cfg: ModelConfig,
        lvu_cfg: LVUConfig,
        dtype=torch.bfloat16,
        device=None,
        mesh=None,  # parallel.mesh.Mesh of this rank, for lvu_cfg.mesh
    ):
        check_slice(lvu_cfg, model_cfg)
        if lvu_cfg.mesh.num_devices > 1 and (
                mesh is None or mesh.config != lvu_cfg.mesh):
            raise ValueError(
                f"LVUConfig.mesh {lvu_cfg.mesh} needs this rank's Mesh "
                "(parallel.mesh.make_mesh) and parameters sharded for it; "
                "LVU builds both"
            )
        self.mesh = mesh if lvu_cfg.mesh.num_devices > 1 else None
        # pipeline parallelism: this rank's stage (its layers, and the
        # tower and embedding or the norm and lm_head; module docstring);
        # the last stage computes the logits
        self.pp = self.mesh if lvu_cfg.mesh.pp > 1 else None
        self.first_stage = self.pp is None or self.mesh.is_first_stage
        self.last_stage = self.pp is None or self.mesh.is_last_stage
        self.params = params
        if "vision" in params and os.environ.get("QV_VISION_2D", "1") != "0":
            # one-time weight prep of an int8 tower for kernel B4 (a float
            # tower comes back as it is); skipped under QV_VISION_2D=0 as the
            # JAX engine skips it (quickvideo_tpu/prefill/engine.py:145-172)
            self.params = dict(params)
            self.params["vision"] = fuse_vision_mlp_weights(
                params["vision"], model_cfg.vision
            )
        self.cfg = model_cfg
        self.lvu = lvu_cfg
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None
            else next(tensor_leaves(params["language"])).device
        )
        self._layouts = {}
        self._weight_bytes = None
        self._final_prefills = 0  # seeds the pruned final prefill's draws
        # sampling streams, seeded once and continued across requests (the
        # JAX engine's self._rng): on the device, and on the host for
        # sample_on_device=False; made at first use
        self._generators = {}

    def _layout_tensors(self, grid):
        if grid not in self._layouts:
            self._layouts[grid] = layout_tensors(
                qmodel.layout_for(self.cfg, grid), self.device
            )
        return self._layouts[grid]

    def _to_device(self, pixels) -> torch.Tensor:
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.from_numpy(np.ascontiguousarray(pixels))
        # a block on the host comes from pageable memory: the copy waits
        upload = pixels.device.type == "cpu" and self.device.type != "cpu"
        with timing.host_wait() if upload else contextlib.nullcontext():
            pixels = pixels.to(self.device)
        # uint8 frames stay uint8 (normalized on the device); float inputs
        # run in the compute dtype
        return pixels if pixels.dtype == torch.uint8 else pixels.to(self.dtype)

    # -- planning --------------------------------------------------------

    def _uniform(self) -> bool:
        return (
            self.lvu.top_k_decay_type is None
            and self.lvu.prefill_prune_starting_layer is None
        )

    def _layer_specs(self, base: StepSpec) -> List[StepSpec]:
        """Per-layer specs under a decay schedule or the cascade
        (quickvideo_tpu/prefill/engine.py:581-600): layer li keeps
        resolve_effective_top_k of the rows that reach it; from
        `prefill_prune_starting_layer` on, a pruning layer passes only its
        kept rows (and the prompt rows) to the next."""
        n = self.cfg.text.num_hidden_layers
        if self._uniform():
            return [base] * n
        psl = self.lvu.prefill_prune_starting_layer
        specs, q_len = [], base.q_len
        for li in range(n):
            k = resolve_effective_top_k(self.lvu, li, n,
                                        q_len - base.prompt_len)
            cascade = isinstance(psl, int) and 0 <= psl <= li and k > 0
            specs.append(dataclasses.replace(base, q_len=q_len, keep_k=k,
                                             cascade=cascade))
            if cascade and li < n - 1:
                q_len = k + base.prompt_len
        return specs

    def device_memory_bytes(self) -> int:
        """What the auto KV rule takes as device memory: QV_HBM_GB (GiB)
        when set, else the card's total memory, else the JAX engine's 16 GiB
        default (so both packages resolve alike on the CPU)."""
        env = os.environ.get("QV_HBM_GB")
        if env:
            return int(float(env) * (1 << 30))
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return 16 << 30

    def resolve_kv_dtype(self, capacity: int) -> str:
        """Resolve kv_cache_dtype='auto' for a request with `capacity`
        planned KV slots by the JAX package's rule
        (config.resolve_auto_kv_dtype, thresholds measured on a TPU), with
        this engine's weight bytes and device memory; explicit dtypes pass
        through."""
        if self.lvu.kv_cache_dtype != "auto":
            return self.lvu.kv_cache_dtype
        if self._weight_bytes is None:
            # the whole model's bytes, as the JAX engine counts its sharded
            # arrays; under pp the stages' parts summed (every rank
            # resolves the same request at the same point)
            n = global_nbytes(self.params, self.lvu.mesh.tp)
            if self.pp is not None:
                total = all_reduce_sum(
                    torch.tensor([n], dtype=torch.int64, device=self.device),
                    self.pp.group("pp"))
                with timing.host_wait():
                    n = int(total)
            self._weight_bytes = n
        return resolve_auto_kv_dtype(
            capacity, self.cfg.text, self._weight_bytes,
            self.device_memory_bytes(),
            compute_itemsize=torch.empty((), dtype=self.dtype).element_size(),
        )

    @property
    def capacity_quantum(self) -> int:
        """Capacities round to 4096 slots, times sp under context
        parallelism, so that every window holds a 4096 multiple
        (quickvideo_tpu/prefill/engine.py:761-768)."""
        return 4096 * self.lvu.mesh.sp

    def plan_capacity(
        self, group_token_counts: Sequence[int], prefix_len: int,
        suffix_len: int,
    ) -> int:
        """Worst-case cache capacity in tokens (same numbers as the JAX
        engine, 4096-rounded; the kernel itself only needs length + G).
        The caller rounds it to `capacity_quantum`."""
        n = self.cfg.text.num_hidden_layers
        decode_budget = -(-self.lvu.max_decode_tokens // 32) * 32
        total = prefix_len + suffix_len + decode_budget
        for gt in group_token_counts:
            keeps = [
                resolve_effective_top_k(self.lvu, li, n, gt) or gt
                for li in range(n)
            ]
            total += max(keeps)
        # the raw group sits in the cache before the compact overwrites it
        total += max(group_token_counts, default=0)
        return -(-int(total) // 4096) * 4096

    # -- main entry points ----------------------------------------------

    def prefill(self, inputs: PrefillInputs, timer: Optional[SpanTimer] = None,
                extra_capacity: int = 0):
        """Grouped prefill over the video. Returns (cache, state) for
        final_prefill() / _generate_from_cache(); state["retained"][g][l]
        holds the retained group positions of group g at layer l (None when
        the group kept all). `extra_capacity` reserves KV slots beyond the
        plan (a chat session's later turns), rounded up with it to 4096."""
        timer = timer or SpanTimer()
        cfg, lvu = self.cfg, self.lvu
        ids = np.asarray(inputs.input_ids)
        L = len(ids)
        img_grids = None
        if inputs.image_grid_thw is not None and len(inputs.image_grid_thw):
            img_grids = np.asarray(inputs.image_grid_thw).reshape(-1, 3)
        with timer.span("rope"):
            positions, delta = qmodel.rope_index_for(
                cfg, ids,
                video_grid_thw=(
                    np.array([inputs.video_grid_thw])
                    if inputs.video_grid_thw is not None else None
                ),
                image_grid_thw=img_grids,
                second_per_grid_ts=(
                    [inputs.second_per_grid_ts]
                    if inputs.video_grid_thw is not None else None
                ),
            )
            # decode continues text positions from max_pos + 1 == L + delta
            dec_pos = rope.text_positions(L + delta, lvu.max_decode_tokens)
            cos, sin = rope.mrope_cos_sin(
                np.concatenate([positions, dec_pos], axis=1),
                cfg.text.head_dim, cfg.text.mrope_section,
                cfg.text.rope_theta, self.device,
            )

        vid_idx = np.nonzero(ids == cfg.video_token_id)[0]
        if len(vid_idx) == 0:
            if img_grids is None:
                raise ValueError(
                    "input_ids contain no video tokens "
                    f"(video_token_id={cfg.video_token_id}) and no images; "
                    "grouped video prefill needs a vision placeholder span"
                )
            # image-only request: no video groups, the whole sequence runs
            # through the final prefill (image scatter included)
            suffix_start = 0
            group_input_lens = []
        else:
            first_vid, last_vid = int(vid_idx[0]), int(vid_idx[-1])
            suffix_start = last_vid + 1
            sm = cfg.vision.spatial_merge_size
            group_tokens = [t * (h // sm) * (w // sm)
                            for t, h, w in inputs.group_grids]
            if sum(group_tokens) != len(vid_idx):
                raise ValueError(
                    f"group grids give {sum(group_tokens)} video tokens, "
                    f"input_ids hold {len(vid_idx)}"
                )
            # group 0 absorbs the pre-video prompt tokens
            group_input_lens = list(group_tokens)
            group_input_lens[0] += first_vid
        img_prefix = img_suffix = None
        if img_grids is not None:
            img_prefix, img_suffix = self._encode_images(
                img_grids, inputs.image_pixels, ids, suffix_start, timer
            )

        capacity = self.plan_capacity(group_input_lens, 0, L - suffix_start)
        if extra_capacity:
            capacity = -(-(capacity + int(extra_capacity)) // 4096) * 4096
        quantum = self.capacity_quantum
        capacity = -(-capacity // quantum) * quantum
        if lvu.kv_cache_capacity:
            cap_fixed = (lvu.kv_cache_capacity // quantum) * quantum
            if capacity > cap_fixed:
                raise ValueError(
                    f"request needs {capacity} KV slots > configured "
                    f"kv_cache_capacity={lvu.kv_cache_capacity} aligned down "
                    f"to the {quantum}-slot quantum ({cap_fixed})"
                )
            capacity = cap_fixed
        kv_dtype = self.resolve_kv_dtype(capacity)
        t = cfg.text
        stack = None
        with timer.span("cache_alloc"):
            cache = self.new_cache(capacity, kv_quant_mode(kv_dtype))
            if self.pp is not None:
                stack = PipelinedStack(self.mesh, t, self.params["language"],
                                       cache, self.dtype)

        lang = self.params["language"]
        with timing.host_wait():
            ids_t = torch.as_tensor(ids, device=self.device)
        # query-based mode: the question suffix rides with every group
        prompt_len = L - suffix_start if lvu.query_based else 0
        # image embeddings per group: group 0 takes the prefix images; in
        # query-based mode every group's prompt rows carry the suffix image
        # placeholders, filled in order (group 0: prefix, then suffix)
        img_g0, img_rest = img_prefix, None
        if prompt_len and img_suffix is not None:
            img_g0 = (img_suffix if img_prefix is None
                      else torch.cat([img_prefix, img_suffix]))
            img_rest = img_suffix
        n_layers = t.num_hidden_layers
        past_len = logical_len = 0
        retained = []
        # a stage past the first runs no vision tower and takes no pixels
        pixel_iter = (inputs.pixel_groups if self.first_stage
                      else [None] * len(inputs.group_grids))
        if lvu.use_tqdm:
            from tqdm import tqdm

            pixel_iter = tqdm(
                pixel_iter, desc="Processing video groups",
                total=len(inputs.group_grids),
            )
        for gi, pixels in enumerate(_frame_waits(pixel_iter,
                                                 len(inputs.group_grids))):
            grid = tuple(int(x) for x in inputs.group_grids[gi])
            in_len = group_input_lens[gi]
            if pixels is not None:
                with timer.span("vision"):
                    vis = qmodel.encode_video_group(
                        self.params, cfg, self._to_device(pixels), grid,
                        self._layout_tensors(grid),
                        native_hw=inputs.native_hw,
                    )
            base = StepSpec(
                q_len=in_len + prompt_len,
                keep_k=resolve_effective_top_k(lvu, 0, n_layers, in_len),
                predict_type=lvu.top_k_predict_type,
                needs_probs=lvu.needs_attn_stats,
                prompt_len=prompt_len,
                attend_past=lvu.adaptive_local_attention,
                ref_query_mask=lvu.reference_query_mask,
            )
            with timer.span("prefill"):
                x = None
                if self.first_stage:
                    g_ids = ids_t[past_len : past_len + in_len]
                    if prompt_len:
                        g_ids = torch.cat([g_ids, ids_t[suffix_start:]])
                    x = qmodel.merge_vision_embeddings(
                        self._embed(g_ids, None), vis, g_ids,
                        cfg.video_token_id,
                    )
                    img = img_g0 if gi == 0 else img_rest
                    if img is not None:
                        x = qmodel.merge_vision_embeddings(
                            x, img, g_ids, cfg.image_token_id
                        )
                # rotary rows contiguous past the group's start: in
                # query-based mode the prompt rows take the positions of the
                # tokens that follow the group (the JAX engine's quirk,
                # quickvideo_tpu/prefill/engine.py:311-319)
                rows = slice(past_len, past_len + base.q_len)
                specs = self._layer_specs(base)
                seed_key = (lvu.seed + 1, gi)
                if stack is None:
                    _, idx = prefill_step_unrolled(
                        lang, cache, x, cos[rows], sin[rows], t, specs,
                        seed_key=seed_key, mesh=self.mesh,
                    )
                else:  # on to the next stage without waiting for it
                    _, idx = stack.push_group(x, base.q_len, cos[rows],
                                              sin[rows], specs, seed_key)
            retained.append(idx)
            past_len += in_len
            # under decay / cascade a layer that keeps all appends the whole
            # group: the occupancy is the max over layers, as plan_capacity
            # counts it
            logical_len += max(
                resolve_effective_top_k(lvu, li, n_layers, in_len) or in_len
                for li in range(n_layers)
            )
        if stack is not None:
            with timer.span("prefill"):
                stack.end_stream()
        if past_len != suffix_start:
            raise ValueError(
                f"pixel groups covered {past_len} tokens, the video ends at "
                f"{suffix_start}"
            )
        state = {
            "cos": cos,
            "sin": sin,
            "suffix_start": suffix_start,
            "L": L,
            "ids": ids,
            "delta": delta,
            "positions": positions,  # host (3, L) mRoPE rows (chat sessions
            # extend them instead of re-walking the sequence)
            "cache_len": logical_len,
            "retained": retained,
            "kv_dtype": kv_dtype,
            "img_suffix": img_suffix,  # scattered by the final prefill
            "pp_stack": stack,  # under pp: the stage's slab and links
        }
        return cache, state

    def new_cache(self, capacity: int, quantized) -> kvc.KVCache:
        """This rank's part of a zeroed cache of `capacity` slots: its
        pipeline stage's layers, its tp rank's kv heads and its sp rank's
        capacity window (quickvideo_tpu/prefill/engine.py:787-828)."""
        t, m = self.cfg.text, self.lvu.mesh
        idx = self.mesh.index("sp") if self.mesh is not None else 0
        return kvc.init_cache(
            t.num_hidden_layers // m.pp, t.num_key_value_heads // m.tp,
            capacity,
            t.head_dim, dtype=self.dtype, device=self.device,
            quantized=quantized, sp_index=idx, sp_size=m.sp,
        )

    def _encode_images(self, img_grids, image_pixels, ids, suffix_start,
                       timer):
        """Each image through the vision tower; returns the embeddings of
        the images before `suffix_start` and of those after it (None where
        there are none), after checking the placeholder counts
        (quickvideo_tpu/prefill/engine.py:718-756) on the host, on every
        pipeline stage; only the first runs the tower (the others return
        (None, None))."""
        cfg = self.cfg
        pix_list = image_pixels or []
        if len(pix_list) != len(img_grids):
            raise ValueError(
                f"{len(img_grids)} image grids but {len(pix_list)} "
                "image pixel arrays"
            )
        # the tower gives t * h * w / merge_unit rows per grid
        n_rows = sum(int(np.prod(g)) // cfg.vision.spatial_merge_unit
                     for g in img_grids)
        n_prefix = int(np.sum(ids[:suffix_start] == cfg.image_token_id))
        n_total = int(np.sum(ids == cfg.image_token_id))
        if n_rows != n_total:
            raise ValueError(
                f"image grids produce {n_rows} tokens "
                f"but input_ids contain {n_total} image placeholders"
            )
        if not self.first_stage:
            return None, None
        with timer.span("vision"):
            embs = []
            for g, pix in zip(img_grids, pix_list):
                grid = tuple(int(v) for v in g)
                embs.append(qmodel.encode_video_group(
                    self.params, cfg, self._to_device(pix), grid,
                    self._layout_tensors(grid),
                ))
            img_embeds = torch.cat(embs)
        return (img_embeds[:n_prefix] if n_prefix else None,
                img_embeds[n_prefix:] if n_total > n_prefix else None)

    def final_prefill(self, cache, state, timer: Optional[SpanTimer] = None):
        """The question suffix through all layers at its exact length.
        Appends all of it, or with `do_top_k_for_query` its kept rows, as
        the JAX engine does (quickvideo_tpu/prefill/engine.py:1404-1440;
        query predictors then score the suffix's own column sums). Sets
        state["suffix_advance"] and state["retained_final"]. Returns the
        last row's logits (V,) f32. The cache's own tensors say its quant
        mode (a resumed session's cache was built under an earlier "auto"
        resolution)."""
        timer = timer or SpanTimer()
        lvu = self.lvu
        ss, L = state["suffix_start"], state["L"]
        lang = self.params["language"]
        n = self.cfg.text.num_hidden_layers
        keep_k = 0
        if lvu.do_top_k_for_query:
            keep_k = resolve_effective_top_k(lvu, 0, n, L - ss)
        with timer.span("final_prefill"):
            with timing.host_wait():
                ids = torch.as_tensor(state["ids"][ss:L], device=self.device)
            x = self._embed(ids, state.get("img_suffix"))
            rows = slice(ss, L)
            if keep_k > 0:
                # exact rows, so the act-quant gate sees the real count
                spec = StepSpec(
                    q_len=L - ss, keep_k=keep_k,
                    predict_type=lvu.top_k_predict_type,
                    needs_probs=lvu.needs_attn_stats or lvu.query_based,
                )
                self._final_prefills += 1
                hidden, idx = self._pass(
                    cache, state, x, rows, spec,
                    seed_key=(lvu.seed, self._final_prefills),
                )
            else:
                # the JAX package's padded bucket always passes the gate
                hidden, idx = self._pass(cache, state, x, rows,
                                         StepSpec(q_len=L - ss), min_rows=0)
            logits = None
            if self.last_stage:
                logits = compute_logits(lang, hidden[-1], self.cfg.text,
                                        self.mesh)
            stack = state.get("pp_stack")
            if stack is not None:
                logits = stack.share(logits, (self.cfg.text.vocab_size,),
                                     torch.float32)
        state["suffix_advance"] = keep_k or L - ss
        state["retained_final"] = idx
        return logits

    def _pass(self, cache, state, x, rows: slice, spec: StepSpec,
              seed_key=None, min_rows=None):
        """One sequential pass of `spec.q_len` rows at rotary rows `rows`
        through every layer with one spec: prefill_step on one rank, the
        stage's chain under pp (x None off the first stage). Returns (the
        final hidden states, None off the last stage; the per-layer
        retained indices of this rank's layers)."""
        cos, sin = state["cos"][rows], state["sin"][rows]
        stack = state.get("pp_stack")
        if stack is None:
            return prefill_step(self.params["language"], cache, x, cos, sin,
                                self.cfg.text, spec, min_rows, seed_key,
                                self.mesh)
        return stack.chunk(x, spec.q_len, cos, sin,
                           [spec] * self.cfg.text.num_hidden_layers,
                           seed_key, min_rows)

    def _embed(self, ids: torch.Tensor, img) -> Optional[torch.Tensor]:
        """Token embeddings with image embeddings `img` (or None) scattered
        into the image placeholders; None on a pipeline stage past the
        first, which receives its rows."""
        if not self.first_stage:
            return None
        lang = self.params["language"]
        x = embed_tokens(lang, ids, None if "norm" in lang else self.dtype)
        if img is not None:
            x = qmodel.merge_vision_embeddings(x, img, ids,
                                               self.cfg.image_token_id)
        return x

    # -- decode ------------------------------------------------------------

    @staticmethod
    def _filter_logits(logits: torch.Tensor, top_p=None, top_k=None):
        """The JAX engine's top-k / nucleus filters
        (quickvideo_tpu/prefill/engine.py:1181-1198), value for value:
        top-k masks logits below the k-th largest (ties at the k-th value
        stay; k >= vocab keeps all); top-p keeps the logits at or above the
        cutoff of the smallest sorted prefix whose probability reaches
        top_p (none reaching it: the largest alone)."""
        if top_k is not None and top_k > 0:
            kth = torch.sort(logits).values[-min(int(top_k), logits.shape[-1])]
            logits = torch.where(logits < kth, -torch.inf, logits)
        if top_p is not None and 0 < top_p < 1:
            sorted_logits = torch.sort(logits, descending=True).values
            csum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            cutoff = sorted_logits[torch.argmax((csum >= top_p).to(torch.uint8))]
            logits = torch.where(logits < cutoff, -torch.inf, logits)
        return logits

    def _generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._generators:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.lvu.seed)
            self._generators[device] = gen
        return self._generators[device]

    def _sample(self, logits, temperature, top_p, top_k) -> int:
        """One token drawn from the filtered logits / temperature."""
        flt = self._filter_logits(logits.float(), top_p, top_k)
        probs = torch.softmax(flt / temperature, dim=-1)
        drawn = torch.multinomial(probs, 1,
                                  generator=self._generator(probs.device))
        if drawn.device.type == "cpu":  # host sampling
            return int(drawn)
        with timing.host_wait():
            return int(drawn)

    def _generate_from_cache(
        self, cache, state, max_new_tokens, eos_token_ids, greedy=True,
        temperature=1.0, timer: Optional[SpanTimer] = None, top_p=None,
        top_k=None, on_tokens=None,
    ):
        """The final prefill of state's suffix (ids[suffix_start:L]), then
        decode. Returns (tokens, cache, logical cache length): the cache
        holds the suffix and every token but the last. Greedy and
        device-sampled decode call `on_tokens` with the first token, then
        with chunks of min(32, stream_chunk_tokens) tokens; host sampling
        (sample_on_device=False) calls it per token. Under pp the last
        stage picks each token (its generators sample) and every stage
        gets it (PipelinedStack.share_token / decode_step), so every stage
        returns the same tokens and streams the same chunks."""
        timer = timer or SpanTimer()
        lvu = self.lvu
        lang = self.params["language"]
        stack = state.get("pp_stack")
        logits = self.final_prefill(cache, state, timer)
        max_new = min(max_new_tokens or lvu.max_decode_tokens,
                      lvu.max_decode_tokens)
        L, cos, sin = state["L"], state["cos"], state["sin"]
        on_host = not greedy and not lvu.sample_on_device
        out: List[int] = []
        tok = torch.empty(1, dtype=torch.int64, device=self.device)

        def pick(logits) -> int:
            if greedy:
                best = torch.argmax(logits)
                with timing.host_wait():
                    return int(best)
            if on_host:
                with timing.host_wait():
                    logits = logits.cpu()
            return self._sample(logits, temperature, top_p, top_k)

        def next_token() -> int:
            # the decode rows of the tables start at L
            row = L + len(out) - 1
            tok.fill_(out[-1])
            if stack is not None:
                return stack.decode_step(lang, tok, cos[row : row + 1],
                                         sin[row : row + 1], pick)
            return pick(decode_step(lang, cache, tok, cos[row : row + 1],
                                    sin[row : row + 1], self.cfg.text,
                                    self.mesh))

        with timer.span("decode"):
            if stack is None:
                out.append(pick(logits))
            else:
                out.append(stack.share_token(
                    pick(logits) if stack.is_last else None))
            stream = on_tokens if on_tokens is not None else (lambda t: None)
            stream(out[-1:])
            chunk = (1 if on_host
                     else max(1, min(32, int(lvu.stream_chunk_tokens))))
            while out[-1] not in eos_token_ids and len(out) < max_new:
                n_stop = (min(chunk, max_new - len(out))
                          if on_tokens is not None else max_new - len(out))
                new = []
                while len(new) < n_stop:
                    with timing.span("decode_step"):
                        new.append(next_token())
                    out.append(new[-1])
                    if new[-1] in eos_token_ids:
                        break
                stream(new)
        cache_len = (state["cache_len"] + state["suffix_advance"]
                     + max(0, len(out) - 1))
        return np.asarray(out, np.int64), cache, cache_len

    def generate(
        self,
        inputs: PrefillInputs,
        max_new_tokens: Optional[int] = None,
        eos_token_ids: Sequence[int] = (),
        greedy: bool = True,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        on_tokens=None,
    ) -> GenerationResult:
        """Full request: grouped prefill + final prefill + decode."""
        timer = SpanTimer()
        with timer.span("e2e"):
            cache, state = self.prefill(inputs, timer)
            tokens, cache, cache_len = self._generate_from_cache(
                cache, state, max_new_tokens, eos_token_ids, greedy,
                temperature, timer, top_p=top_p, top_k=top_k,
                on_tokens=on_tokens,
            )
        t = self.cfg.text
        L = state["L"]
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        # bytes per (K, V) token slot: int8 stores 1 B values and one f32
        # scale per head_dim row; int8k quantizes K only
        full = t.head_dim * itemsize
        k_b, v_b = {
            "int8": (t.head_dim + 4, t.head_dim + 4),
            "int8k": (t.head_dim + 4, full),
        }.get(state["kv_dtype"], (full, full))
        per_tok = t.num_hidden_layers * t.num_key_value_heads * (k_b + v_b)
        return GenerationResult(
            tokens=tokens,
            timings=timer.totals(),
            cache_length=cache_len,
            prefill_tokens=L,
            kv_cache_bytes=cache_len * per_tok,
            kv_unpruned_bytes=(L + len(tokens)) * per_tok,
            layer_lengths=self.layer_lengths(cache, state),
        )

    @staticmethod
    def layer_lengths(cache, state) -> List[int]:
        """Every layer's cache length (gathered over the stages under pp:
        a collective, which every stage calls)."""
        stack = state.get("pp_stack")
        return (list(cache.lengths) if stack is None
                else stack.gather_lengths())

    # -- continuation scoring ----------------------------------------------

    def score_continuation(self, inputs: PrefillInputs, continuation_ids,
                           timer: Optional[SpanTimer] = None):
        """Teacher-forced (total log-probability, is_greedy) of
        `continuation_ids` after the request (the lmms-eval `loglikelihood`
        contract); see score_continuations."""
        return self.score_continuations(inputs, [continuation_ids], timer)[0]

    def score_continuations(self, inputs: PrefillInputs, continuations,
                            timer: Optional[SpanTimer] = None) -> list:
        """Several continuations against one prefill of the request
        (quickvideo_tpu/prefill/engine.py:1073-1108): the video groups run
        once, grouped and pruned as in generate; each continuation runs as
        one exact-length pass of suffix + continuation against the cache,
        never pruned, and the per-layer lengths are restored after it (its
        rows above them are dead: attention reads a layer only up to its
        length plus the call's rows, and the next pass overwrites them).
        Returns a list of (total_logprob, is_greedy).

        The suffix (the tokens after the video) must not be empty: the
        first continuation token is predicted by the suffix's last row, and
        without a suffix that row is not in the pass. The JAX body then
        silently drops that token's log-probability (ROADMAP C2); the port
        raises ValueError."""
        timer = timer or SpanTimer()
        lvu = self.lvu
        conts = [np.asarray(c, np.int64) for c in continuations]
        for cont in conts:
            if len(cont) == 0:
                raise ValueError("continuation_ids is empty")
            if len(cont) > lvu.max_decode_tokens:
                raise ValueError(
                    f"continuation has {len(cont)} tokens > "
                    f"max_decode_tokens={lvu.max_decode_tokens}; raise "
                    "max_decode_tokens (the rope tables only extend that "
                    "far past the prompt)"
                )
        ids = np.asarray(inputs.input_ids)
        vid = np.nonzero(ids == self.cfg.video_token_id)[0]
        if len(vid) and int(vid[-1]) + 1 == len(ids):
            raise ValueError(
                "the request ends with its video: scoring needs at least one "
                "token after it, whose last row predicts the first "
                "continuation token (the JAX package drops that token's "
                "log-probability here)"
            )
        cache, state = self.prefill(inputs, timer)
        return [
            self._score_one(cache, state, cont, timer,
                            restore=i < len(conts) - 1)
            for i, cont in enumerate(conts)
        ]

    def _score_one(self, cache, state, cont, timer, restore: bool):
        """One continuation against the prefilled cache; with `restore`
        the per-layer lengths are put back afterwards."""
        ss, L = state["suffix_start"], state["L"]
        combined = np.concatenate([state["ids"][ss:L], cont])
        q = len(combined)
        saved = list(cache.lengths)
        with timer.span("score"):
            with timing.host_wait():
                ids = torch.as_tensor(combined, device=self.device)
            hidden, _ = self._pass(
                cache, state, self._embed(ids, state.get("img_suffix")),
                slice(ss, ss + q), StepSpec(q_len=q), min_rows=0,
            )
            pair = None
            if self.last_stage:
                logits = compute_logits(self.params["language"], hidden,
                                        self.cfg.text, self.mesh)
                total, greedy = self._score_gather(logits, ids, q, L - ss)
                pair = torch.stack([total, greedy.to(total.dtype)])
            stack = state.get("pp_stack")
            if stack is not None:  # the last stage's two scalars
                pair = stack.share(pair, (2,), torch.float32)
            with timing.host_wait():
                total, greedy = pair.tolist()
        if restore:  # each stage restores its own layers' lengths
            cache.lengths[:] = saved
        return float(total), bool(greedy)

    @staticmethod
    def _score_gather(logits, ids, valid: int, cont_start: int):
        """(sum of the continuation rows' target log-probabilities, whether
        every such row's argmax is its target), on the device. Row r
        predicts ids[r + 1]; continuation rows are [cont_start - 1,
        valid - 1) (quickvideo_tpu/prefill/engine.py:386-435)."""
        lp = torch.log_softmax(logits.float(), dim=-1)
        r = torch.arange(ids.shape[0], device=ids.device)
        targets = torch.roll(ids, -1)  # the last row's is masked
        mask = (r >= cont_start - 1) & (r < valid - 1)
        row_lp = lp.gather(1, targets[:, None])[:, 0]
        total = torch.where(mask, row_lp, 0.0).sum()
        greedy = torch.where(mask, logits.argmax(-1) == targets, True).all()
        return total, greedy
