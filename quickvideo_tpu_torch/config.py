"""Configuration system.

The port's copy of quickvideo_tpu/config.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

API-parity with the reference's config dataclasses (reference
lvu/lvu_config.py:4-55) plus TPU-native runtime options (mesh axes, dtypes,
kernel selection, cache capacity) that have no reference equivalent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# Predictor types that require the full (group x group) attention-probability
# statistics from the current group's self-attention (reference
# lvu/utils.py:43-119,174-187).
ATTN_STATS_PREDICTORS = frozenset(
    {
        "salient_tokens",
        "attention_weights",
        "attention_weights_sum",
        "attention_weights_sum_head_tail",
        "attention_weights_sum_per_image",
        "attention_weights_sum_with_random",
        "attention_weights_deduplication",
        "weighted_norms",
    }
)

# Predictor types driven by accumulated prompt->key attention scores
# (reference lvu/utils.py:55-63, lvu/lvu_cache.py:90-117).
QUERY_PREDICTORS = frozenset(
    {
        "query_attention_weights",
        "query_attention_weights_by_value_norm",
    }
)

ALL_PREDICTORS = ATTN_STATS_PREDICTORS | QUERY_PREDICTORS | frozenset(
    {
        "vector_norms",
        "vector_norms_small",
        "key_norms",
        "key_norms_small",
        "key_norms_small_random",
        "key_norms_small_deduplication",
        "key_weighted_vector_norms",
        "output_norms",
        "random",
    }
)


@dataclass
class MeshConfig:
    """Device-mesh layout for multi-chip execution (no reference equivalent;
    the reference is single-GPU, SURVEY.md section 2.2).

    Axes:
      dp: data parallel (independent requests / eval sharding)
      pp: pipeline parallel (layer slabs over stages; skewed pipeline over
          video groups — parallel/pipeline.py. Engine path requires
          tp == sp == 1: tp/sp inside a stage is not composed yet)
      tp: tensor parallel (attention heads / MLP columns over ICI)
      sp: sequence parallel (group token axis for very large groups)
    """

    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.sp

    def axis_names(self):
        return ("dp", "pp", "tp", "sp")


@dataclass
class LVUConfig:
    """Main user-facing config.

    Field-for-field parity with the reference `LVUConfig` (reference
    lvu/lvu_config.py:4-33); extra TPU fields are grouped at the bottom.
    """

    model_name_or_path: str = ""
    model_type: str = "qwen25_vl"
    # --- KV pruning (QuickPrefill) ---
    top_k_predict_type: str = "key_norms_small"
    top_k: Optional[int] = None
    top_p: Optional[float] = None  # fraction-based k: k = int(q_len * top_p)
    top_k_starting_layer: Optional[int] = None
    do_top_k_for_query: bool = False
    adaptive_local_attention: bool = True
    video_group_size: Optional[int] = None  # in frames
    prefill_prune_starting_layer: Optional[int] = None
    # --- sampling of frames ---
    fps: Optional[float] = None
    num_frames: Optional[int] = 32
    use_tqdm: bool = False
    extra_kwargs: Optional[dict] = None
    enable: bool = True
    cache_dir: Optional[str] = None
    save_video_cache: bool = False
    top_k_decay_factor: Optional[float] = None
    top_k_decay_type: Optional[str] = None  # None | "linear" | "exponential"
    query_based: bool = False

    # --- TPU-native runtime options (new) ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dtype: str = "bfloat16"  # compute/cache dtype
    param_dtype: str = "bfloat16"  # "bfloat16" | "float32" | "int8"
    # (int8 = weight-only per-output-channel symmetric quantization — the
    # enabler for 7B-class models on a 16 GB chip; ops/quantization.py)
    kv_cache_capacity: Optional[int] = None  # tokens; None = auto from input
    kv_cache_dtype: str = "auto"  # "auto" | "bfloat16" | "int8" | "int8k"
    # int8: K and V stored int8 + per-token scales (~47% of bf16 HBM) — the
    # hour-scale memory mode. int8k: K only (~69% of bf16 HBM); QK runs at
    # the doubled s8xs8 MXU rate while PV keeps full-rate unquantized V.
    # auto (default): the engine picks bf16 vs int8 per request from the
    # planned cache capacity — bf16 at demo scale (fastest, measured), int8
    # when the cache is hour-scale/KV-bandwidth-bound or would not fit HBM
    # beside the weights (measured inversion, BENCH_RESULTS.md round 4).
    # int8k remains a manual choice.
    decode_output: str = "rgb"  # "rgb" | "yuv420" (half the host->device
    # bytes; chroma upsample + BT.601 run on device)
    align_resize_to_window: bool = False  # snap the resize DOWN to multiples
    # of 112 px: vision windows become uniform (no padded gather/scatter per
    # block) and token count drops slightly; OFF by default for strict
    # reference-resize parity
    resize_on_device: bool = False  # decode at the source's native size and
    # Lanczos-resample to the model grid INSIDE the vision program. On weak
    # hosts the in-decoder swscale LANCZOS dominates serial decode time
    # (reference offloads it to 16 CPU cores; a TPU host may have 1); the
    # trade is more H2D bytes (native frames), which the prefetch thread
    # overlaps. Requires the quickdecode backend (yuv420 or rgb output).
    attention_impl: str = "auto"  # "auto" | "pallas" | "xla"
    prune_impl: str = "auto"  # "auto" | "pallas" | "xla"
    max_decode_tokens: int = 512
    stream_chunk_tokens: int = 16  # streaming decode (on_tokens callback /
    # SSE serving) dispatches chunks of this many tokens; clamped to [1, 32]
    # (the rope tables carry max_decode_tokens+32 rows past the prompt)
    sample_on_device: bool = True  # non-greedy decode samples whole 32-token
    # chunks in-graph (filters + categorical on device, one dispatch per
    # chunk); False = per-token host sampling (one RTT each)
    decode_threads: int = 8  # QUICKCODEC_CORES equivalent
    decode_intervals: int = 64  # QUICKCODEC_INTERVALS equivalent
    prefetch_depth: int = 3  # bounded queue depth (ref Queue(maxsize=3))
    prefetch_to_device: bool = True  # producer thread also does the H2D
    # transfer, overlapping it with prefill compute (the queue then bounds
    # device-side staging memory to prefetch_depth groups)
    seed: int = 0
    reference_query_mask: bool = False  # query-based modes: reproduce the
    # reference's bottom-right-aligned causal mask exactly (used by the
    # cross-implementation parity suite; see PARITY.md mask divergence note)

    def __post_init__(self):
        # Mirrors reference __post_init__ (lvu/lvu_config.py:26-33).
        if self.top_k_decay_type == "linear" and self.top_k_decay_factor is None:
            self.top_k_decay_factor = 0.5
        if "query" in self.top_k_predict_type:
            self.query_based = True
        if isinstance(self.mesh, dict):
            self.mesh = MeshConfig(**self.mesh)
        if self.top_k_predict_type not in ALL_PREDICTORS:
            raise ValueError(
                f"Unknown top_k_predict_type: {self.top_k_predict_type!r}; "
                f"valid: {sorted(ALL_PREDICTORS)}"
            )
        if self.kv_cache_dtype not in ("auto", "bfloat16", "int8", "int8k"):
            raise ValueError(
                f"Unknown kv_cache_dtype: {self.kv_cache_dtype!r}; "
                "valid: auto, bfloat16, int8, int8k"
            )

    @property
    def needs_attn_stats(self) -> bool:
        return self.top_k_predict_type in ATTN_STATS_PREDICTORS

    def replace(self, **kw) -> "LVUConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class LVULayerConfig:
    """Per-layer view of the pruning config (reference lvu/lvu_config.py:34-55).

    In the TPU build layers are not monkey-patched objects; this dataclass is
    consumed by the prefill engine to resolve the static per-layer pruning
    parameters before tracing.
    """

    layer_idx: int
    total_layers: int
    lvu_config: LVUConfig
    is_last_layer: bool = False
    prune_for_next_layer: bool = False

    def __post_init__(self):
        if self.layer_idx is None:
            raise ValueError("layer_idx cannot be None")
        self.is_last_layer = self.layer_idx == self.total_layers - 1
        psl = self.lvu_config.prefill_prune_starting_layer
        self.prune_for_next_layer = (
            isinstance(psl, int) and psl >= 0 and self.layer_idx >= psl
        )


def kv_quant_mode(kv_cache_dtype: str):
    """Map the config's kv_cache_dtype string to the cache/StepSpec quant
    mode: 'bfloat16' -> False, 'int8' -> True (K and V), 'int8k' -> 'k'
    (K-only int8; V stays in the compute dtype). 'auto' must be resolved to
    a concrete dtype first (LVUEngine.resolve_kv_dtype)."""
    if kv_cache_dtype == "auto":
        raise ValueError(
            "kv_cache_dtype='auto' must be resolved to a concrete dtype "
            "before mapping to a quant mode (engine resolves it per request "
            "from the planned cache capacity)"
        )
    return {"int8": True, "int8k": "k"}.get(kv_cache_dtype, False)


def resolve_auto_kv_dtype(
    capacity_tokens: int,
    text_cfg,
    weight_bytes: int,
    hbm_bytes: int,
    compute_itemsize: int = 2,
    demo_scale_tokens: int = 65536,
    headroom: float = 0.88,
) -> str:
    """kv_cache_dtype='auto': pick bf16 vs int8 from the planned capacity.

    Measured basis (BENCH_RESULTS.md round 4): at demo scale (~43k retained
    tokens, <=64k planned slots) bf16 KV is fastest (int8 +0.31 s, int8k
    +0.03 s at the strict 7B shape); at hour scale (115k tokens) attention
    is KV-bandwidth-bound and int8 wins outright (19.4 s vs int8k's 32.1 s)
    AND a bf16 cache does not fit beside the 7B weights on a 16 GB chip.

    Rule: int8 when the planned capacity exceeds `demo_scale_tokens` slots
    OR when the bf16 cache would not leave (1-headroom) HBM margin beside
    the weights; bf16 otherwise. Thresholds pinned by
    tests/test_engine.py::test_auto_kv_dtype_thresholds.
    """
    t = text_cfg
    bf16_cache_bytes = (
        capacity_tokens * t.num_hidden_layers * t.num_key_value_heads
        * t.head_dim * compute_itemsize * 2  # K and V
    )
    if capacity_tokens > demo_scale_tokens:
        return "int8"
    if weight_bytes + bf16_cache_bytes > headroom * hbm_bytes:
        return "int8"
    return "bfloat16"


def resolve_effective_top_k(
    config: LVUConfig, layer_idx: int, total_layers: int, q_len: int
) -> int:
    """Resolve the static per-layer, per-group retention count.

    Semantics match reference lvu/utils.py:231-255:
      - top_p overrides/combines: k = min(top_k or q_len, int(q_len * top_p))
      - decay schedules reduce k with depth
      - returns 0 when no pruning should happen for this (layer, group)
        (disabled, k <= 0, q_len <= k, or below top_k_starting_layer).

    This runs in Python (all inputs static) so the traced computation always
    sees a fixed k — the jit-friendliness cornerstone (SURVEY.md section 7
    "Hard parts").
    """
    top_k = config.top_k
    if config.top_p is not None and config.top_p >= 0:
        top_k = min(top_k or q_len, int(q_len * config.top_p))
    if not config.top_k_decay_type:
        pass
    elif config.top_k_decay_type == "linear":
        top_k = top_k - int(top_k * (layer_idx / total_layers))
    elif config.top_k_decay_type == "exponential":
        top_k = int(top_k * (config.top_k_decay_factor ** layer_idx))
    else:
        raise ValueError(f"Unknown top_k_decay_type: {config.top_k_decay_type}")
    if (
        not config.enable
        or not top_k
        or top_k <= 0
        or q_len <= top_k
        or (
            isinstance(config.top_k_starting_layer, int)
            and config.top_k_starting_layer > 0
            and layer_idx < config.top_k_starting_layer
        )
    ):
        return 0
    return top_k
