"""Configuration system of the PyTorch port, copied from the JAX package's
``repro/configs/base.py`` (the port imports nothing of that package).

Every architecture is a :class:`ModelConfig`; the four input shapes are
:class:`ShapeConfig` instances; a training run is a :class:`RunConfig`
with its :class:`OptimizerConfig`.  Configs are frozen dataclasses, so they
hash into plan-cache keys.  The copy keeps every field and method of the
original, so a test can hold each registered config field-equal, and each
method's result equal, to its JAX counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; identical across all LM-family archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) workload cell.

    ``kind`` selects which step function the cell lowers:
      * ``train``   -> ``train_step``   (forward + backward + optimizer)
      * ``prefill`` -> ``serve_step``   (full-sequence forward, cache build)
      * ``decode``  -> ``serve_step``   (1 new token against a seq_len cache)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all 10 assigned families."""

    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid | rwkv

    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # partial rotary (stablelm-2: 0.25)

    # --- norms / activations ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # expert-parallel slot layout: experts are stored as ``ep_slots`` slots of
    # hidden-shard width d_ff/(ep_slots/n_experts), so an 8-expert model can
    # occupy a 16-way model axis (grok: 16 slots = 8 experts x 2-way hidden).
    # 0 -> n_experts (one slot per expert, no hidden split).
    ep_slots: int = 0
    # sequence chunking through the MoE layer: bounds the all-to-all dispatch
    # buffer and pipelines dispatch chunks (partitioned-communication style).
    moe_seq_chunk: int = 0  # 0 = whole sequence at once
    # FSDP-style 2-D expert sharding: layer-stack dim over the data axes in
    # addition to slots over model (grok: 618 GB of expert weights would
    # otherwise replicate across data-parallel replicas -> 39 GB/chip).
    # GSPMD re-gathers each layer's slice inside the scan (the FSDP price,
    # visible in the roofline collective term).
    fsdp_experts: bool = False

    # --- vision (llama-3.2-vision): cross-attention image layers ---
    n_cross_layers: int = 0  # number of cross-attn layers interleaved
    cross_every: int = 0  # a cross layer after every N self layers
    vision_tokens: int = 1601  # stub patch-embedding count per image
    d_vision: int = 1280  # stub vision embedding width

    # --- audio (hubert): frame-embedding stub + mask-predict head ---
    audio_frontend_stub: bool = False

    # --- SSM / RWKV / hybrid ---
    ssm_state: int = 0  # Mamba2 state size N
    ssm_heads: int = 0  # Mamba2 value heads
    ssm_expand: int = 2  # d_inner = expand * d_model
    conv_kernel: int = 4
    rwkv_head_size: int = 64
    attn_every: int = 0  # zamba2: shared attention block every N ssm blocks
    scan_chunk: int = 0  # WKV/SSD intra-chunk length (0 = family default;
    #   bigger chunks = fewer sequential steps but a larger pairwise tensor —
    #   swept in EXPERIMENTS.md §Perf extras)

    # --- numerics / memory policy ---
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for very large models (grok)
    remat: str = "none"  # none | dots | full
    logits_chunk: int = 0  # chunked loss for huge vocabs (0 = off)
    # gradient accumulation: scan over this many microbatches per step so the
    # per-layer activation carry fits HBM (launchers clamp to the batch/data
    # divisibility; see launch/dryrun.py)
    train_microbatches: int = 1
    grad_accum_dtype: str = "float32"  # bf16 for grok (memory note in config)

    # --- distribution defaults (overridable per run) ---
    sequence_parallel_prefill: bool = True  # ring attention for prefill shapes
    partitioned_collectives: bool = True  # paper technique on by default
    halo_n_parts: int = 4  # default partition count for partitioned comm

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k is runnable."""
        return self.family in ("ssm", "hybrid", "rwkv")

    def shapes(self) -> list[ShapeConfig]:
        """The live cells for this arch (skips per DESIGN.md §4)."""
        out = [TRAIN_4K, PREFILL_32K]
        if not self.is_encoder_only:
            out.append(DECODE_32K)
            if self.supports_long_context:
                out.append(LONG_500K)
        return out

    def skipped_shapes(self) -> list[tuple[str, str]]:
        out = []
        if self.is_encoder_only:
            out.append(("decode_32k", "encoder-only: no decode step"))
            out.append(("long_500k", "encoder-only: no decode step"))
        elif not self.supports_long_context:
            out.append(("long_500k", "full quadratic attention: skipped per spec"))
        return out

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (validated against published sizes)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            qkv = d * (n_q * hd) + 2 * d * (n_kv * hd)
            if self.qkv_bias:
                qkv += n_q * hd + 2 * n_kv * hd
            o = (n_q * hd) * d
            return qkv + o

        def mlp_params(ff: int) -> int:
            if self.act in ("silu", "geglu"):  # gated
                return 3 * d * ff
            return 2 * d * ff

        def norm_params() -> int:
            return d if self.norm == "rmsnorm" else 2 * d

        total = 0
        emb = v * d
        total += emb if self.tie_embeddings else 2 * emb
        total += norm_params()  # final norm

        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(f) + 2 * norm_params()
            # vlm: n_cross_layers of the n_layers are cross-attention layers
            n_self = self.n_layers - self.n_cross_layers
            total += n_self * per_layer
            if self.family == "vlm":
                # cross-attn layers: q from text, kv from vision tokens (+ q/k norms, gates)
                cross = (
                    d * (n_q * hd)
                    + 2 * d * (n_kv * hd)
                    + (n_q * hd) * d
                    + mlp_params(f)
                    + 2 * norm_params()
                    + 2 * hd  # q/k head norms
                    + 2  # attn/ffn tanh gates
                )
                total += self.n_cross_layers * cross
                total += self.d_vision * d  # patch-embedding projection stub
        elif self.family == "audio":
            per_layer = attn_params() + mlp_params(f) + 2 * norm_params()
            total += self.n_layers * per_layer
            total += self.d_vision * d  # frame-embedding projection stub
        elif self.family == "moe":
            expert = mlp_params(f)
            router = d * self.n_experts
            per_layer = (
                attn_params() + self.n_experts * expert + router + 2 * norm_params()
            )
            total += self.n_layers * per_layer
        elif self.family == "rwkv":
            # time-mix: r,k,v,g,o (d*d) + w lora + u;  channel-mix: k (d*f), v (f*d), r (d*d)
            tm = 5 * d * d + 6 * 32 * d * 2 + d  # lora(32) decay proj + bonus u
            cm = d * f + f * d + d * d
            total += self.n_layers * (tm + cm + 2 * norm_params())
        elif self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = (di + 2 * ns) * self.conv_kernel
            out_proj = di * d
            total += self.n_layers * (in_proj + conv + out_proj + nh + nh + norm_params())
        elif self.family == "hybrid":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = (di + 2 * ns) * self.conv_kernel
            out_proj = di * d
            mamba = in_proj + conv + out_proj + 2 * nh + norm_params()
            total += self.n_layers * mamba
            # one shared attention+mlp block (applied every attn_every layers)
            shared = attn_params() + mlp_params(f) + 2 * norm_params()
            # zamba2 concatenates [x, emb] into the shared block: first-proj doubled
            shared += d * (n_q * hd)  # extra input width for q
            total += shared
        else:
            raise ValueError(self.family)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        expert = 3 * d * f if self.act in ("silu", "geglu") else 2 * d * f
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return self.param_count() - inactive

    # ------------------------------------------------------------------
    def model_flops_per_token(self, seq_len: int, kind: str = "train") -> float:
        """MODEL_FLOPS term: 6*N (train) / 2*N (inference) per token, dense or
        active-param based, plus quadratic attention term where applicable."""
        n = self.active_param_count()
        mult = 6.0 if kind == "train" else 2.0
        flops = mult * n
        if self.family not in ("ssm", "rwkv") and self.n_heads:
            # attention scores+values: 2 * 2 * d_attn * seq (causal halves it)
            d_attn = self.n_heads * self.resolved_head_dim
            causal_factor = 0.5 if self.causal else 1.0
            att = mult * 2 * d_attn * seq_len * causal_factor
            n_attn_layers = (
                self.n_layers
                if self.family != "hybrid"
                else max(1, self.n_layers // max(1, self.attn_every))
            )
            flops += att * (
                n_attn_layers / max(1, self.n_layers)
            ) * self.n_layers  # == att * n_attn_layers
        return flops

    def with_updates(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=64,
            d_ff=128,
            vocab_size=128,
            remat="none",
            logits_chunk=0,
            halo_n_parts=2,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4, head_dim=16)
        if self.family == "moe":
            # capacity high enough that no token drops: prefill/full-forward
            # equivalence is exact in smoke tests (drop semantics are covered
            # by tests/models/test_moe.py)
            kw.update(n_experts=4, top_k=2, ep_slots=0, capacity_factor=8.0,
                      moe_seq_chunk=0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_heads=4, attn_every=2 if self.attn_every else 0)
        if self.family == "rwkv":
            kw.update(rwkv_head_size=16)
        if self.family in ("vlm", "audio"):
            kw.update(d_vision=32, vision_tokens=8)
        if self.family == "vlm":
            kw.update(n_cross_layers=1, cross_every=2)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Run / training configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # ZeRO-1: shard optimizer state over the data axis where divisible
    zero1: bool = True
    # gradient compression (beyond-paper distributed-optimization trick)
    grad_compression: str = "none"  # none | bf16 | int8_stochastic
    # partitioned (bucketed/chunked) gradient collectives
    partitioned_grad_buckets: int = 0  # 0 = single fused collective


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig = TRAIN_4K
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    # checkpointing / fault tolerance
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    resume: bool = True
    # straggler mitigation
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0

    @property
    def microbatch(self) -> int:
        return self.shape.global_batch


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401  (imports all arch modules)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from repro_torch import configs as _c  # noqa: F401

    return dict(_REGISTRY)
