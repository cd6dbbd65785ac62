"""Configuration for the port (a copy of the reference's ``configs/base.py``).

A ``ModelConfig`` fully describes one architecture (with its ``MoEConfig``
or ``SSMConfig``); ``ShapeConfig`` is one assigned input-shape cell
(``SHAPES``); ``TieringConfig`` carries the Equilibria fairness parameters
(paper §IV); ``TrainConfig`` the optimizer, schedule, remat and checkpoint
settings of the training step.

The reference's ``MeshConfig`` (the 16 x 16 and 2 x 16 x 16 TPU meshes)
has no counterpart: the port trains and serves on one card, where every
logical axis maps to that card and the mesh is nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N: SSM state size
    head_dim: int = 64            # P: channels per SSM head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    ngroups: int = 1
    chunk_size: int = 256         # Q: SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA window (tokens), None = full attn
    swa_pattern: int = 1                  # every n-th layer is SWA (1 = all)
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                     # silu (SwiGLU) | gelu (fc1/fc2)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- hybrid (zamba2-style): mamba backbone + shared attention block ---
    hybrid_attn_every: int = 6            # shared attn block every N mamba blocks
    # --- enc-dec (whisper-style) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500               # fixed frame count from the (stub) frontend
    # --- vlm (llama3.2-vision-style): gated cross-attn every N layers ---
    cross_attn_every: int = 0             # 0 = no cross-attn layers
    num_image_tokens: int = 1600          # (stub) patch embeddings per sample
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_path(self) -> bool:
        """True if the arch can run long_500k (SSM / hybrid / SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec (whisper)

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
        o = (self.num_heads * hd) * d
        attn = qkv + o
        if self.act == "silu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "moe":
            assert self.moe is not None
            mlp = self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
        if self.family == "ssm":
            assert self.ssm is not None
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            inproj = d * (2 * di + 2 * self.ssm.ngroups * self.ssm.state_dim + nh)
            conv = (di + 2 * self.ssm.ngroups * self.ssm.state_dim) * self.ssm.conv_width
            per_layer = inproj + conv + di * d + 2 * nh + di
            emb = self.vocab_size * d
            return self.num_layers * per_layer + emb + (0 if self.tie_embeddings else emb)
        per_layer = attn + mlp + 2 * d
        if self.family == "hybrid":
            assert self.ssm is not None
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            inproj = d * (2 * di + 2 * self.ssm.ngroups * self.ssm.state_dim + nh)
            mamba_layer = inproj + di * d + di
            n_shared_applications = self.num_layers // self.hybrid_attn_every
            shared = attn + mlp + 2 * d * d  # one shared block + concat projections
            emb = self.vocab_size * d
            return self.num_layers * mamba_layer + shared + 2 * emb + n_shared_applications * 0
        n_layers = self.num_layers
        if self.family == "vlm" and self.cross_attn_every > 0:
            # num_layers counts self+cross; cross layers have attn (no kv grouping change) + mlp
            pass
        emb = self.vocab_size * d
        total = n_layers * per_layer + emb + (0 if self.tie_embeddings else emb)
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * attn  # cross-attn in decoder layers
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d = self.d_model
        dense_mlp_all = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active_mlp = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return self.param_count() - self.num_layers * (dense_mlp_all - active_mlp)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TieringConfig:
    """Equilibria fairness parameters (paper §IV). Page sizes are in 'pages'."""
    n_tenants: int = 4
    n_fast_pages: int = 4096          # fast-tier pool (local DRAM / HBM analogue)
    n_slow_pages: int = 4096          # slow-tier pool (CXL analogue)
    page_tokens: int = 64             # tokens per KV page (serving path)
    # per-tenant policy (paper §IV-B): lower protection and upper bound, in pages.
    lower_protection: Tuple[int, ...] = ()
    upper_bound: Tuple[int, ...] = () # 0 entries mean "no bound"
    # fair-share weights for churn-time policy re-partitioning (consumed only
    # by the dynamic-ownership engine)
    tenant_weights: Tuple[float, ...] = ()
    # demotion/promotion machinery
    watermark_free: float = 0.02      # keep this fraction of fast pages free
    p_base: int = 256                 # unthrottled promotion scan per tick (pages)
    promo_hot_threshold: float = 2.0  # hint-fault analogue: promote after ~2 accesses
    promo_floor: float = 1.0 / 16.0   # Eq.2 floor
    # thrashing mitigation (paper §IV-F)
    thrash_table_slots: int = 1024
    t_resident: int = 8               # ticks: promoted->demoted faster than this = thrash
    r_thrashing: float = 32.0         # thrash events / period threshold
    controller_period: int = 5        # ticks between controller runs (paper: 5 s)
    steady_active_delta: float = 0.05 # steady-state detector thresholds
    steady_free_rate: float = 0.05
    hot_decay: float = 0.85           # EWMA hotness decay per tick
    # perf model (simulator): latency units per access by tier (paper Fig.2 / §V-A:
    # CXL idle latency 252ns vs ~100ns local)
    lat_fast: float = 1.0
    lat_slow: float = 2.5
    migration_cost: float = 0.0005    # system-wide stall per migrated page (noisy neighbor)
    enable_protection: bool = True
    enable_upper_bound: bool = True
    enable_promo_throttle: bool = True
    enable_thrash_mitigation: bool = True
    # observability (obs/, paper §IV-C): in-graph stats + migration ring
    obs_ring_capacity: int = 4096     # migration events kept (newest wins)
    obs_resid_buckets: int = 16       # log2 residency-histogram buckets
    obs_window_decay: float = 0.9     # EWMA decay of windowed rates

    def with_(self, **kw) -> "TieringConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1             # gradient accumulation
    remat_policy: str = "block"       # none | block | dots_saveable | full
    grad_compression: bool = False    # int8 error-feedback DP all-reduce
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
