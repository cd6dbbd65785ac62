"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE weight-shared attention
block applied every 6 layers on concat(hidden, embeddings). [arXiv:2411.15242]

A copy of the reference's ``configs/zamba2_7b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig


CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,            # mamba blocks; shared attn applied every 6
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    hybrid_attn_every=6,
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  ngroups=1, chunk_size=256),
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (32, 256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        hybrid_attn_every=2,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      ngroups=1, chunk_size=8))
