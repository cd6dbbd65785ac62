"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]

A copy of the reference's ``configs/mixtral_8x22b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig


CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (16, 64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        sliding_window=32, moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128))
