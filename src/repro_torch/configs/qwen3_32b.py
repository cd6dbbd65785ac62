"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]

A copy of the reference's ``configs/qwen3_32b.py``."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (32, 64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True)
