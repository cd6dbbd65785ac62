"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, sliding-window attention. [arXiv:2401.16818]

A copy of the reference's ``configs/h2o_danube_3_4b.py``."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    rope_theta=500_000.0,
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (32, 64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        sliding_window=32)
