"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=13440 vocab=92416 — qwen1.5 arch. [hf:Qwen/CodeQwen1.5-7B]

A copy of the reference's ``configs/codeqwen15_7b.py``."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    head_dim=128,
    rope_theta=1_000_000.0,
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (32, 64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16)
