"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3, tied embeddings. [hf:meta-llama/Llama-3.2-1B]

A copy of the reference's ``configs/llama32_1b.py``."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama32-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        tie_embeddings=True)
