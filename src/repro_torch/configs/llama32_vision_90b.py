"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 5th layer (80 self + 20 gated
cross). Vision frontend is a STUB: the model takes patch embeddings
[B, 1600, 8192]. [hf:meta-llama/Llama-3.2-11B-Vision family]

A copy of the reference's ``configs/llama32_vision_90b.py``."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    num_image_tokens=1600,
    rope_theta=500_000.0,
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (16, 64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        cross_attn_every=2, num_image_tokens=8)
