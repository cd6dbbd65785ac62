"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]

vocab_true=49155 padded to 49408 (multiple of 256), as in the reference.

A copy of the reference's ``configs/granite_moe_3b_a800m.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

VOCAB_TRUE = 49155

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49408,          # padded from 49155
    head_dim=64,
    tie_embeddings=True,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (64, 256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        tie_embeddings=True, moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=32))
