"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

As in the reference: vocab_true=50280 padded to 50432 (x256); SSM
head_dim=48 (32 heads) instead of the GPU default 64 (24 heads).

A copy of the reference's ``configs/mamba2_130m.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

VOCAB_TRUE = 50280

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,              # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50432,         # padded from 50280
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=48, expand=2, conv_width=4,
                  ngroups=1, chunk_size=256),
)


# (sequences, decode steps) of the serving load the port is measured at
SERVE_LOAD = (64, 256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", num_layers=2, d_model=64,
        num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=256,
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      ngroups=1, chunk_size=8))
