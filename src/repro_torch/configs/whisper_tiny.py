"""whisper-tiny [audio] — 4L(+4L enc) d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec; conv/mel frontend is a STUB: the model takes precomputed frame
embeddings [B, 1500, 384]. [arXiv:2212.04356]

vocab_true=51865 padded to 51968. A copy of the reference's
``configs/whisper_tiny.py``."""
from repro_torch.configs.base import ModelConfig

VOCAB_TRUE = 51865

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,             # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51968,         # padded from 51865
    head_dim=64,
    act="gelu",
    rope_theta=10_000.0,
)


# (sequences, decode steps) of the serving load the port is measured at:
# 64 x 256 fills 16 pages a sequence, so full_load's fast budget (768 of
# 1,024 pages) binds and pages move
SERVE_LOAD = (64, 256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec", num_layers=2, encoder_layers=2,
        encoder_seq=16, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, act="gelu")
