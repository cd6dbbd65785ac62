"""Deterministic synthetic data pipeline + abstract input specs (torch port
of the reference's ``data/pipeline.py``).

``input_specs(cfg, shape)`` returns ``meta`` tensors for every model input
of a cell (shapes and dtypes, no storage). ``synthetic_batch`` draws the
same shapes from ``np.random.default_rng(seed)`` in the reference's order
(tokens, then the encoder's frames or the image embeddings), so every batch
is bitwise the reference's: labels are the tokens rolled left by one;
``rng.normal(...) * 0.02`` is rounded to the compute dtype as the
reference's ``jnp.asarray`` rounds it. ``SyntheticLoader`` steps the seed
by 7,919 per batch and prefetches one batch ahead.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import dtype_of

META = torch.device("meta")


def _extras_spec(cfg: ModelConfig, batch: int, device: torch.device,
                 rng: Optional[np.random.Generator] = None) -> Dict:
    out: Dict = {}
    dt = dtype_of(cfg.dtype)
    for family, key, n in (("vlm", "image_embeds", cfg.num_image_tokens),
                           ("encdec", "frames", cfg.encoder_seq)):
        if cfg.family != family:
            continue
        shp = (batch, n, cfg.d_model)
        out[key] = (torch.empty(shp, dtype=dt, device=device)
                    if rng is None else torch.from_numpy(
                        rng.normal(size=shp) * 0.02).to(dt).to(device))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract inputs for one cell (train/prefill: full batch; decode: the
    per-step token batch — the KV/tier state is built by
    serve.init_serve_state), as ``meta`` tensors."""
    b = shape.global_batch

    def ints(*shp):
        return torch.empty(shp, dtype=torch.int32, device=META)

    if shape.kind == "train":
        specs = {"tokens": ints(b, shape.seq_len),
                 "labels": ints(b, shape.seq_len)}
        specs.update(_extras_spec(cfg, b, META))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": ints(b, shape.seq_len)}
        specs.update(_extras_spec(cfg, b, META))
        return specs
    # decode: one new token per sequence
    return {"tokens": ints(b, 1)}


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    kind: str = "train", device="cuda") -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    out = {"tokens": torch.from_numpy(toks).to(dev)}
    if kind == "train":
        out["labels"] = torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev)
    out.update(_extras_spec(cfg, batch, dev, rng=rng))
    return out


class SyntheticLoader:
    """Sharded, prefetching synthetic loader (host-side double buffering)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1, device="cuda"):
        assert batch % num_shards == 0
        self.cfg, self.batch, self.seq = cfg, batch // num_shards, seq
        self.seed = seed * num_shards + shard_id
        self.device = resolve_device(device)
        self._step = 0
        self._next = None

    def _make(self, step: int) -> Dict:
        return synthetic_batch(self.cfg, self.batch, self.seq,
                               seed=self.seed + step * 7919,
                               device=self.device)

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        if self._next is None:
            self._next = self._make(self._step)
        cur = self._next
        self._step += 1
        self._next = self._make(self._step)   # prefetch next
        return cur
