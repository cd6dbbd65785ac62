"""The one generator of the benchmark's inputs: token streams drawn from the
run's seed. Every draw is named by (stream, index), so a given seed gives the
same prompts to every run and to the reference, and the sizes of the work
come from the cell's file, never from the seed."""
from __future__ import annotations

import torch

MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit seed for draw ``index`` of ``stream`` under ``seed``."""
    h = 1469598103934665603
    for ch in f"{seed}/{stream}/{index}".encode():
        h = ((h ^ ch) * 1099511628211) & MASK
    return h


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def tokens(seed: int, stream: str, index: int, shape, vocab: int,
           device) -> torch.Tensor:
    """Token ids uniform over the vocabulary, int32."""
    return torch.randint(0, vocab, tuple(shape), dtype=torch.int32,
                         device=device,
                         generator=generator(seed, stream, index, device))


def sample(seed: int, stream: str, n: int, k: int) -> list:
    """``k`` distinct indices below ``n``, sorted, drawn from the seed."""
    g = generator(seed, stream, 0, "cpu")
    return sorted(torch.randperm(n, generator=g)[:k].tolist())
