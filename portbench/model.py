"""The system under test's model, built from a configuration's file: the
program's ``ModelConfig`` from its ``port`` table, and the program's model
with weights drawn on the device from the run's seed, one large draw per
weight tensor.

Each weight matrix is drawn with std 1 / sqrt(fan-in), its fan-in the
inputs one output sums over (``d`` for ``wq``, ``H x D`` for an attention
``wo``, the rows of a matrix otherwise); embeddings with std 1, the
program's "small" weights with std 0.02, norms at 1 and biases at 0. So
every layer's weights have the same distribution at any depth, and a cut
in depth needs no rescaling. (The program's own rule, scale / sqrt of a
stacked weight's first axis, the layer count, draws weights some 12 times
that, which saturate every softmax, so that bfloat16's rounding flips the
attention of whole heads and moves the logits as far as a float8 control.)
"""
from __future__ import annotations

import math

import torch

from portbench import traffic


def model_config(conf: dict):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    port = dict(conf["port"])
    ssm = port.pop("ssm", None)
    return ModelConfig(**port, ssm=None if ssm is None else SSMConfig(**ssm))


def fan_in(path: tuple, shape) -> int:
    """Inputs summed into one output of the weight at ``path`` (its keys
    from the root of the tree) of ``shape``, a stacked weight's layer axis
    first: attention's ``wq``, ``wk``, ``wv`` [.., d, n, D] sum over d, its
    ``wo`` [.., H, D, d] over H x D, a matrix [.., in, out] over in."""
    if path[-2:-1] == ("attn",):
        if path[-1] in ("wq", "wk", "wv"):
            return shape[-3]
        if path[-1] == "wo":
            return shape[-3] * shape[-2]
    return shape[-2]


def std_of(path: tuple, spec) -> float:
    if spec.init == "embed":
        return 1.0
    if spec.init == "small":
        return 0.02
    return spec.scale / math.sqrt(fan_in(path, spec.shape))


@torch.no_grad()
def draws(cfg, tree, seed: int):
    """Every weight the seed draws for ``tree`` (the program's parameter
    tree at ``cfg``), one at a time in sorted key order: yields (its key
    path joined by ".", its leaf in ``tree``, a new tensor drawn like the
    leaf). Only one drawn tensor is alive at a time."""
    from repro_torch.models.transformer import model_specs
    gen = None

    def walk(specs, tree, path):
        nonlocal gen
        for k in sorted(specs):
            spec, t = specs[k], tree[k]
            if isinstance(spec, dict):
                yield from walk(spec, t, path + (k,))
                continue
            w = torch.empty_like(t)
            if spec.init == "zeros":
                w.zero_()
            elif spec.init == "ones":
                w.fill_(1.0)
            else:
                if gen is None:
                    gen = traffic.generator(seed, "weights", 0, t.device)
                w.normal_(0.0, std_of(path + (k,), spec), generator=gen)
            yield ".".join(path + (k,)), t, w

    yield from walk(model_specs(cfg), tree, ())


@torch.no_grad()
def fill_weights(model, cfg, seed: int) -> None:
    """Draw every weight of ``model`` in place from ``seed``."""
    for _, leaf, w in draws(cfg, model.tree(), seed):
        leaf.copy_(w)


def build(conf: dict, cfg, seed: int, device):
    """The program's model at ``cfg`` with weights drawn from ``seed``."""
    from repro_torch.models.transformer import make_model
    model = make_model(cfg, seed=None, device=device)
    fill_weights(model, cfg, seed)
    return model
