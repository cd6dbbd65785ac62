"""One-card dry run: what of every (arch x shape) cell fits one card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_32b \\
      --shape train_4k

Of the reference's ``launch/dryrun.py`` (which lowers and compiles every
cell on the 256- and 512-chip TPU meshes and records XLA's memory, cost
and collective analysis) this keeps only what carries over to one card:
for each (arch x ``shape_cells``) cell, the parameter count and the bytes
of the parameters (``param_dtype``) and, for a training cell, of their
gradients and AdamW's m and v (float32: 16 B a parameter at float32
masters), and whether they fit the card's 80 GB. No lowering, no compile,
no collectives (one card has none), and no activation bytes: a cell that
does not fit here does not fit before its first activation.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config, shape_cells
from repro_torch.configs.base import SHAPES
from repro_torch.models.params import dtype_of, param_bytes, param_count
from repro_torch.models.transformer import model_specs

CARD_BYTES = 80e9                 # H100 SXM device memory
OPT_BYTES = 8                     # AdamW m and v, float32


def cell_bytes(arch: str, shape_name: str, cfg=None) -> dict:
    """The cell's parameter count and state bytes on one card."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    specs = model_specs(cfg)
    n = param_count(specs)
    p_bytes = param_bytes(specs, dtype_of(cfg.param_dtype))
    train = shape.kind == "train"
    g_bytes = p_bytes if train else 0
    o_bytes = n * OPT_BYTES if train else 0
    total = p_bytes + g_bytes + o_bytes
    return {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "num_layers": cfg.num_layers, "params": n,
            "param_bytes": p_bytes, "grad_bytes": g_bytes,
            "opt_bytes": o_bytes, "state_bytes": total,
            "fits": total <= CARD_BYTES}


def all_cells() -> list:
    return [cell_bytes(a, sh.name) for a in ARCH_IDS for sh in shape_cells(a)]


def format_cell(rec: dict) -> str:
    return (f"{'fits' if rec['fits'] else 'FULL'} {rec['arch']:24s} "
            f"{rec['shape']:12s} params={rec['params']:,} state="
            f"{rec['state_bytes'] / 1e9:.1f} GB (params "
            f"{rec['param_bytes'] / 1e9:.1f}, grads "
            f"{rec['grad_bytes'] / 1e9:.1f}, adamw "
            f"{rec['opt_bytes'] / 1e9:.1f}) of {CARD_BYTES / 1e9:.0f} GB")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        recs = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        recs = [cell_bytes(args.arch, args.shape)]
    for rec in recs:
        print(format_cell(rec))


if __name__ == "__main__":
    main()
