"""Checkpointing with atomic commit, async write, and restore onto the
current device (torch port of the reference's ``checkpoint/sharded.py``).

Layout: <dir>/step_<N>/
  manifest.json        tree structure, shapes, dtypes, step, save-time metadata
  <leaf-path>.npy      one file per leaf (copied to the host)

The layout, the manifest and the leaf keys are the reference's: a leaf's
key is its path parts joined by ``//`` (dict keys, NamedTuple field names,
tuple indices; a module's parameters and the optimizer's dicts keyed by
dotted parameter names split at the dots, so a parameter's key is the
reference's tree path), its file that key with every ``/`` replaced by
``_``. A float32 or int32 tree that either package saved restores bitwise
in the other. A bfloat16 leaf, which numpy cannot hold, is stored as its
uint16 bits with ``"bfloat16"`` as its manifest dtype.

Writes go to step_<N>.tmp/ and are renamed into place (atomic commit): a
crash mid-write never corrupts the latest checkpoint. ``AsyncCheckpointer``
copies the leaves to the host inline (the only synchronous part) and
serializes them on a background thread, so the train loop is not blocked.

Restore: leaves are plain host arrays; ``restore(..., device=)`` puts each
tensor leaf on the given device (the one-card form of the reference's
elastic re-sharding), else on the device of the matching leaf of ``like``.
A module in ``like`` is restored in place (its parameters overwritten) and
returned.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_SEP = "//"
BF16 = "bfloat16"


def _children(node, path: tuple):
    """(path, child) pairs of a container, or None for a leaf."""
    if isinstance(node, nn.Module):
        return [(path + tuple(n.split(".")), p)
                for n, p in node.named_parameters()]
    if isinstance(node, dict):
        return [(path + tuple(str(k).split(".")), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(path + (f,), getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(path + (str(i),), v) for i, v in enumerate(node)]
    return None


def _flatten(tree) -> Dict[str, Any]:
    """{key: leaf} of a tree (``None`` holds no leaf, as in the
    reference)."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node, path)
        if kids is None:
            out[_SEP.join(path)] = node
        else:
            for p, v in kids:
                walk(v, p)

    walk(tree, ())
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array of its own (never a view of the live leaf)
    and its manifest dtype."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _host_leaves(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _to_host(v) for k, v in _flatten(tree).items()}


def _write(ckpt_dir: str, step: int, host: Dict, extra: Optional[dict],
           keep: int) -> Path:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, (arr, dtype) in host.items():
        fn = key.replace("/", "_").replace(_SEP, ".") + ".npy"
        np.save(tmp / fn, arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _gc(base, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> Path:
    """Synchronous atomic checkpoint save."""
    return _write(ckpt_dir, step, _host_leaves(tree), extra, keep)


class AsyncCheckpointer:
    """Background-thread checkpointing: device->host copy happens inline
    (cheap), serialization + fsync on the worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        host = _host_leaves(tree)
        self.wait()
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, host, extra, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp")
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: Optional[int], like: Any,
            device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, arrays,
    modules or ``meta`` tensors). Tensor leaves come back as tensors on
    ``device`` (else on their ``like`` leaf's device; the CPU for a
    ``meta`` leaf), array leaves as numpy arrays; a module's parameters
    are overwritten in place."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    def load(path: tuple):
        info = manifest["leaves"][_SEP.join(path)]
        return np.load(d / info["file"]), info["dtype"]

    def build(node, path: tuple):
        if node is None:
            return None
        if isinstance(node, nn.Module):
            with torch.no_grad():
                for p_path, p in _children(node, path):
                    p.copy_(_tensor(*load(p_path)))
            return node
        kids = _children(node, path)
        if kids is not None:
            vals = [build(v, p) for p, v in kids]
            if isinstance(node, dict):
                return dict(zip(node.keys(), vals))
            if hasattr(node, "_fields"):
                return type(node)(*vals)
            return type(node)(vals)
        arr, dtype = load(path)
        if not torch.is_tensor(node):
            return arr
        dev = device if device is not None else (
            "cpu" if node.is_meta else node.device)
        return _tensor(arr, dtype).to(dev)

    return build(like, ())


def restore_extra(ckpt_dir: str, step: Optional[int] = None) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text()).get("extra", {})


def _gc(base: Path, keep: int):
    steps = sorted(p for p in base.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
