"""Parameter-tree checkpoints: one ``.npz`` of the leaves plus a json
manifest (port of ``repro/checkpoint/io.py``, the same file format).

Leaves are stored flat under their tree path joined by '/' (dict keys,
list indices; ``io.py:18``) in one compressed ``.npz`` with a ``__meta__``
json entry ``{"step", "keys", "extra"}``, written atomically by rename. The
keys come from the same walk of the tree as the reference's
``tree_flatten_with_path``, so a checkpoint written by either package loads
into the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from ..models.params import FlatParams, leaves_with_path, path_key


def _arrays(tree) -> Dict[str, np.ndarray]:
    src = tree.tree if isinstance(tree, FlatParams) else tree
    return {path_key(path): leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf)
            for path, leaf in leaves_with_path(src)}


def save_checkpoint(path: str, tree: Any, step: int = 0, extra: Dict | None = None):
    """Write ``tree`` (a ``FlatParams`` or a tree of tensors / arrays)."""
    arrays = _arrays(tree)
    meta = {"step": int(step), "keys": sorted(arrays.keys()), "extra": extra or {}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like``; returns (params, meta).

    For a ``FlatParams`` ``like``, a new ``FlatParams`` on its device with
    the bf16 copy refreshed; for a tree of tensors, a tree of tensors of
    ``like``'s dtypes and devices. Every leaf's shape is checked."""
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
        arrays = {k: zf[k] for k in meta["keys"]}
    src = like.tree if isinstance(like, FlatParams) else like

    def leaf_array(tree_path, leaf) -> np.ndarray:
        key = path_key(tree_path)
        if key not in arrays:
            raise KeyError(f"checkpoint {path!r} has no leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
        return arr

    if isinstance(like, FlatParams):
        flat = np.concatenate([np.asarray(leaf_array(p, leaf), np.float32).reshape(-1)
                               for p, leaf in leaves_with_path(src)])
        return FlatParams(like.spec, like.device).load_flat(torch.from_numpy(flat)), meta

    def rebuild(node, tree_path=()):
        if isinstance(node, dict):
            return {k: rebuild(v, tree_path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, tree_path + (i,)) for i, v in enumerate(node)]
        arr = np.array(leaf_array(tree_path, node))
        return torch.from_numpy(arr).to(dtype=node.dtype, device=node.device)

    return rebuild(src), meta
