"""Checkpoints in the reference's ``.npz`` layout
(``repro.checkpoint.checkpoint`` on PyTorch).

Leaves are saved under their ``/``-joined paths (dict keys, tuple
indices), the step under ``__step__``, and a per-layer list is stacked on
a leading axis, as the reference holds it. So a checkpoint of
``(params, opt_state)`` written by either package restores in the other.
bf16 leaves are written as float32 (NumPy has no bf16) and cast back to
the dtype of the tree they restore into. The write is atomic (temporary
file + rename). Restoring onto a mesh waits for the pod layer.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: tuple, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, prefix + (str(k),), out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _flatten(v, prefix + (str(i),), out)
    elif isinstance(tree, list):         # per-layer: stack on axis 0
        _flatten(T.tree_map(lambda *xs: np.stack([_numpy(x) for x in xs]),
                            *tree), prefix, out)
    else:
        out["/".join(prefix)] = _numpy(tree)


def save_checkpoint(path: str | Path, tree: Any,
                    step: Optional[int] = None) -> None:
    """Write ``tree`` (nested dicts, tuples, per-layer lists of tensors)
    to ``path`` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat: dict = {}
    _flatten(tree, (), flat)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _restore(like: Any, prefix: tuple, flat: dict,
             layer: Optional[int]) -> Any:
    if isinstance(like, dict):
        return {k: _restore(v, prefix + (str(k),), flat, layer)
                for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(_restore(v, prefix + (str(i),), flat, layer)
                     for i, v in enumerate(like))
    if isinstance(like, list):
        return [_restore(v, prefix, flat, i) for i, v in enumerate(like)]
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key] if layer is None else flat[key][layer]
    if not isinstance(like, torch.Tensor):
        return arr
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def restore_checkpoint(path: str | Path, like: Any) -> tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``like``; returns
    (tree, step)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__", np.asarray(0)))
    return _restore(like, (), flat, None), step
