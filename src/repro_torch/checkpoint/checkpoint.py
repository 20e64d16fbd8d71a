"""Checkpoints in the reference's ``.npz`` layout
(``repro.checkpoint.checkpoint`` on PyTorch).

Leaves are saved under their ``/``-joined paths (dict keys, tuple
indices), the step under ``__step__``, and a per-layer list is stacked on
a leading axis, as the reference holds it. So a checkpoint of
``(params, opt_state)`` written by either package restores in the other.
bf16 leaves are written as float32 (NumPy has no bf16) and cast back to
the dtype of the tree they restore into. The write is atomic (temporary
file + rename).

On a mesh, as the reference's ``device_put`` with shardings: saving a
tree of DTensors gathers it leaf by leaf (every rank takes part) and rank
0 alone keeps the gathered leaves and writes the file, the other ranks
waiting at a barrier until it is in place; ``restore_checkpoint(path,
like, shardings, mesh)`` reads one leaf at a time and each rank keeps its
shard of it, so no card ever holds the whole tree. A checkpoint written on
one mesh, unsharded, or by the reference restores onto any mesh, and one
written on a mesh restores unsharded.
"""
from __future__ import annotations

import functools
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models.sharding import is_dtensor, local_shard


def _numpy(leaf: Any, keep: bool = True) -> Optional[np.ndarray]:
    """The leaf on the host; a DTensor is gathered first (a collective:
    every rank calls it), and only a rank that ``keep``s it copies it."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
        if not keep:
            return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: tuple, out: dict, keep: bool) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, prefix + (str(k),), out, keep)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _flatten(v, prefix + (str(i),), out, keep)
    elif isinstance(tree, list):         # per-layer: stack on axis 0
        def stack(*xs):
            got = [_numpy(x, keep) for x in xs]
            return np.stack(got) if keep else None
        _flatten(T.tree_map(stack, *tree), prefix, out, keep)
    elif keep:
        out["/".join(prefix)] = _numpy(tree)
    else:
        _numpy(tree, keep)


def save_checkpoint(path: str | Path, tree: Any,
                    step: Optional[int] = None) -> None:
    """Write ``tree`` (nested dicts, tuples, per-layer lists of tensors or
    DTensors) to ``path`` atomically. With DTensors every rank calls it
    and returns once rank 0 has written the file."""
    import torch.distributed as dist
    sharded = any(is_dtensor(x) for x in T.leaves(tree))
    writer = not sharded or dist.get_rank() == 0
    path = Path(path)
    flat: dict = {}
    _flatten(tree, (), flat, writer)
    try:
        if writer:
            if step is not None:
                flat["__step__"] = np.asarray(step)
            _write(path, flat)
    finally:
        if sharded:
            dist.barrier()


def _write(path: Path, flat: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _restore(like: Any, place: Any, prefix: tuple, read: Callable,
             layer: Optional[int], mesh) -> Any:
    if isinstance(like, dict):
        return {k: _restore(v, None if place is None else place[k],
                            prefix + (str(k),), read, layer, mesh)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        out = [_restore(v, None if place is None else place[i],
                        prefix if isinstance(like, list)
                        else prefix + (str(i),), read,
                        i if isinstance(like, list) else layer, mesh)
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    arr = read("/".join(prefix))
    if layer is not None:
        arr = arr[layer]
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr))
    if place is None:
        return t.to(device=like.device, dtype=like.dtype)
    from torch.distributed.tensor import DTensor
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = local_shard(t, mesh, place).to(device=dev, dtype=like.dtype,
                                           memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, place, run_check=False)


def restore_checkpoint(path: str | Path, like: Any,
                       shardings: Optional[Any] = None,
                       mesh=None) -> tuple[Any, int]:
    """Restore into the structure and dtypes of ``like``; returns (tree,
    step). Unsharded, each leaf goes to its ``like`` leaf's device. With
    ``shardings`` (a tree of DTensor placements of ``like``'s structure,
    as ``sharded_step``'s ``shardings``) and its ``mesh``, each leaf
    becomes a DTensor of its placements on that mesh whose local shard
    alone reaches this rank's device; ``like``'s leaves then give only
    their dtypes (they may lie on ``meta``)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("shardings and their mesh come together")
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data.files else 0

        @functools.lru_cache(maxsize=1)     # a per-layer stack, read once
        def read(key: str) -> np.ndarray:
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            return data[key]
        tree = _restore(like, shardings, (), read, None, mesh)
    return tree, step
