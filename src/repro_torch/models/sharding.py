"""Sharding rules of the model zoo as data: which mesh axes split each dim
of every parameter, batch, cache and activation tensor. The counterpart of
``repro.models.sharding``'s spec functions.

Megatron-style tensor parallelism on the ``model`` mesh axis, FSDP / ZeRO-3
storage sharding of parameters and optimizer state over the data axes
(``('data',)`` on one pod, ``('pod', 'data')`` across pods). A dim that
does not divide its axes' size stays unsharded.

Expert axis: sharded on ``model`` when n_experts % model == 0 (expert
parallelism, e.g. Arctic's 128 experts); otherwise the per-expert FFN dim
shards (tensor parallelism inside each expert, e.g. Mixtral's 8 on a wider
axis). GQA KV heads replicate over ``model`` when n_kv < model.

The functions work on ``MeshShape`` (axis names and sizes, what the
reference reads of an ``AbstractMesh``) and return ``Spec``s (one entry per
dim: None, an axis name or a tuple of names, as a ``PartitionSpec``).
Nothing is allocated: the parameter and cache trees are walked on the
``meta`` device.

The port keeps a model's layers as a list of per-layer dicts, where the
reference stacks them on a leading axis: a layer leaf's spec is the
reference's with that axis's entry dropped. The audio codebook tables are
one stacked (CB-1, V, d) tensor in both packages, so their spec keeps its
leading entry. ``param_shardings`` (the reference's ``NamedSharding``
tree) has no counterpart until the DTensor placements of the pod layer's
second half (ROADMAP queue 1 item 8b).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.models.model import ModelConfig, init_cache, init_params


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape without devices: sizes and names, in the order of
    ``AbstractMesh(axis_sizes, axis_names)``."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


class Spec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names whose product splits the dim. A tuple of one name
    is stored as the name, as ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_size(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _maybe(mesh: MeshShape, axes, dim: int):
    """Return `axes` if dim is divisible by their total size, else None."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def fsdp_axes(mesh: MeshShape):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_axes(mesh: MeshShape, batch: int):
    """Largest prefix of (pod, data) whose product divides `batch`."""
    cand = [a for a in ("pod", "data") if a in mesh.axis_names]
    chosen: list[str] = []
    prod = 1
    for a in cand:
        if batch % (prod * mesh.shape[a]) == 0:
            chosen.append(a)
            prod *= mesh.shape[a]
    return tuple(chosen) or None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig,
               mesh: MeshShape, fsdp_on: bool = True) -> Spec:
    """The spec of the port's leaf at ``path`` (the reference's path: the
    layer index left out) of ``shape``."""
    fsdp = fsdp_axes(mesh) if fsdp_on else None
    M = "model"
    stacked = 1 if path.startswith("embed_cb/") else 0   # codebook axis
    core = shape[stacked:]

    def done(*spec):
        return Spec(*([None] * stacked), *spec)

    # --- norms / scalars -------------------------------------------------
    last = path.rsplit("/", 1)[-1]
    if last in ("scale", "bias", "A_log", "D", "dt_bias", "conv_b") or len(core) == 0:
        return done(*([None] * len(core)))
    if last == "b":            # projection bias (fused head dim)
        return done(_maybe(mesh, M, core[0]))

    # --- embeddings ------------------------------------------------------
    if "embed" in path and last == "table":
        return done(_maybe(mesh, M, core[0]), _maybe(mesh, fsdp, core[1]))

    # --- MoE -------------------------------------------------------------
    if "/moe/" in path or path.endswith("router"):
        if last == "router":
            return done(_maybe(mesh, fsdp, core[0]), None)
        if last in ("w1", "w3") and len(core) == 3:     # (E, d, f)
            if core[0] % axis_size(mesh, M) == 0:
                return done(M, _maybe(mesh, fsdp, core[1]), None)
            return done(None, _maybe(mesh, fsdp, core[1]), _maybe(mesh, M, core[2]))
        if last == "w2" and len(core) == 3:             # (E, f, d)
            if core[0] % axis_size(mesh, M) == 0:
                return done(M, None, _maybe(mesh, fsdp, core[2]))
            return done(None, _maybe(mesh, M, core[1]), _maybe(mesh, fsdp, core[2]))
        # dense-residual branch falls through to MLP rules below

    # --- SSM -------------------------------------------------------------
    if last == "in_proj":
        return done(_maybe(mesh, fsdp, core[0]), _maybe(mesh, M, core[1]))
    if last == "conv_w":
        return done(None, _maybe(mesh, M, core[1]))
    if last == "out_proj":
        return done(_maybe(mesh, M, core[0]), _maybe(mesh, fsdp, core[1]))

    # --- attention / MLP 2-D weights --------------------------------------
    if len(core) == 2:
        d_in, d_out = core
        if "/attn/wo" in path or last == "w2":
            return done(_maybe(mesh, M, d_in), _maybe(mesh, fsdp, d_out))
        # wq/wk/wv, mlp w1/w3, vision_proj: shard output dim on model
        return done(_maybe(mesh, fsdp, d_in), _maybe(mesh, M, d_out))

    return done(*([None] * len(core)))


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """A tree of ``fn("a/b/c", leaf)`` with ``tree``'s structure; a list
    (the per-layer sequence) adds nothing to the path, so every layer's
    leaf has the reference's path."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path) for v in tree]
    return fn("/".join(path), tree)


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg: ModelConfig) -> Any:
    """The parameter tree's shapes, drawn on the meta device."""
    params = init_params(cfg, torch.Generator(), device="meta")
    return map_with_path(lambda _, t: tuple(t.shape), params)


def param_specs(cfg: ModelConfig, mesh: MeshShape, fsdp_on: bool = True):
    """A ``Spec`` for every leaf of ``init_params(cfg)``'s tree, in its
    structure. fsdp_on=False -> tensor-parallel-only storage (serving
    variants that fit per-card HBM skip the per-layer weight gathers)."""
    return map_with_path(
        lambda path, shape: _leaf_spec(path, shape, cfg, mesh, fsdp_on),
        _param_shapes(cfg))


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_specs(batch_shapes: dict, mesh: MeshShape) -> dict:
    """Spec per batch entry of ``configs.base.batch_shapes``' ``{name:
    (shape, dtype)}``: dim 0 (the global batch) on the data axes."""
    def spec(shape):
        return Spec(batch_axes(mesh, shape[0]), *([None] * (len(shape) - 1)))
    return {name: spec(shape) for name, (shape, _) in batch_shapes.items()}


def cache_specs(cfg: ModelConfig, mesh: MeshShape, batch: int,
                seq_len: int) -> dict:
    """Spec per leaf of ``init_cache(cfg, batch, seq_len)``, whose layout
    (stacked layers first) is the reference's."""
    shapes = init_cache(cfg, batch, seq_len, device="meta")
    bax = batch_axes(mesh, batch)
    M = "model"

    def spec(p, leaf):
        sh = tuple(leaf.shape)
        if p.startswith("kv_pos"):                       # (L|sites, B, clen)
            return Spec(None, bax, _maybe(mesh, M, sh[2]) if sh[2] else None)
        if p.startswith("kv"):                           # (L, B, clen, Hkv, hd)
            h_ax = _maybe(mesh, M, sh[3])
            c_ax = None if h_ax else _maybe(mesh, M, sh[2])
            return Spec(None, bax, c_ax, h_ax, None)
        if "conv" in p:                                  # (L, B, k, conv_dim)
            return Spec(None, bax, None, _maybe(mesh, M, sh[3]))
        if "ssm" in p:                                   # (L, B, H, P, N)
            return Spec(None, bax, _maybe(mesh, M, sh[2]), None, None)
        return Spec(*([None] * len(sh)))

    return map_with_path(spec, shapes)


def activation_spec(mesh: MeshShape, batch: int) -> Spec:
    return Spec(batch_axes(mesh, batch), None, None)
