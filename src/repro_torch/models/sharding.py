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
reference reads of an ``AbstractMesh``) or a live ``DeviceMesh`` (read
through ``mesh_shape``) and return ``Spec``s (one entry per
dim: None, an axis name or a tuple of names, as a ``PartitionSpec``).
Nothing is allocated: the parameter and cache trees are walked on the
``meta`` device.

The port keeps a model's layers as a list of per-layer dicts, where the
reference stacks them on a leading axis: a layer leaf's spec is the
reference's with that axis's entry dropped. The audio codebook tables are
one stacked (CB-1, V, d) tensor in both packages, so their spec keeps its
leading entry.

On a live ``DeviceMesh`` (``launch.mesh``): ``mesh_shape`` reads its
``MeshShape``, ``placements`` turns a ``Spec`` into DTensor placements
and ``param_shardings`` is the reference's ``NamedSharding`` tree as
placements. ``local_map`` runs a function on each rank's local shards
(the layers' kernel boundaries: a kernel never sees a DTensor). ``distribute`` puts a tensor every rank holds whole onto the
mesh, each rank keeping its own shard (no communication);
``distribute_params`` does so leaf by leaf for a parameter tree (the
tests' converted reference parameters) and ``init_sharded_params`` draws
the port's own parameters piece by piece on each rank, keeping its
shards before the next piece is drawn.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import sys
from typing import TYPE_CHECKING, Any, Callable

import torch

from repro_torch import tree as T

if TYPE_CHECKING:   # the layers import this module, the model imports them
    from repro_torch.models.model import ModelConfig


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
    mesh = mesh_shape(mesh)
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
    mesh = mesh_shape(mesh)
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_axes(mesh: MeshShape, batch: int):
    """Largest prefix of (pod, data) whose product divides `batch`."""
    mesh = mesh_shape(mesh)
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
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator(), device="meta")
    return map_with_path(lambda _, t: tuple(t.shape), params)


def param_specs(cfg: ModelConfig, mesh: MeshShape, fsdp_on: bool = True):
    """A ``Spec`` for every leaf of ``init_params(cfg)``'s tree, in its
    structure. fsdp_on=False -> tensor-parallel-only storage (serving
    variants that fit per-card HBM skip the per-layer weight gathers)."""
    mesh = mesh_shape(mesh)
    return map_with_path(
        lambda path, shape: _leaf_spec(path, shape, cfg, mesh, fsdp_on),
        _param_shapes(cfg))


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_specs(batch_shapes: dict, mesh: MeshShape) -> dict:
    """Spec per batch entry of ``configs.base.batch_shapes``' ``{name:
    (shape, dtype)}``: dim 0 (the global batch) on the data axes."""
    mesh = mesh_shape(mesh)
    def spec(shape):
        return Spec(batch_axes(mesh, shape[0]), *([None] * (len(shape) - 1)))
    return {name: spec(shape) for name, (shape, _) in batch_shapes.items()}


def cache_specs(cfg: ModelConfig, mesh: MeshShape, batch: int,
                seq_len: int) -> dict:
    """Spec per leaf of ``init_cache(cfg, batch, seq_len)``, whose layout
    (stacked layers first) is the reference's."""
    from repro_torch.models.model import init_cache
    mesh = mesh_shape(mesh)
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
    mesh = mesh_shape(mesh)
    return Spec(batch_axes(mesh, batch), None, None)


# ---------------------------------------------------------------------------
# DTensor placements on a live mesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. The module is looked up, not imported:
    where it was never imported, no DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_map(fn: Callable, mesh, ins: tuple, outs,
              grads: tuple = None) -> Callable:
    """``fn`` on each rank's local shards, in the manner of
    ``torch.distributed.tensor.experimental.local_map`` with its inputs
    redistributed. Argument i, a DTensor, is laid out as ``ins[i]`` (its
    placements; None passes the argument as it is) and ``fn`` gets the
    local tensor: where the DTensor already lies so, its own, so that
    writes in place land in it. A tensor ``fn`` returns goes back on the
    mesh as a DTensor of ``outs`` (its placements, even splits), a tuple
    of them each by its entry of ``outs``; None stays None.

    Under autograd an output's gradient reaches ``fn`` whole in its
    ``outs`` layout (a ``Partial`` output's as ``Replicate``), and input
    i's local gradient leaves in ``grads[i]``, then goes back to the
    input's own layout. By default that is ``ins[i]``, except on a mesh
    dim where the input is replicated and some output is split or
    partial: the ranks there did different parts of the work, so each
    holds a part of the gradient (``Partial``). Work that every rank of
    such a dim repeats must add to the gradient on one of them only
    (``grad_scaled``)."""
    from torch.distributed.tensor import DTensor, Partial, Placement

    if outs is None:
        out_list = []
    elif all(isinstance(p, Placement) for p in outs):
        out_list = [outs]
    else:
        out_list = [o for o in outs if o is not None]
    split = [any(not o[d].is_replicate() for o in out_list)
             for d in range(mesh.ndim)]
    if grads is None:
        grads = tuple(None if p is None else tuple(
            Partial() if pl.is_replicate() and split[d] else pl
            for d, pl in enumerate(p)) for p in ins)

    def local(x, place, grad):
        if place is None:
            return x
        if tuple(x.placements) != tuple(place):
            x = x.redistribute(mesh, place)
        return x.to_local(grad_placements=grad)

    def wrap(y, place):
        return None if y is None else DTensor.from_local(y, mesh, place,
                                                         run_check=False)

    def run(*args):
        out = fn(*(local(a, p, g) for a, p, g in zip(args, ins, grads,
                                                       strict=True)))
        if isinstance(out, tuple):
            return tuple(wrap(y, p) for y, p in zip(out, outs, strict=True))
        return wrap(out, outs)
    return run


class _GradScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if g is None or ctx.s == 1 else g * ctx.s), None


def grad_scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x`` itself, whose gradient is multiplied by ``s``: with 0 on all
    but one rank, work that every rank repeats adds to a ``Partial``
    gradient once. Every rank keeps the same autograd graph (a rank
    without the node would skip the backward's collectives)."""
    return _GradScaled.apply(x, s)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (all-reduce). Its
    gradient passes unchanged: the ranks use the sum alike, so each holds
    the whole gradient of its own term."""
    return _SumOver.apply(t, group)


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``DeviceMesh`` with named dims, or a
    ``MeshShape`` as it is."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the spec names that axis for tensor dim d, else
    ``Replicate()``. A tuple entry splits its dim over several axes,
    major to minor in the spec's order, which must be the mesh's order
    (DTensor shards one dim over mesh dims in their order). An axis of
    size 1 replicates: a split in one piece is the whole, and DTensor
    refuses to reshape a dim it holds split, even in one piece."""
    from torch.distributed.tensor import Replicate, Shard
    shape = mesh_shape(mesh)
    names = shape.axis_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {dim} splits over {axes}, out of "
                             f"the mesh's order {names}")
        for i in idx:
            if shape.axis_sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def param_shardings(cfg: ModelConfig, mesh, fsdp_on: bool = True):
    """Placements for every leaf of ``init_params(cfg)``'s tree."""
    return map_with_path(lambda _, spec: placements(spec, mesh),
                         param_specs(cfg, mesh, fsdp_on))


def local_shard(full: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """This rank's shard of ``full`` under ``place``: the dims split over
    mesh dims in their order (even splits; the specs shard only dims that
    divide)."""
    t = full
    for i, p in enumerate(place):
        if p.is_shard():
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split {n} ways")
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return t


def distribute(t: torch.Tensor, mesh, place: tuple):
    """``t`` as a DTensor of ``place``: a DTensor is redistributed; a plain
    tensor, which every rank must hold whole and equal, gives each rank
    its own shard with no communication (a copy, so ``t`` can be
    freed)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.redistribute(mesh, place)
    local = local_shard(t, mesh, place)
    local = t.contiguous() if local is t else local.clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, place, run_check=False)


def distribute_tree(tree: Any, place: Any, mesh) -> Any:
    """``distribute`` of every leaf of ``tree`` by the matching placements
    of ``place`` (a tree of one structure)."""
    return T.tree_map(lambda t, p: distribute(t, mesh, p), tree, place)


def distribute_params(params: dict, cfg: ModelConfig, mesh,
                      fsdp_on: bool = True) -> dict:
    """A whole parameter tree (every rank holds the same) onto ``mesh`` by
    ``param_shardings``."""
    return distribute_tree(params, param_shardings(cfg, mesh, fsdp_on), mesh)


def init_sharded_params(cfg: ModelConfig, mesh, generator: torch.Generator,
                        fsdp_on: bool = True, cast=None) -> dict:
    """``init_params(cfg, generator, cast=cast)`` drawn on every rank from
    one seed, each leaf replaced by this rank's shard as soon as it is
    drawn (and cast): the values of ``distribute_params`` of the whole
    tree, with at most one piece whole at a time (a layer; of an MoE
    layer, one expert matrix)."""
    from repro_torch.models.model import init_params
    place = {path: p for path, p in flat_paths(
        param_shardings(cfg, mesh, fsdp_on))}
    return init_params(cfg, generator, cast=cast,
                       place=lambda path, t: distribute(t, mesh, place[path]))


def flat_paths(tree: Any, path: tuple = ()):
    """``(path, leaf)`` of a tree whose per-layer list adds its index to the
    path (``layers/3/attn/wq/w``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree
