"""The step functions (``repro.launch.steps`` on PyTorch): train, prefill
and decode, and the sharded train, prefill and decode steps on a device
mesh.

``loss_and_grads`` runs the model's ``train_loss`` and its backward, with
gradient accumulation over microbatches; ``make_train_step`` adds the
AdamW update. ``make_prefill_step`` and ``make_decode_step`` are the
serving steps.

``sharded_step(cfg, shape, mesh)`` is the counterpart of ``jitted_step``:
the parameters carry ``param_shardings``, the optimizer state's ``m``,
``v`` and ``master`` the same and its ``step`` none (replicated), the
batch ``batch_specs``, the cache ``cache_specs``, ``pos`` the batch axes
and the logits ``_logits_spec``, each as DTensor placements, and the step
runs under the activation hook of ``_act_constraint``. Where GSPMD picks
the collectives in the reference, DTensor's own sharding propagation does
here; the kernels run on each rank's local shards (``models.layers``).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import InputShape, batch_shapes
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def loss_and_grads(params: dict, batch: dict, cfg: M.ModelConfig,
                   microbatches: int = 1) -> tuple[dict, dict]:
    """``(metrics, grads)`` of ``train_loss`` at ``params`` (leaves that
    require grad). With ``microbatches > 1`` the batch splits along its
    first axis, each piece runs forward and backward on its own (activation
    memory shrinks ~1/microbatches) and the float32 gradients are averaged,
    as are the metrics.

    On a mesh (DTensor parameters) each gradient is brought to its
    parameter's placements as soon as the backward pass forms it (a hook
    on the parameter: the reference's data-parallel reduce-scatter), so a
    rank holds one whole gradient at a time beside its shards; the
    accumulators are placed as the parameters."""
    leaves = T.leaves(params)
    hooks = [p.register_hook(functools.partial(_placed_as, p=p))
             for p in leaves if S.is_dtensor(p)]
    try:
        if microbatches == 1:
            loss, metrics = M.train_loss(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            return ({k: v.detach() for k, v in metrics.items()},
                    T.unflatten(params, list(grads)))
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        parts = []
        for i in range(microbatches):
            one = {k: _unflatten0(v, microbatches)[i]
                   for k, v in batch.items()}
            loss, metrics = M.train_loss(params, one, cfg)
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a.add_(g.float() / microbatches)
            parts.append({k: v.detach() for k, v in metrics.items()})
    finally:
        for h in hooks:
            h.remove()
    metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
    return metrics, T.unflatten(params, acc)


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` in its parameter's placements (a reduce-scatter
    where it arrives ``Partial``)."""
    if S.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _unflatten0(v: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B / n, ...). A DTensor split on the batch is split
    on its second dim after, so that each microbatch keeps the split (its
    rows are every rank's n-th part)."""
    if not S.is_dtensor(v):
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])
    from torch.distributed.tensor import DTensor, Shard
    place = tuple(Shard(1) if p.is_shard(0) else p for p in v.placements)
    local = v.to_local()
    return DTensor.from_local(
        local.reshape(n, local.shape[0] // n, *local.shape[1:]),
        v.device_mesh, place, run_check=False)


def make_train_step(cfg: M.ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> metrics``: one optimizer
    step that updates ``params`` and ``opt_state`` in place (the
    reference's step returns new ones). ``metrics`` holds the loss terms,
    ``grad_norm`` and ``lr`` as device scalars."""
    def train_step(params: dict, opt_state: dict, batch: dict) -> dict:
        metrics, grads = loss_and_grads(params, batch, cfg, microbatches)
        stats = adamw_update(grads, opt_state, params, opt_cfg)
        return {**metrics, **stats}
    return train_step


def make_prefill_step(cfg: M.ModelConfig, max_seq_len: int,
                      cache_dtype=torch.bfloat16) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, max_seq_len, cache_dtype)
    return prefill_step


def make_decode_step(cfg: M.ModelConfig) -> Callable:
    def decode_step(params, cache, batch, pos):
        return M.decode_step(params, cache, batch, pos, cfg)
    return decode_step


# ---------------------------------------------------------------------------
# sharded steps for a (cfg, shape, mesh) triple
# ---------------------------------------------------------------------------

def _logits_spec(cfg: M.ModelConfig, mesh, batch: int) -> S.Spec:
    mesh = S.mesh_shape(mesh)
    bax = S.batch_axes(mesh, batch)
    v = "model" if cfg.padded_vocab % S.axis_size(mesh, "model") == 0 \
        else None
    if cfg.arch_type == "audio":
        return S.Spec(bax, None, None, v)
    return S.Spec(bax, None, v)


def _act_constraint(mesh, batch: int) -> Callable:
    """Pin (B, S, d) activations to batch-over-data at the layer
    boundaries, so the weights (small, per layer) are gathered rather than
    the activations, and (B, S, H, D) q, k, v to heads-over-model where
    the model axis divides the heads (replicated on it otherwise)."""
    shape = S.mesh_shape(mesh)
    act = S.placements(S.activation_spec(shape, batch), mesh)
    bax = S.batch_axes(shape, batch)
    model = S.axis_size(shape, "model")

    def fn(x):
        if not S.is_dtensor(x):
            return x
        if x.ndim == 3:
            return x.redistribute(mesh, act)
        if x.ndim == 4:
            h_ax = "model" if x.shape[2] % model == 0 else None
            return x.redistribute(mesh, S.placements(
                S.Spec(bax, None, h_ax, None), mesh))
        return x
    return fn


def sharded_step(cfg: M.ModelConfig, shape: InputShape, mesh,
                 fsdp_params: bool = True, max_seq_len: Optional[int] = None,
                 cache_dtype=torch.bfloat16,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 microbatches: int = 1) -> tuple[Callable, dict]:
    """``(step, shardings)`` for ``shape.kind`` on ``mesh``.

    ``train``: ``step(params, opt_state, batch) -> metrics`` is
    ``make_train_step(cfg, opt_cfg, microbatches)`` on the mesh: it
    updates ``params`` and ``opt_state`` in place (``init_opt_state`` of
    the placed parameters gives ``shardings["opt_state"]``) and returns
    the metrics as plain scalars every rank holds.

    ``prefill`` / ``decode``: ``step(params, batch)`` or ``step(params,
    cache, batch, pos)`` returns ``(logits, cache)`` as DTensors of
    ``shardings["logits"]`` and ``shardings["cache"]``. The cache holds
    ``max_seq_len`` positions (default ``shape.seq_len``: the prompt for
    prefill, the context for decode).

    ``params`` must carry ``shardings["params"]``
    (``sharding.distribute_params`` or ``init_sharded_params``); batch,
    pos and cache may be whole tensors, every rank holding the same, or
    DTensors, and are placed by their shardings. ``fsdp_params=False``
    keeps the weights (and the optimizer state) tensor-parallel only."""
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    b = shape.global_batch
    ms = S.mesh_shape(mesh)
    pshard = S.param_shardings(cfg, mesh, fsdp_params)
    shardings = {
        "params": pshard,
        "batch": {k: S.placements(sp, mesh) for k, sp in S.batch_specs(
            batch_shapes(cfg, shape.seq_len, b, shape.kind), ms).items()},
    }
    constraint = _act_constraint(mesh, b)

    def place_batch(batch: dict) -> dict:
        return {k: S.distribute(v, mesh, shardings["batch"][k])
                for k, v in batch.items()}

    if shape.kind == "train":
        shardings["opt_state"] = {
            "m": pshard, "v": pshard,
            "step": (Replicate(),) * mesh.ndim}
        if cfg.param_dtype != torch.float32:
            shardings["opt_state"]["master"] = pshard
        train = make_train_step(cfg, opt_cfg, microbatches)

        def step(params, opt_state, batch):
            for p in T.leaves(params):
                p.requires_grad_(True)
            with implicit_replication(), M.activation_sharding(constraint):
                metrics = train(params, opt_state, place_batch(batch))
            return {k: v.full_tensor() if S.is_dtensor(v) else v
                    for k, v in metrics.items()}
        return step, shardings

    ctx = max_seq_len or shape.seq_len
    cache_place = S.map_with_path(lambda _, sp: S.placements(sp, mesh),
                                  S.cache_specs(cfg, ms, b, ctx))
    shardings["cache"] = cache_place
    shardings["logits"] = S.placements(_logits_spec(cfg, ms, b), mesh)

    def run(step, *args):
        with torch.no_grad(), implicit_replication(), \
                M.activation_sharding(constraint):
            logits, cache = step(*args)
        return (S.distribute(logits, mesh, shardings["logits"]),
                S.distribute_tree(cache, cache_place, mesh))

    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, ctx, cache_dtype)

        def step(params, batch):
            return run(prefill, params, place_batch(batch))
        return step, shardings

    shardings["pos"] = S.placements(S.Spec(S.batch_axes(ms, b)), mesh)
    decode = make_decode_step(cfg)

    def step(params, cache, batch, pos):
        return run(decode, params, S.distribute_tree(cache, cache_place, mesh),
                   place_batch(batch),
                   S.distribute(pos, mesh, shardings["pos"]))
    return step, shardings
