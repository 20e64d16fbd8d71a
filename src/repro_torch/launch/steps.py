"""The step functions (``repro.launch.steps`` on PyTorch): train, prefill
and decode, and the sharded prefill and decode steps on a device mesh.

``loss_and_grads`` runs the model's ``train_loss`` and its backward, with
gradient accumulation over microbatches; ``make_train_step`` adds the
AdamW update. ``make_prefill_step`` and ``make_decode_step`` are the
serving steps.

``sharded_step(cfg, shape, mesh)`` is the counterpart of ``jitted_step``
for prefill and decode: the parameters carry ``param_shardings``, the
batch ``batch_specs``, the cache ``cache_specs``, ``pos`` the batch axes
and the logits ``_logits_spec``, each as DTensor placements, and the step
runs under the activation hook of ``_act_constraint``. Where GSPMD picks
the collectives in the reference, DTensor's own sharding propagation does
here; the kernels run on each rank's local shards (``models.layers``).
The sharded train step waits for the pod layer's training half (ROADMAP
queue 1 item 8b-ii).
"""
from __future__ import annotations

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
    as are the metrics."""
    leaves = T.leaves(params)
    if microbatches == 1:
        loss, metrics = M.train_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                T.unflatten(params, list(grads)))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    parts = []
    for i in range(microbatches):
        one = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                            *v.shape[1:])[i] for k, v in batch.items()}
        loss, metrics = M.train_loss(params, one, cfg)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g.float() / microbatches)
        parts.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
    return metrics, T.unflatten(params, acc)


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
                 cache_dtype=torch.bfloat16) -> tuple[Callable, dict]:
    """``(step, shardings)`` for ``shape.kind`` prefill or decode on
    ``mesh``: ``step(params, batch)`` (prefill) or ``step(params, cache,
    batch, pos)`` (decode) returns ``(logits, cache)`` as DTensors of
    ``shardings["logits"]`` and ``shardings["cache"]``. ``params`` must
    carry ``shardings["params"]`` (``sharding.distribute_params`` or
    ``init_sharded_params``); batch, pos and cache may be whole tensors,
    every rank holding the same, or DTensors, and are placed by their
    shardings. The cache holds ``max_seq_len`` positions (default
    ``shape.seq_len``: the prompt for prefill, the context for decode).
    ``fsdp_params=False`` keeps the weights tensor-parallel only."""
    if shape.kind == "train":
        raise NotImplementedError(
            "the sharded train step is the pod layer's training half, "
            "ROADMAP queue 1 item 8b-ii")
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(shape.kind)
    from torch.distributed.tensor.experimental import implicit_replication
    b = shape.global_batch
    ctx = max_seq_len or shape.seq_len
    ms = S.mesh_shape(mesh)
    cache_place = S.map_with_path(lambda _, sp: S.placements(sp, mesh),
                                  S.cache_specs(cfg, ms, b, ctx))
    shardings = {
        "params": S.param_shardings(cfg, mesh, fsdp_params),
        "batch": {k: S.placements(sp, mesh) for k, sp in S.batch_specs(
            batch_shapes(cfg, shape.seq_len, b, shape.kind), ms).items()},
        "cache": cache_place,
        "logits": S.placements(_logits_spec(cfg, ms, b), mesh),
    }
    constraint = _act_constraint(mesh, b)

    def run(step, *args):
        with torch.no_grad(), implicit_replication(), \
                M.activation_sharding(constraint):
            logits, cache = step(*args)
        return (S.distribute(logits, mesh, shardings["logits"]),
                S.distribute_tree(cache, cache_place, mesh))

    def place_batch(batch: dict) -> dict:
        return {k: S.distribute(v, mesh, shardings["batch"][k])
                for k, v in batch.items()}

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
