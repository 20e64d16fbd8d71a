"""The training step (``repro.launch.steps.make_train_step`` on PyTorch).

``loss_and_grads`` runs the model's ``train_loss`` and its backward, with
gradient accumulation over microbatches; ``make_train_step`` adds the
AdamW update. The reference's prefill / decode steps and the sharded,
jitted steps with their mesh shardings wait for the pod layer (ROADMAP
queue 1 item 8).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as T
from repro_torch.models import model as M
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
