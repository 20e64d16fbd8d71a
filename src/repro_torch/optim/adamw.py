"""AdamW with a linear-warmup cosine schedule, in PyTorch
(``repro.optim.adamw``).

The optimizer state mirrors the parameter tree: float32 ``m`` and ``v``, an
int32 ``step``, and a float32 ``master`` copy when some parameter is stored
in another dtype (mixed precision). ``adamw_update`` keeps the reference's
order of float operations per leaf, clips by the global gradient norm and
decays matrices only.

Two differences from the reference, both deliberate:

 * The update runs in place under ``torch.no_grad`` — parameters, ``m``,
   ``v``, ``master`` and ``step`` are overwritten — where the reference
   returns new arrays. A 1.1B-parameter model then needs no second copy of
   its state.
 * "Matrix" follows the reference's layout: it decays a leaf of two or
   more dimensions, and it holds every per-layer leaf with a leading layer
   axis. So a per-layer vector (a norm scale, ``A_log``, ``conv_b``) is
   decayed there, and is here too; the shared block's and the final
   norm's vectors are not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = ((step - cfg.warmup_steps) / decay_steps).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    """Zero ``m`` and ``v`` in float32 and ``step`` 0 on the parameters'
    device, plus a float32 ``master`` copy when some parameter is not
    float32."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    flat = T.leaves(params)
    state = {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=flat[0].device)}
    if any(p.dtype != torch.float32 for p in flat):
        state["master"] = T.tree_map(
            lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any,
                 cfg: AdamWConfig) -> dict:
    """One AdamW step in place on ``params`` and ``opt_state`` from
    ``grads`` (a tree of ``params``' structure). Returns the stats
    ``{"grad_norm", "lr"}`` as device scalars."""
    opt_state["step"] += 1
    step = opt_state["step"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, opt_state["step"])
    b1c = 1 - torch.full_like(step, cfg.b1) ** step
    b2c = 1 - torch.full_like(step, cfg.b2) ** step
    master = opt_state.get("master")

    def upd(p, g, m, v, mr, stacked):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        ref = mr if mr is not None else p.float()
        if p.dim() + stacked >= 2:       # decay matrices only
            delta = delta + cfg.weight_decay * ref
        new_master = ref - lr * delta
        p.copy_(new_master.to(p.dtype))
        if mr is not None:
            mr.copy_(new_master)

    if master is None:
        T.walk_layers(lambda p, g, m, v, stacked: upd(p, g, m, v, None,
                                                      stacked),
                      params, grads, opt_state["m"], opt_state["v"])
    else:
        T.walk_layers(upd, params, grads, opt_state["m"], opt_state["v"],
                      master)
    return {"grad_norm": gnorm, "lr": lr}
