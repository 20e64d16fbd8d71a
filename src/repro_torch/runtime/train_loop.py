"""Training loop of the port: the train step, the data pipeline,
checkpointing and metrics (``repro.runtime.train_loop`` on PyTorch).

``Trainer`` trains on one device: ``backend="cuda"`` (the default; the
attention and SSD kernels and their backward kernels on the card) or
``"cpu"`` (their plain versions). Weights are drawn from a
``torch.Generator`` seeded with ``seed`` unless ``params`` are given (e.g.
converted from the reference with ``convert.model_params``, and with
``convert.opt_state`` for the optimizer state); the data stream is
``SyntheticTokenSource`` seeded with ``seed + 1``, as in the reference.

One deliberate difference from the reference, whose jitted steps dispatch
asynchronously: ``step_minibatch`` waits for its own work on the device
before it returns, and ``train_minibatch_time`` times that same waited-for
step. ``ManagedInterleaveRuntime`` tests ``now + t_tr <= ready`` before
each training step; it must see finished work and the time of the step it
will run, not the launch time, or inference would queue behind training
still running on the card.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from repro_torch.core.backend import resolve_backend, torch_device
from repro_torch.data.pipeline import Prefetcher, SyntheticTokenSource
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.clock import Clock, WallClock


@dataclasses.dataclass
class TrainReport:
    steps: int
    losses: list[float]
    step_times: list[float]

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")

    @property
    def mean_step_time(self) -> float:
        xs = self.step_times[2:] or self.step_times   # skip warm-up steps
        return float(np.mean(xs)) if xs else float("nan")


def _owned(tree, device):
    """A copy of ``tree`` on ``device`` that the trainer may update in
    place."""
    return T.tree_map(lambda t: t.detach().to(device).clone(), tree)


class Trainer:
    """Single-device trainer: the unit the managed interleave runtime
    schedules into inference slack."""

    def __init__(self, cfg: M.ModelConfig, batch: int, seq_len: int,
                 opt_cfg: AdamWConfig = AdamWConfig(), seed: int = 0,
                 ckpt_path: Optional[str] = None,
                 clock: Optional[Clock] = None,
                 backend: Optional[str] = None,
                 params: Optional[dict] = None,
                 opt_state: Optional[dict] = None):
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self.opt_cfg = opt_cfg
        self.ckpt_path = ckpt_path
        self.clock = clock if clock is not None else WallClock()
        self.backend = resolve_backend(backend)
        self.device = torch_device(self.backend)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen, self.device)
        else:
            params = _owned(params, self.device)
        self.params = T.tree_map(lambda p: p.requires_grad_(), params)
        self.opt_state = (init_opt_state(self.params) if opt_state is None
                          else _owned(opt_state, self.device))
        self.step_fn = make_train_step(cfg, opt_cfg)
        self.data = Prefetcher(
            SyntheticTokenSource(cfg, batch, seq_len, seed=seed + 1),
            self.device)
        self.step = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stop the data thread."""
        self.data.close()

    def restore(self) -> None:
        if self.ckpt_path and Path(self.ckpt_path).exists():
            (params, self.opt_state), self.step = restore_checkpoint(
                self.ckpt_path, (self.params, self.opt_state))
            self.params = T.tree_map(lambda p: p.requires_grad_(), params)

    def _advance(self) -> None:
        """One optimizer step on the next data batch, waited for on the
        device before it returns."""
        self.step_fn(self.params, self.opt_state, next(self.data))
        self._sync()

    def step_minibatch(self) -> None:
        """One counted step of ``_advance``: the unit the managed interleave
        runtime schedules into inference slack."""
        self._advance()
        self.step += 1

    def train(self, num_steps: int, log_every: int = 10,
              ckpt_every: int = 0) -> TrainReport:
        losses, times = [], []
        for _ in range(num_steps):
            batch = next(self.data)
            t0 = self.clock.now()
            metrics = self.step_fn(self.params, self.opt_state, batch)
            loss = float(metrics["loss"])            # waits for the step
            times.append(self.clock.now() - t0)
            losses.append(loss)
            self.step += 1
            if log_every and self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({times[-1]*1e3:.0f} ms)", flush=True)
            if ckpt_every and self.ckpt_path and self.step % ckpt_every == 0:
                save_checkpoint(self.ckpt_path, (self.params, self.opt_state),
                                self.step)
        return TrainReport(self.step, losses, times)

    def train_minibatch_time(self, warmup: int = 2, iters: int = 3) -> float:
        """Seconds of one training minibatch (used by the real-mode
        runtime): ``warmup`` steps, then the mean of ``iters`` steps, each
        waited for as ``step_minibatch`` waits for it. Like the reference's,
        these steps update the params but do not count in ``step``."""
        for _ in range(warmup):
            self._advance()
        t0 = self.clock.now()
        for _ in range(iters):
            self._advance()
        return (self.clock.now() - t0) / iters
