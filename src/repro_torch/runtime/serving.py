"""Serving engine of the port: request queue, minibatch batcher, and two
server kinds (``repro.runtime.serving`` on PyTorch):

 * ``BatchInferenceServer`` — the paper's inference semantics: independent
   requests batched into one forward pass.
 * ``GenerationServer`` — LLM-style prefill + decode against the
   ring-buffer KV / SSM caches (``model.prefill`` / ``model.decode_step``).

Both take ``backend="cuda"`` (the default: weights and activations on the
card, attention and the SSD scan through the hand-written kernels) or
``"cpu"`` (the kernels' plain versions). Weights are drawn from a seeded
``torch.Generator`` unless ``params`` are given (e.g. converted from the
reference with ``repro_torch.convert.model_params``), and their matrices
are cast once to the compute dtype at load — the values every
``dense_apply`` of the reference would cast to. Servers run under
``torch.inference_mode``; results stay on the device (``infer`` returns a
device tensor that the runtime synchronises on).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import make_batch
from repro_torch.core.backend import resolve_backend, torch_device
from repro_torch.models import model as M
from repro_torch.runtime.clock import Clock, WallClock


@dataclasses.dataclass
class Request:
    arrival: float
    payload: dict
    done: float = -1.0

    @property
    def latency(self) -> float:
        return self.done - self.arrival


class RequestQueue:
    """Arrival-stamped FIFO; supports synthetic constant/trace-driven feeds.
    Arrival stamps come from the injectable ``clock`` (deterministic under a
    ``FakeClock``) unless an explicit ``now`` is given."""

    def __init__(self, clock: Optional[Clock] = None):
        self.q: deque[Request] = deque()
        self.clock = clock if clock is not None else WallClock()

    def push(self, payload: dict, now: Optional[float] = None):
        self.q.append(Request(now if now is not None else self.clock.now(),
                              payload))

    def ready(self, bs: int) -> bool:
        return len(self.q) >= bs

    def pop_batch(self, bs: int) -> list[Request]:
        return [self.q.popleft() for _ in range(bs)]

    def __len__(self):
        return len(self.q)


def _load_params(cfg: M.ModelConfig, seed: int, params: Optional[dict],
                 device: torch.device) -> dict:
    """The server's weights, matrices in the compute dtype. Drawn weights
    are cast piece by piece as they are drawn (``init_params(cast=)``), so
    the peak is the cast tree plus one float32 layer, not the whole float32
    tree beside its cast."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return M.init_params(cfg, gen, device, cast=cfg.compute_dtype)
    return M.cast_params(_to_device(params, device), cfg.compute_dtype)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def sync(out) -> None:
    """Wait for a server result computed on a CUDA device."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


class BatchInferenceServer:
    """One forward per minibatch of bs requests."""

    def __init__(self, cfg: M.ModelConfig, seq_len: int, bs: int,
                 seed: int = 0, clock: Optional[Clock] = None,
                 backend: Optional[str] = None,
                 params: Optional[dict] = None):
        self.cfg, self.seq_len, self.bs = cfg, seq_len, bs
        self.clock = clock if clock is not None else WallClock()
        self.backend = resolve_backend(backend)
        self.device = torch_device(self.backend)
        self.params = _load_params(cfg, seed, params, self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        self._batch = make_batch(cfg, seq_len, bs, "prefill", gen)
        sync(self.infer())              # warm up: builds the kernels

    def infer(self, batch: Optional[dict] = None) -> torch.Tensor:
        """Logits (bs, seq_len, padded_vocab) of one minibatch, on the
        device, not waited for."""
        with torch.inference_mode():
            return M.forward(self.params, batch or self._batch, self.cfg)[0]

    def minibatch_time(self, iters: int = 3) -> float:
        t0 = self.clock.now()
        for _ in range(iters):
            sync(self.infer())
        return (self.clock.now() - t0) / iters


class GenerationServer:
    """Prefill + token-by-token greedy decode using the serving caches."""

    def __init__(self, cfg: M.ModelConfig, max_seq: int, bs: int,
                 seed: int = 0, backend: Optional[str] = None,
                 params: Optional[dict] = None):
        self.cfg, self.max_seq, self.bs = cfg, max_seq, bs
        self.backend = resolve_backend(backend)
        self.device = torch_device(self.backend)
        self.params = _load_params(cfg, seed, params, self.device)

    def prefill(self, prompt: dict) -> tuple[torch.Tensor, dict]:
        with torch.inference_mode():
            return M.prefill(self.params, self._on_device(prompt), self.cfg,
                             self.max_seq)

    def decode(self, cache: dict, tokens: torch.Tensor,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        with torch.inference_mode():
            return M.decode_step(self.params, cache, {"tokens": tokens}, pos,
                                 self.cfg)

    def _on_device(self, batch: dict) -> dict:
        """The prompt's tensors (``tokens``; ``vision`` for vlm) on the
        server's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy decode input after ``logits``: the argmax of the last
        position, (bs, 1); for audio the argmax of codebook 0 broadcast
        over the codebooks, (bs, 1, CB), as the reference does."""
        last = logits[:, -1:]
        if self.cfg.arch_type == "audio":
            nxt = last[:, :, 0].argmax(dim=-1).to(torch.int32)
            return nxt[..., None].expand(self.bs, 1, self.cfg.n_codebooks)
        return last.argmax(dim=-1).to(torch.int32)

    def generate(self, prompt: dict, steps: int, prompt_len: int,
                 timings: Optional[dict] = None) -> np.ndarray:
        """Greedy tokens (bs, steps) (audio: codebook 0's). With
        ``timings`` given, records the wall seconds of the prefill and of
        each decode step in it (each ends in a device synchronisation).
        ``prompt_len`` is the prompt's length in positions (vlm: patches
        and text)."""
        clock = WallClock()
        logits, cache = self.prefill(prompt)
        if timings is not None:
            sync(logits)
            timings["prefill_s"] = clock.now()
            timings["decode_s"] = []
        tokens = []
        pos = torch.full((self.bs,), prompt_len, dtype=torch.int32,
                         device=self.device)
        for _ in range(steps):
            nxt = self.next_tokens(logits)
            t0 = clock.now()
            logits, cache = self.decode(cache, nxt, pos)
            if timings is not None:
                sync(logits)
                timings["decode_s"].append(clock.now() - t0)
            pos = pos + 1
            tokens.append(nxt.reshape(self.bs, -1)[:, 0])
        return torch.stack(tokens, dim=1).cpu().numpy()
