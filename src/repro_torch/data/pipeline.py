"""Deterministic synthetic token pipeline with a prefetch thread that places
batches on the device (``repro.data.pipeline`` on PyTorch).

``SyntheticTokenSource`` makes the reference's calls on a NumPy generator
of the same seed, so its tokens are bitwise equal to the reference's.
``Prefetcher`` copies each batch to the device from pinned memory with
``non_blocking`` on a host thread, so the next batch's copy overlaps the
current step. Mesh shardings (the reference's ``ShardedPrefetcher`` with
``shardings``) wait for the pod layer (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.model import ModelConfig


class SyntheticTokenSource:
    """Seeded stream of token batches shaped for the given architecture.

    Zipf-distributed token ids (more realistic unembedding gradients than
    uniform) with next-token labels, as NumPy int32 arrays: (B, S) or, for
    audio, (B, S, n_codebooks). A vlm batch of ``seq_len`` positions holds
    ``seq_len - n_patches`` text tokens and float32 ``vision`` embeddings
    (B, n_patches, d_vision), drawn normal from the same generator after
    the tokens."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        if cfg.arch_type == "vlm" and seq_len <= cfg.n_patches:
            raise ValueError(f"a vlm sequence of {seq_len} positions holds "
                             f"no text after its {cfg.n_patches} patches")
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self._rng = np.random.default_rng(seed)
        zipf = 1.0 / np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = zipf / zipf.sum()

    def _tokens(self, shape) -> np.ndarray:
        flat = self._rng.choice(self.cfg.vocab_size, size=int(np.prod(shape)),
                                p=self._probs)
        return flat.reshape(shape).astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        while True:
            if cfg.arch_type == "audio":
                toks = self._tokens((self.batch, self.seq_len + 1,
                                     cfg.n_codebooks))
                yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            elif cfg.arch_type == "vlm":
                toks = self._tokens((self.batch,
                                     self.seq_len - cfg.n_patches + 1))
                vis = self._rng.standard_normal(
                    (self.batch, cfg.n_patches, cfg.d_vision)
                ).astype(np.float32)
                yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                       "vision": vis}
            else:
                toks = self._tokens((self.batch, self.seq_len + 1))
                yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_DONE = object()


class Prefetcher:
    """Host-thread prefetch of ``depth`` batches onto ``device``: each NumPy
    batch becomes pinned tensors (on a CUDA device) copied with
    ``non_blocking``, so the copy overlaps the previous step. An error in
    the source is raised by ``next``. ``close`` stops the thread."""

    def __init__(self, source, device: torch.device, depth: int = 2):
        self.source = iter(source)
        self.device = torch.device(device)
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for batch in self.source:
                if not self._put(self._place(batch)):
                    return
        except Exception as e:  # noqa: BLE001 -- handed to the consumer
            self._put(e)
        self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self.q.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
