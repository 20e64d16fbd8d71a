"""The dry run: every (architecture x input shape) measured as a sharded
step on the cards at two probe depths, its collective bytes counted by
kind and extrapolated linearly to the full depth.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each pair with XLA on 512 placeholder devices and reads the compiled
artifact: ``memory_analysis``, ``cost_analysis`` and the per-device
operand bytes of every collective in the HLO. PyTorch has no compiled
artifact to read, so the port measures (ROADMAP, deviations):

 * ``measure_pair`` runs the sharded step (``launch.steps.sharded_step``)
   of each probe depth on the mesh, every rank inside one
   ``launch.ranks`` program: the weights drawn from a seed shard by shard
   (``init_sharded_params``), one warm-up step counted by
   ``CollectiveCounter``, then ``reps`` timed steps. ``memory`` is the
   largest ``torch.cuda.max_memory_allocated`` over the ranks, ``cost``
   the step's milliseconds, ``collectives`` the operand bytes per device
   by the reference's five kinds.
 * The reference's probes are unrolled because XLA counts a scanned
   stack's body once. The port's layers are a Python loop, so ``unroll``
   means nothing here: a probe is the configuration at ``num_layers`` L.
 * ``_lin_extrapolate`` takes the two probes to ``cfg.num_layers``; the
   reference's first compile, of the full depth, becomes a run at full
   depth where ``full=True`` and the fit rule admits it.

**The split** (``split_rule``), fixed before a step runs, never a retry
after an out-of-memory error: ``INPUT_SHAPES`` is sized for 256 chips,
and on the four-card mesh every card would hold all 1,048,576 tokens of
``train_4k``. A train step takes the variant's ``microbatches``, else the
smallest power of two that divides the global batch and keeps a
microbatch at or below ``DRYRUN_CHUNK_TOKENS`` tokens per data rank and
its float32 logits (tokens per data rank x logit columns per model rank
x 4 B) at or below ``DRYRUN_LOGITS_BYTES``; a prefill step runs on
consecutive slices of the batch by the token bound, each writing its
rows of one cache (it keeps only the last token's logits); decode is
never split. A split keeps
the step's tokens, model FLOPs and activation collectives (the tensor-
parallel all-reduces) in total; what moves once per forward or backward
repeats per slice: the FSDP weight all-gathers and, in training, the
gradients' reduce-scatters and the all-reduces of gradients replicated
over the data axes (``steps.loss_and_grads``' hooks). DTensor picks each
op's strategy by its tensors' sizes, so this holds where a slice's
activations outweigh a layer's weights, as at these shapes. The records
give the per-step totals.

**The fit rule** (``state_bytes``): before a probe allocates, its exact
state bytes per rank are summed from the shard shapes of
``param_shardings`` (the parameters; in training also master, m, v and
the gradients, by their dtypes; for prefill and decode the cache of
``cache_specs``). Over the card's ``HBM_BYTES`` less ``DRYRUN_RESERVE``
the probe records ``skipped`` with the bytes and launches nothing. It
counts no activation: the split's logits bound caps the largest, a train
slice's logits, whose transients in the loss reach about five times
``DRYRUN_LOGITS_BYTES``; the others are bounded only by the token bound.

``run_pair`` and ``main`` keep the reference's signature, flags, key
format (``arch|shape|mesh[|tag]``), skip-if-ok, ``--force``, a flush after
every pair and a failed pair's record. ``main`` starts the ranks itself
(``launch.ranks.run``, ``--world`` defaulting to the visible cards) and
runs one rank program per pair; its default output is
``build/dryrun.json``. Meshes are named by their shape: ``1x4`` and
``1x1x4`` on the four-card host (the reference's ``16x16`` and
``2x16x16``), ``1x1`` on one card.

Usage, on a host of four cards:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --world 4 \
      --arch qwen2.5-14b --shape all --mesh single,multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      get_config, make_batch, reduced)
from repro_torch.models.model import ModelConfig

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

DRYRUN_CHUNK_TOKENS = 32_768    # tokens per data rank in one slice
# a train slice's float32 logits per rank: the loss holds about five
# tensors of their size at its peak (stablelm-1.6b's train_4k on one card,
# 32,768 tokens x 100,352 columns: a 74.3 GB peak, 13.2 GB of logits)
DRYRUN_LOGITS_BYTES = 8e9
DRYRUN_RESERVE = 4e9            # bytes a card keeps free beyond the state
DEFAULT_REPS = 3
DEFAULT_OUT = "build/dryrun.json"
PAIR_WALL_S = 3600.0            # seconds a pair's ranks may run


def analytic_model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for fwd-only (N = active params,
    D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _probe_depths(cfg: ModelConfig) -> tuple[int, int]:
    """Two small depths for per-layer cost extraction; hybrid archs need
    multiples of attn_every so shared-attention sites scale linearly."""
    if cfg.arch_type == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    return 2, 4


def _lin_extrapolate(v1: float, v2: float, l1: int, l2: int, L: int) -> float:
    per_layer = (v2 - v1) / (l2 - l1)
    base = v1 - l1 * per_layer
    return base + L * per_layer


def analytic_record(cfg: ModelConfig, shape: InputShape) -> dict:
    """The pair's analytic keys, by the reference's formulas."""
    return {"model_flops": analytic_model_flops(cfg, shape),
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "tokens": shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1)}


# ---------------------------------------------------------------------------
# the collective counter
# ---------------------------------------------------------------------------

class UnmappedCollective(RuntimeError):
    """A communication op the counter has no kind for."""


# op -> (kind, index of the argument whose tensors are the operand, index
# of the group argument); kind None: moves no operand of its own (a wait,
# a barrier, the receiving end of a send, which the sender counts)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 0, 2),
    "all_gather_into_tensor_out": ("all-gather", 0, 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 0, 2),
    "all_reduce": ("all-reduce", 0, 2),
    "all_reduce_": ("all-reduce", 0, 2),
    "all_reduce_coalesced": ("all-reduce", 0, 2),
    "all_reduce_coalesced_": ("all-reduce", 0, 2),
    "reduce_scatter_tensor": ("reduce-scatter", 0, 3),
    "reduce_scatter_tensor_out": ("reduce-scatter", 0, 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0, 3),
    "all_to_all_single": ("all-to-all", 0, 3),
    "isend": ("collective-permute", 0, 3),
    "irecv": (None, 0, 3),
    "wait_tensor": (None, None, None),
    "_wrap_tensor_autograd": (None, None, None),
}
_C10D = {
    "allreduce_": ("all-reduce", 0, 1),
    "allreduce_coalesced_": ("all-reduce", 0, 1),
    "allgather_": ("all-gather", 1, 2),
    "_allgather_base_": ("all-gather", 1, 2),
    "allgather_coalesced_": ("all-gather", 1, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 2),
    "reduce_scatter_": ("reduce-scatter", 1, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 2),
    "alltoall_": ("all-to-all", 1, 2),
    "alltoall_base_": ("all-to-all", 1, 2),
    "send": ("collective-permute", 0, 1),
    "recv_": (None, 0, 1),
    "recv_any_source_": (None, 0, 1),
    "barrier": (None, None, None),
    "monitored_barrier_": (None, None, None),
    "check_for_nan": (None, None, None),
}
_TABLES = {"_c10d_functional": _FUNCTIONAL,
           "_c10d_functional_autograd": _FUNCTIONAL, "c10d": _C10D}
# namespaces whose every op is communication: an op of theirs missing
# from the tables raises
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                    "c10d_functional")


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(group) -> int:
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group).size()
    if isinstance(group, torch.ScriptObject):
        return dist.ProcessGroup.unbox(group).size()
    return group.size()


class CollectiveCounter(TorchDispatchMode):
    """Operand bytes per device of every collective issued under it, by
    the reference's five kinds (``collective_bytes``'s convention: an
    all-gather counts its local input, a reduce-scatter its full input, an
    all-reduce and an all-to-all their input, a send its tensor).

    It sees the functional collectives DTensor's ``redistribute`` issues
    (``torch.ops._c10d_functional``) and the c10d ops behind explicit
    ``torch.distributed`` calls. A DTensor op is handed back to DTensor
    (``NotImplemented``), which desugars it into local ops and collectives
    that reach the counter. A collective over a group of one rank moves
    nothing between cards and is not counted. A communication op it has no
    kind for raises ``UnmappedCollective``, naming it. ``off_thread``
    counts the collectives that reached it from another thread than the
    one that entered it (autograd's device threads run a CUDA backward)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._thread = threading.get_ident()
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.off_thread = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        ns = func.namespace
        if ns in _COMM_NAMESPACES:
            self._count(ns, func, args)
        return func(*args, **kwargs)

    def _count(self, ns: str, func, args) -> None:
        name = func._schema.name.split("::", 1)[1]
        entry = _TABLES.get(ns, {}).get(name)
        if entry is None:
            raise UnmappedCollective(
                f"the collective counter has no kind for {ns}::{name}")
        kind, operand, group = entry
        if kind is None or _group_size(args[group]) == 1:
            return
        self.bytes[kind] += _tensor_bytes(args[operand])
        self.counts[kind] += 1
        if threading.get_ident() != self._thread:
            self.off_thread += 1

    def record(self) -> dict:
        """``collective_bytes``' layout: bytes per kind, ``counts`` and
        ``total``; with ``off_thread``."""
        return {**self.bytes, "counts": dict(self.counts),
                "total": sum(self.bytes.values()),
                "off_thread": self.off_thread}


# ---------------------------------------------------------------------------
# the split and the fit rule
# ---------------------------------------------------------------------------

def split_rule(cfg: ModelConfig, shape: InputShape, mesh,
               variant: Optional[dict] = None) -> dict:
    """How ``shape``'s step splits on ``mesh``: ``{"microbatches": n}``
    (train) or ``{"chunks": n}`` (prefill, decode), with ``by``: the
    variant's microbatches, the rule, or decode's none. The rule takes the
    smallest power of two n dividing the global batch B whose slices of
    B / n rows keep at most ``DRYRUN_CHUNK_TOKENS`` tokens per data rank
    and, in training, at most ``DRYRUN_LOGITS_BYTES`` of float32 logits
    per rank (``logits_bytes``: the tokens times ``cfg``'s logit columns,
    split over the model axis as ``steps._logits_spec`` splits them),
    while each slice still splits evenly over the data axes."""
    from repro_torch.models import sharding as S
    variant = variant or {}
    b = shape.global_batch
    key = "microbatches" if shape.kind == "train" else "chunks"
    if shape.kind == "decode":
        return {key: 1, "by": "decode"}
    if shape.kind == "train" and "microbatches" in variant:
        return {key: variant["microbatches"], "by": "variant"}
    ms = S.mesh_shape(mesh)
    data = S.axis_size(ms, S.batch_axes(ms, b))
    model = S.axis_size(ms, "model")
    cols = cfg.padded_vocab * (cfg.n_codebooks if cfg.arch_type == "audio"
                               else 1)
    if cfg.padded_vocab % model == 0:
        cols //= model

    def tokens(n):
        return b // n // data * shape.seq_len

    def over(n):
        return tokens(n) > DRYRUN_CHUNK_TOKENS or (
            shape.kind == "train"
            and 4 * tokens(n) * cols > DRYRUN_LOGITS_BYTES)
    n = 1
    while over(n) and b % (2 * n) == 0 and (b // (2 * n)) % data == 0:
        n *= 2
    out = {key: n, "by": "rule", "tokens_per_data_rank": tokens(n)}
    if shape.kind == "train":
        out["logits_bytes"] = 4 * tokens(n) * cols
    return out


def _local_bytes(shape: tuple, dtype, place: tuple, sizes: tuple) -> int:
    dims = list(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            dims[p.dim] //= sizes[i]
    return math.prod(dims) * torch.empty((), dtype=dtype).element_size()


def _placed_leaves(tree, place) -> list:
    """``(leaf, placements)`` of two trees of one structure."""
    from repro_torch.models import sharding as S
    got = dict(S.flat_paths(tree))
    return [(got[path], p) for path, p in S.flat_paths(place)]


def state_bytes(cfg: ModelConfig, shape: InputShape, mesh,
                fsdp: bool = True, microbatches: int = 1) -> dict:
    """The exact state bytes a rank of ``mesh`` (a ``DeviceMesh`` or
    ``MeshShape``) holds for ``shape``'s step, from the shard shapes of
    the placements (the trees walked on the meta device): ``params``; in
    training ``master`` (float32, where the parameters are not), ``m`` and
    ``v`` (float32) and ``grads`` (the accumulators, float32, under
    microbatches; else the parameters' dtypes); for prefill and decode
    ``cache``. ``total`` sums them."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    ms = S.mesh_shape(mesh)
    sizes = ms.axis_sizes
    params = M.init_params(cfg, torch.Generator(), device="meta")
    leaves = _placed_leaves(params, S.param_shardings(cfg, ms, fsdp))
    out = {"params": sum(_local_bytes(t.shape, t.dtype, p, sizes)
                         for t, p in leaves)}
    if shape.kind == "train":
        f32 = sum(_local_bytes(t.shape, torch.float32, p, sizes)
                  for t, p in leaves)
        out["m"] = out["v"] = f32
        if any(t.dtype != torch.float32 for t, _ in leaves):
            out["master"] = f32
        out["grads"] = f32 if microbatches > 1 else out["params"]
    else:
        b, ctx = shape.global_batch, shape.seq_len
        cache = M.init_cache(cfg, b, ctx, device="meta")
        place = S.map_with_path(lambda _, sp: S.placements(sp, ms),
                                S.cache_specs(cfg, ms, b, ctx))
        out["cache"] = sum(_local_bytes(t.shape, t.dtype, p, sizes)
                           for t, p in _placed_leaves(cache, place))
    out["total"] = sum(out.values())
    return out


def _budget() -> float:
    from repro_torch.launch.mesh import HBM_BYTES
    return HBM_BYTES


def _fits(need: int, budget: float, peak: Optional[float] = None) -> bool:
    return max(need, peak or 0) + DRYRUN_RESERVE <= budget


# ---------------------------------------------------------------------------
# one step on the mesh
# ---------------------------------------------------------------------------

def _rows(t, n: int, i: int):
    """Rows ``i`` of ``n`` slices of a batch-first DTensor: each rank's
    i-th part of its local rows, so the slice keeps the placements."""
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    r = local.shape[0] // n
    return DTensor.from_local(local[i * r:(i + 1) * r], t.device_mesh,
                              t.placements, run_check=False)


def _write_rows(cache: dict, part: dict, n: int, i: int) -> None:
    """Copy a slice's cache into its rows (dim 1) of the whole cache,
    shard by shard."""
    from repro_torch.models import sharding as S
    got = dict(S.flat_paths(part))
    for path, whole in S.flat_paths(cache):
        src = got[path]
        if tuple(src.placements) != tuple(whole.placements):
            raise ValueError(f"cache leaf {path}: a slice placed "
                             f"{src.placements}, the whole {whole.placements}")
        local = whole.to_local()
        r = local.shape[1] // n
        local[:, i * r:(i + 1) * r].copy_(src.to_local())


def zero_cache(cfg: ModelConfig, mesh, batch: int, seq_len: int,
               place: dict) -> dict:
    """``init_cache(cfg, batch, seq_len)``'s values on ``mesh`` by
    ``place``, each rank allocating only its shards."""
    import torch.distributed.tensor as DT
    from repro_torch import tree as T
    from repro_torch.models import model as M
    like = M.init_cache(cfg, batch, seq_len, device="meta")

    def make(t, p):
        fill = -1 if t.dtype == torch.int32 else 0
        return DT.full(tuple(t.shape), fill, dtype=t.dtype,
                       device_mesh=mesh, placements=p)
    return T.tree_map(make, like, place)


def _step_program(cfg: ModelConfig, shape: InputShape, mesh, fsdp: bool,
                  split: dict, seed: int, dev):
    """``(run, state)``: ``run()`` takes one step of ``shape.kind`` on
    ``mesh`` from seeded weights and batch; ``state`` holds what it keeps
    alive."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import sharding as S
    from repro_torch.optim.adamw import init_opt_state
    params = S.init_sharded_params(
        cfg, mesh, torch.Generator(device=dev).manual_seed(seed),
        fsdp_on=fsdp)
    bgen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, seq = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        step, _ = ST.sharded_step(cfg, shape, mesh, fsdp_params=fsdp,
                                  microbatches=split["microbatches"])
        opt = init_opt_state(params)
        batch = make_batch(cfg, seq, b, "train", bgen)
        return (lambda: step(params, opt, batch)), [params, opt, batch]
    if shape.kind == "prefill":
        n = split["chunks"]
        part = dataclasses.replace(shape, global_batch=b // n)
        step, _ = ST.sharded_step(cfg, part, mesh, fsdp_params=fsdp,
                                  max_seq_len=seq)
        _, whole = ST.sharded_step(cfg, shape, mesh, fsdp_params=fsdp)
        batch = {k: S.distribute(v, mesh, whole["batch"][k]) for k, v in
                 make_batch(cfg, seq, b, "prefill", bgen).items()}
        cache = zero_cache(cfg, mesh, b, seq, whole["cache"])

        def run():
            for i in range(n):
                _, got = step(params, {k: _rows(v, n, i)
                                       for k, v in batch.items()})
                _write_rows(cache, got, n, i)
                del got
        return run, [params, batch, cache]
    step, sh = ST.sharded_step(cfg, shape, mesh, fsdp_params=fsdp)
    cache = zero_cache(cfg, mesh, b, seq, sh["cache"])
    batch = make_batch(cfg, seq, b, "decode", bgen)
    pos = torch.full((b,), seq - 1, dtype=torch.int32, device=dev)
    return (lambda: step(params, cache, batch, pos)), [params, cache, batch]


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _barrier(dev) -> None:
    import torch.distributed as dist
    if dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    _sync(dev)


def measure_depth(cfg: ModelConfig, shape: InputShape, mesh, *, fsdp: bool,
                  split: dict, reps: int, seed: int = 0) -> dict:
    """One depth of ``cfg`` (its ``num_layers``) on ``mesh``, on every rank:
    the fit rule, then one warm-up step under ``CollectiveCounter`` and
    ``reps`` timed steps, each started and ended by a barrier. The record
    is the same on every rank: ``memory`` (the largest peak over the
    ranks; None off the card), ``cost`` (``step_ms``: each step's largest
    time over the ranks, and their median), ``collectives`` (the largest
    count of each kind over the ranks; ``equal_over_ranks``), ``state``
    and ``per_rank``; or ``skipped``."""
    import torch.distributed as dist
    budget = _budget()
    state = state_bytes(cfg, shape, mesh, fsdp,
                        split.get("microbatches", 1))
    rec: dict = {"layers": cfg.num_layers, "state": state}
    if not _fits(state["total"], budget):
        rec["skipped"] = {"state_bytes": state["total"],
                          "reserve_bytes": DRYRUN_RESERVE,
                          "budget_bytes": budget}
        return rec
    dev = _device(mesh)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run, alive = _step_program(cfg, shape, mesh, fsdp, split, seed, dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _barrier(dev)
    counter = CollectiveCounter()
    t0 = time.perf_counter()
    with counter:
        run()
    _sync(dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    _barrier(dev)
    times = []
    for _ in range(reps):
        _barrier(dev)
        t0 = time.perf_counter()
        run()
        _barrier(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    mine = {"step_ms": times, "warm_ms": warm_ms, "setup_s": setup_s,
            "peak_bytes": torch.cuda.max_memory_allocated()
            if on_card else None,
            "collectives": counter.record()}
    del run, alive
    if on_card:
        torch.cuda.empty_cache()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    step_ms = [max(r["step_ms"][i] for r in ranks) for i in range(reps)]
    peaks = [r["peak_bytes"] for r in ranks]
    colls = [r["collectives"] for r in ranks]
    coll = {k: max(c[k] for c in colls) for k in _COLLECTIVES}
    coll["counts"] = {k: max(c["counts"][k] for c in colls)
                      for k in _COLLECTIVES}
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    coll["off_thread"] = max(c["off_thread"] for c in colls)
    coll["equal_over_ranks"] = all(
        {k: c[k] for k in _COLLECTIVES} == {k: colls[0][k]
                                            for k in _COLLECTIVES}
        for c in colls)
    rec.update(
        memory={"peak_bytes": max(peaks) if None not in peaks else None},
        cost={"step_ms": statistics.median(step_ms) if step_ms else None,
              "step_ms_runs": step_ms},
        collectives=coll,
        per_rank=[{k: r[k] for k in ("step_ms", "warm_ms", "setup_s",
                                     "peak_bytes")} for r in ranks])
    return rec


def _extrapolate(p1: dict, p2: dict, l1: int, l2: int, L: int) -> dict:
    def lin(a, b):
        return None if a is None or b is None else _lin_extrapolate(
            a, b, l1, l2, L)
    c1, c2 = p1["collectives"], p2["collectives"]
    return {"step_ms": lin(p1["cost"]["step_ms"], p2["cost"]["step_ms"]),
            "peak_bytes": lin(p1["memory"]["peak_bytes"],
                              p2["memory"]["peak_bytes"]),
            "collective_bytes": lin(c1["total"], c2["total"]),
            "collectives_by_kind": {k: lin(c1[k], c2[k])
                                    for k in _COLLECTIVES}}


def measure_pair(cfg: ModelConfig, shape: InputShape, mesh, *,
                 variant: Optional[dict] = None, reps: int = DEFAULT_REPS,
                 full: bool = False, seed: int = 0) -> dict:
    """``cfg`` x ``shape`` measured on ``mesh`` (every rank calls it) at the
    two probe depths of ``_probe_depths`` and extrapolated to
    ``cfg.num_layers``; with ``full``, also run at full depth where the
    fit rule admits it with the probes' extrapolated peak. The split is
    ``split_rule``'s, by ``variant`` (``microbatches``, ``fsdp_params``).
    ``ok`` is False where the fit rule skipped a
    probe (``skipped`` says why)."""
    variant = variant or {}
    fsdp = variant.get("fsdp_params", True)
    split = split_rule(cfg, shape, mesh, variant)
    l1, l2 = _probe_depths(cfg)
    kw = dict(fsdp=fsdp, split=split, reps=reps, seed=seed)
    rec: dict = {"split": split, "probes": {}}
    for li in (l1, l2):
        probe = measure_depth(dataclasses.replace(cfg, num_layers=li),
                              shape, mesh, **kw)
        rec["probes"][str(li)] = probe
        if "skipped" in probe:
            rec.update(ok=False, skipped={"probe": li, **probe["skipped"]},
                       full={"skipped": "probes skipped"})
            return rec
    p1, p2 = rec["probes"][str(l1)], rec["probes"][str(l2)]
    L = cfg.num_layers
    rec["extrapolated"] = _extrapolate(p1, p2, l1, l2, L)
    state = state_bytes(cfg, shape, mesh, fsdp, split.get("microbatches", 1))
    peak = rec["extrapolated"]["peak_bytes"]
    numbers = {"state_bytes": state["total"],
               "extrapolated_peak_bytes": peak,
               "reserve_bytes": DRYRUN_RESERVE,
               "budget_bytes": _budget()}
    if not full:
        rec["full"] = {"skipped": {"reason": "full=False", **numbers}}
    elif not _fits(state["total"], _budget(), peak):
        rec["full"] = {"skipped": {"reason": "over the card", **numbers}}
    elif L in (l1, l2):
        rec["full"] = rec["probes"][str(L)]
    else:
        rec["full"] = measure_depth(cfg, shape, mesh, **kw)
    rec["ok"] = True
    return rec


# ---------------------------------------------------------------------------
# run_pair and the command line
# ---------------------------------------------------------------------------

def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def pair_config(arch: str, variant: dict, testing: Optional[dict] = None
                ) -> ModelConfig:
    """The configuration a pair runs: ``get_config(arch)`` under the
    reference's variants, ``param_dtype`` ``"bf16"``, ``kv_quant`` and
    ``pad_heads`` (``microbatches`` and ``fsdp_params`` shape the step).
    ``testing`` (tests only) first reduces it (``configs.base.reduced``)
    with ``testing["config"]``'s fields."""
    cfg = get_config(arch)
    if testing:
        cfg = dataclasses.replace(reduced(cfg), **testing.get("config", {}))
    if variant.get("param_dtype") == "bf16":
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    if variant.get("kv_quant"):
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    if variant.get("pad_heads"):
        cfg = dataclasses.replace(cfg, n_heads=variant["pad_heads"],
                                  head_dim=cfg.resolved_head_dim)
    return cfg


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             variant: Optional[dict] = None, *, reps: int = DEFAULT_REPS,
             full: bool = False, device: str = "cuda",
             testing: Optional[dict] = None) -> dict:
    """One (architecture x input shape x mesh), every rank of the current
    process group calling it: ``measure_pair`` with the reference's keys
    around it, on the production mesh (``make_production_mesh``) where
    the world is a multiple of 4, else on the host mesh (1, world).
    ``testing`` (tests only): ``config`` (reduced configuration fields)
    and ``shapes`` (``{name: [seq_len, global_batch]}`` replacing
    ``INPUT_SHAPES``' sizes)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    variant = variant or {}
    testing = testing or {}
    cfg = pair_config(arch, variant, testing)
    shape = INPUT_SHAPES[shape_name]
    if shape_name in testing.get("shapes", {}):
        seq, batch = testing["shapes"][shape_name]
        shape = dataclasses.replace(shape, seq_len=seq, global_batch=batch)
    world = dist.get_world_size()
    if world % mesh_lib.CARDS_PER_HOST:
        mesh = mesh_lib.make_host_mesh(model=world, device=device)
    else:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=device)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": _mesh_name(mesh), "devices": mesh.size(),
                 "variant": variant}
    rec.update(measure_pair(cfg, shape, mesh, variant=variant, reps=reps,
                            full=full))
    rec.update(analytic_record(cfg, shape))
    return rec


def pair_rank(payload: dict) -> dict:
    """One rank of one pair (``launch.ranks`` runs it): ``run_pair`` of
    the payload's ``arch``, ``shape``, ``multi_pod``, ``variant``,
    ``reps``, ``full``, ``device`` and ``testing``."""
    return run_pair(payload["arch"], payload["shape"], payload["multi_pod"],
                    payload["variant"], reps=payload["reps"],
                    full=payload["full"], device=payload["device"],
                    testing=payload.get("testing"))


def main(argv=None, *, device: str = "cuda",
         testing: Optional[dict] = None) -> None:
    """The CLI. ``device`` and ``testing`` are for tests: ``"cpu"`` runs
    the ranks on gloo, ``testing`` goes to ``run_pair``."""
    from repro_torch.launch import ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant key suffix")
    ap.add_argument("--param-dtype", default="", choices=["", "bf16"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp-params", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad n_heads to this count (TP head padding)")
    ap.add_argument("--reps", type=int, default=DEFAULT_REPS,
                    help="timed steps per depth, after one warm-up step")
    ap.add_argument("--full", action="store_true",
                    help="also run the full depth where the fit rule "
                         "admits it")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks, one per card (default: the visible cards)")
    args = ap.parse_args(argv)
    variant: dict[str, Any] = {}
    if args.kv_quant:
        variant["kv_quant"] = True
    if args.pad_heads:
        variant["pad_heads"] = args.pad_heads
    if args.param_dtype:
        variant["param_dtype"] = args.param_dtype
    if args.microbatches != 1:
        variant["microbatches"] = args.microbatches
    if args.no_fsdp_params:
        variant["fsdp_params"] = False
    world = args.world or (torch.cuda.device_count() if device == "cuda"
                           else 1)
    target = f"{Path(__file__).resolve()}:pair_rank"

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|{mesh_kind}"
                if args.tag:
                    key += f"|{args.tag}"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                payload = {"arch": arch, "shape": shape_name,
                           "multi_pod": mesh_kind == "multi",
                           "variant": variant, "reps": args.reps,
                           "full": args.full, "device": device,
                           "testing": testing}
                try:
                    rec = ranks.run(target, payload, world, device=device,
                                    wall_s=PAIR_WALL_S)[0]
                except Exception:
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "ok": False, "error": traceback.format_exc()[-2000:]}
                    print(rec["error"], flush=True)
                results[key] = rec
                out_path.write_text(json.dumps(results, indent=1))
                status = "OK" if rec.get("ok") else "FAIL"
                extr = rec.get("extrapolated", {})
                print(f"[dryrun] {key} {status} "
                      f"step_ms={extr.get('step_ms')} "
                      f"coll={extr.get('collective_bytes')}", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"done: {n_ok}/{len(results)} pairs OK")


if __name__ == "__main__":
    main()
