"""Rank programs of ``tests/test_torch_dryrun.py``.

``repro_torch.launch.ranks`` runs each function here in fresh
interpreters, one per rank, inside a gloo process group. Nothing here
imports jax: what a rank finds goes back as JSON (collective bytes and
counts per depth, state bytes, messages), the same on every rank.
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import base as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import sharding as S
from repro_torch.optim.adamw import init_opt_state


def make_mesh(name: str):
    """``1x4`` and ``1x1x4``: the production meshes; ``2x2`` and ``1x1``:
    host meshes."""
    if name == "1x4":
        return MS.make_production_mesh(device="cpu")
    if name == "1x1x4":
        return MS.make_production_mesh(multi_pod=True, device="cpu")
    data, model = map(int, name.split("x"))
    return MS.make_host_mesh(model=model, device="cpu")


def case_config(arch: str, layers: int) -> C.ModelConfig:
    return dataclasses.replace(C.reduced(C.get_config(arch)),
                               num_layers=layers)


def case_shape(kind: str, sizes: dict) -> C.InputShape:
    seq, batch = sizes[kind]
    return C.InputShape(kind, seq, batch, kind)


def _bytes(coll: dict) -> dict:
    return {k: coll[k] for k in DR._COLLECTIVES} | {"counts": coll["counts"]}


def linearity(payload: dict) -> dict:
    """Every ``[arch, kind, full, third]`` case of ``payload["cases"]`` on
    the mesh ``payload["mesh"]``: the collectives at the two probe depths,
    at ``third`` and at the full depth ``full`` (``measure_pair`` with
    ``full=True``; no timed steps); with ``payload["probes_only"]`` the
    probes alone."""
    mesh = make_mesh(payload["mesh"])
    out = {}
    for arch, kind, full, third in payload["cases"]:
        cfg = case_config(arch, full)
        shape = case_shape(kind, payload["sizes"])
        rec = DR.measure_pair(cfg, shape, mesh, reps=0,
                              full=not payload.get("probes_only"))
        l1, l2 = DR._probe_depths(cfg)
        got = {"probes": {d: _bytes(rec["probes"][str(d)]["collectives"])
                          for d in (l1, l2)},
               "equal_over_ranks": all(
                   rec["probes"][str(d)]["collectives"]["equal_over_ranks"]
                   for d in (l1, l2)),
               "split": rec["split"]}
        if not payload.get("probes_only"):
            mid = DR.measure_depth(
                dataclasses.replace(cfg, num_layers=third), shape, mesh,
                fsdp=True, split=rec["split"], reps=0)
            got["depths"] = {third: _bytes(mid["collectives"]),
                             full: _bytes(rec["full"]["collectives"])}
        out[f"{arch}|{kind}"] = got
    return out


def split_cases(payload: dict) -> dict:
    """On (2, 2): each ``[arch, kind]`` case at two layers, narrowed by
    ``payload["narrow"]``, in 1, 2 and 4 slices (the variant's
    microbatches for train, ``DRYRUN_CHUNK_TOKENS`` set to a slice's
    tokens for prefill), with FSDP on and off: the split and the
    collectives of one step."""
    mesh = make_mesh("2x2")
    out = {}
    chunk_tokens = DR.DRYRUN_CHUNK_TOKENS
    try:
        for arch, kind in payload["cases"]:
            cfg = dataclasses.replace(case_config(arch, 2),
                                      **payload["narrow"])
            shape = case_shape(kind, payload["sizes"])
            per_rank = shape.global_batch // 2 * shape.seq_len
            for n in (1, 2, 4):
                for fsdp in (True, False):
                    variant = {"fsdp_params": fsdp}
                    if kind == "train":
                        variant["microbatches"] = n
                    DR.DRYRUN_CHUNK_TOKENS = per_rank // n
                    split = DR.split_rule(cfg, shape, mesh, variant)
                    rec = DR.measure_depth(cfg, shape, mesh, fsdp=fsdp,
                                           split=split, reps=0)
                    out[f"{arch}|{kind}|{n}|{fsdp}"] = {
                        "split": split,
                        "collectives": _bytes(rec["collectives"])}
    finally:
        DR.DRYRUN_CHUNK_TOKENS = chunk_tokens
    return out


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in T.leaves(tree))


def _train_grads_bytes(cfg, shape, mesh, fsdp: bool, mb: int,
                       params) -> int:
    """The local bytes of the gradients one real ``sharded_step`` train
    step holds: what ``steps.loss_and_grads`` returns (the backward's
    gradients, or the float32 accumulators under microbatches), read
    through a spy on it."""
    seen = []
    real = ST.loss_and_grads

    def spy(*a, **k):
        metrics, grads = real(*a, **k)
        seen.append(_local_bytes(grads))
        return metrics, grads
    step, _ = ST.sharded_step(cfg, shape, mesh, fsdp_params=fsdp,
                              microbatches=mb)
    batch = C.make_batch(cfg, shape.seq_len, shape.global_batch, "train",
                         torch.Generator().manual_seed(1))
    ST.loss_and_grads = spy
    try:
        step(params, init_opt_state(params), batch)
    finally:
        ST.loss_and_grads = real
    assert len(seen) == 1, seen
    return seen[0]


def fit_cases(payload: dict) -> dict:
    """On (2, 2): ``state_bytes`` of every ``[arch, kind, fsdp, param
    dtype]`` case beside the local bytes of the tensors a step holds:
    ``init_sharded_params``' parameters, ``init_opt_state``'s master, m
    and v, the gradients of one real train step (``_train_grads_bytes``),
    the cache of ``zero_cache``. Then a pair over a card of
    ``payload["budget"]`` bytes (``launch.mesh.HBM_BYTES`` set to it),
    with ``init_sharded_params`` and ``sharded_step`` replaced by
    functions that raise."""
    mesh = make_mesh("2x2")
    out = {}
    for arch, kind, fsdp, dtype in payload["cases"]:
        cfg = dataclasses.replace(case_config(arch, 2),
                                  param_dtype=getattr(torch, dtype))
        shape = case_shape(kind, payload["sizes"])
        for mb in ((1, 2) if kind == "train" else (1,)):
            want = DR.state_bytes(cfg, shape, mesh, fsdp, mb)
            params = S.init_sharded_params(
                cfg, mesh, torch.Generator().manual_seed(0), fsdp_on=fsdp)
            got = {"params": _local_bytes(params)}
            if kind == "train":
                opt = init_opt_state(params)
                for k in ("m", "v", "master"):
                    if k in opt:
                        got[k] = _local_bytes(opt[k])
                got["grads"] = _train_grads_bytes(cfg, shape, mesh, fsdp,
                                                  mb, params)
            else:
                _, sh = ST.sharded_step(cfg, shape, mesh, fsdp_params=fsdp)
                got["cache"] = _local_bytes(DR.zero_cache(
                    cfg, mesh, shape.global_batch, shape.seq_len,
                    sh["cache"]))
            got["total"] = sum(got.values())
            out[f"{arch}|{kind}|{fsdp}|{dtype}|{mb}"] = {"want": want,
                                                         "got": got}
    calls = []

    def refuse(name):
        def fn(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called for a skipped pair")
        return fn
    real = S.init_sharded_params, ST.sharded_step, MS.HBM_BYTES
    S.init_sharded_params = refuse("init_sharded_params")
    ST.sharded_step = refuse("sharded_step")
    MS.HBM_BYTES = payload["budget"]
    try:
        arch, kind = payload["skipped"]
        rec = DR.measure_pair(case_config(arch, 4),
                              case_shape(kind, payload["sizes"]), mesh,
                              full=True)
    finally:
        S.init_sharded_params, ST.sharded_step, MS.HBM_BYTES = real
    out["skipped"] = {"ok": rec["ok"], "skipped": rec.get("skipped"),
                      "full": rec["full"], "calls": calls,
                      "probes": sorted(rec["probes"])}
    return out


def run_pairs(payload: dict) -> dict:
    """``run_pair`` of ``payload["arch"]`` at decode_32k (sized by
    ``payload["testing"]``) on the single and the multi mesh, no timed
    steps: the mesh each ran on and its devices."""
    out = {}
    for multi in (False, True):
        rec = DR.run_pair(payload["arch"], "decode_32k", multi, reps=0,
                          device="cpu", testing=payload["testing"])
        out["multi" if multi else "single"] = {
            "mesh": rec["mesh"], "devices": rec["devices"], "ok": rec["ok"]}
    return out


def convention(payload: dict) -> dict:
    """On four ranks, on a 1-D mesh of all of them: an all-gather of a (2,
    1024) bf16 shard through DTensor, an all-reduce of (128,) float32
    through ``dist``, a reduce-scatter of a (128, 16) float32 input
    through DTensor; the counter's record beside ``CommDebugMode``'s
    counts of the same calls. Then an all-reduce over a group of one rank
    (not counted), and a broadcast, which the counter must refuse."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    world = dist.get_world_size()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    solo = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(dist.get_rank())
    shard = torch.randn(2, 1024, generator=gen).to(torch.bfloat16)
    vec = torch.randn(128, generator=gen)
    part = torch.randn(128, 16, generator=gen)
    counter = DR.CollectiveCounter()
    with CommDebugMode() as debug, counter:
        DTensor.from_local(shard, mesh, (Shard(0),)).redistribute(
            mesh, (Replicate(),)).to_local()
        dist.all_reduce(vec)
        DTensor.from_local(part, mesh, (Partial(),)).redistribute(
            mesh, (Shard(0),)).to_local()
    solo_counter = DR.CollectiveCounter()
    with solo_counter:
        dist.all_reduce(vec.clone(), group=solo.get_group("model"))
    refused = None
    try:
        with DR.CollectiveCounter():
            dist.broadcast(vec.clone(), src=0)
    except DR.UnmappedCollective as e:
        refused = str(e)
    return {"record": counter.record(),
            "debug": {str(k): v for k, v in debug.get_comm_counts().items()},
            "debug_total": debug.get_total_counts(),
            "solo": solo_counter.record(), "refused": refused}


PROGRAMS = {"linearity": linearity, "split": split_cases, "fit": fit_cases,
            "convention": convention, "run_pair": run_pairs}


def programs(payload: dict) -> dict:
    """Each program named in ``payload["programs"]`` (a key of PROGRAMS)
    on its own payload, in turn, in one launch."""
    return {name: PROGRAMS[name](payload[name])
            for name in payload["programs"]}
