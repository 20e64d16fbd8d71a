"""Rank programs of ``tests/test_torch_pod_serve.py`` and
``tests/test_torch_pod_train.py``.

``repro_torch.launch.ranks`` runs each function here in fresh
interpreters, one per rank, inside a gloo process group. Nothing here
imports jax: the reference's parameters and prompts arrive as NumPy
arrays in the payload's ``inputs`` file, and what a rank finds goes back
as JSON (tokens, local shard shapes, messages) and, from rank 0, as the
gathered logits and caches (or gradients and trained state) in one
``.npz`` per case under ``out``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import base as C
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models import sharding as S


def f32_config(arch: str) -> M.ModelConfig:
    """The reduced configuration of ``arch`` in float32 compute."""
    return dataclasses.replace(C.reduced(C.get_config(arch)),
                               compute_dtype=torch.float32)


def nested(flat: dict) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def greedy(logits: torch.Tensor, cfg: M.ModelConfig) -> torch.Tensor:
    """The next tokens of (B, 1, V) logits, or (B, 1, CB, V) for audio:
    the first largest over the real vocabulary."""
    return logits[..., :cfg.vocab_size].argmax(-1).to(torch.int32)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered on every rank (a copy: the step writes its cache
    in place later)."""
    return t.full_tensor().clone()


def _local_shapes(tree, paths) -> dict:
    return {p: list(t.to_local().shape) for p, t in paths(tree)}


def _cache_paths(tree):
    out = []
    S.map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


def serve_cases(payload: dict) -> dict:
    """Sharded prefill and greedy decode of every ``[arch, fsdp]`` case on
    the ``(data, model)`` mesh ``payload["shape"]``."""
    rank = dist.get_rank()
    data, model = payload["shape"]
    mesh = MS.make_host_mesh(model=model, device="cpu")
    assert tuple(mesh.shape) == (data, model)
    inputs = np.load(payload["inputs"])
    b, p, n = payload["batch"], payload["prompt"], payload["steps"]
    out_dir = Path(payload["out"])
    found = {}
    for arch, fsdp in payload["cases"]:
        cfg = f32_config(arch)
        tree = nested({k.split("|", 2)[2]: inputs[k] for k in inputs.files
                       if k.startswith(f"{arch}|param|")})
        params = S.distribute_params(convert.model_params(tree, cfg), cfg,
                                     mesh, fsdp)
        batch = {k.split("|", 2)[2]: torch.from_numpy(inputs[k])
                 for k in inputs.files if k.startswith(f"{arch}|batch|")}
        prefill, _ = ST.sharded_step(cfg, C.InputShape("p", p, b, "prefill"),
                                     mesh, fsdp, max_seq_len=p + n,
                                     cache_dtype=torch.float32)
        decode, _ = ST.sharded_step(cfg, C.InputShape("d", p + n, b,
                                                      "decode"), mesh, fsdp)
        logits, cache = prefill(params, batch)
        arrays = {"logits0": _whole(logits)}
        arrays.update({f"prefill/{k}": _whole(t)
                       for k, t in _cache_paths(cache)})
        shapes = {"params": _local_shapes(params, S.flat_paths),
                  "prefill": _local_shapes(cache, _cache_paths)}
        tokens = []
        for step in range(n):
            tok = greedy(arrays[f"logits{step}"], cfg)
            tokens.append(tok.tolist())
            pos = torch.full((b,), p + step, dtype=torch.int32)
            logits, cache = decode(params, cache, {"tokens": tok}, pos)
            arrays[f"logits{step + 1}"] = _whole(logits)
        arrays.update({f"decode/{k}": _whole(t)
                       for k, t in _cache_paths(cache)})
        shapes["decode"] = _local_shapes(cache, _cache_paths)
        if rank == 0:
            np.savez(out_dir / f"{arch}-{fsdp}.npz",
                     **{k: v.numpy() for k, v in arrays.items()})
        found[f"{arch}|{fsdp}"] = {"tokens": tokens, "shapes": shapes}
    return found


def place_multi_pod(payload: dict) -> dict:
    """The multi-pod production mesh, one reduced tree drawn piece by piece
    on it (``init_sharded_params``) against the whole tree distributed
    (``distribute_params``), the kernel wrappers handed a DTensor, and a
    bf16 product split over the model axis."""
    mesh = MS.make_production_mesh(multi_pod=True, device="cpu")
    cfg = f32_config(payload["arch"])
    drawn = S.init_sharded_params(cfg, mesh,
                                  torch.Generator().manual_seed(7))
    whole = S.distribute_params(
        M.init_params(cfg, torch.Generator().manual_seed(7)), cfg, mesh)
    a, w = dict(S.flat_paths(drawn)), dict(S.flat_paths(whole))
    differ = [k for k in w if not torch.equal(a[k].to_local(),
                                              w[k].to_local())
              or a[k].placements != w[k].placements]
    return {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
            "paths": sorted(a) == sorted(w), "differ": differ,
            "shapes": _local_shapes(drawn, S.flat_paths),
            "refused": _refusals(mesh),
            "bf16_product": _bf16_split_product(mesh)}


def _bf16_split_product(mesh) -> dict:
    """A bf16 ``dense_apply`` whose contracted dim is split over the model
    axis: this rank's partial product (its local shards' bf16 product) and
    the gathered result."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, generator=g).bfloat16()
    w = torch.randn(64, 16, generator=g).bfloat16()
    rest = (Replicate(),) * (mesh.ndim - 1)
    xd = S.distribute(x, mesh, rest + (Shard(2),))
    wd = S.distribute(w, mesh, rest + (Shard(0),))
    y = L.dense_apply({"w": wd}, xd)
    return {"partial": (xd.to_local() @ wd.to_local()).float().tolist(),
            "y": y.full_tensor().float().tolist(), "dtype": str(y.dtype),
            "replicated": [p.is_replicate() for p in y.placements]}


def _refusals(mesh) -> dict:
    """What each kernel wrapper raises when handed a DTensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.fulcrum import fused_window as FW
    from repro_torch.kernels.fulcrum import lane_sort as LS
    from repro_torch.kernels.fulcrum import maxplus_scan as MP
    from repro_torch.kernels.ssd_scan import ssd_scan as SS

    def d(*shape, dtype=torch.float32):
        return distribute_tensor(torch.zeros(shape, dtype=dtype), mesh,
                                 [Replicate()] * mesh.ndim)

    calls = {
        "flash_attention": lambda: FA.flash_attention(*(d(1, 2, 8, 64),) * 3),
        "flash_attention_bwd": lambda: FA.flash_attention_bwd(
            *(d(1, 2, 8, 64),) * 4, d(1, 2, 8), d(1, 2, 8, 64)),
        "ssd_chunk": lambda: SS.ssd_chunk(
            d(1, 1, 8, 2, 4), d(1, 1, 8, 2), d(1, 1, 8, 2), d(1, 1, 8, 4),
            d(1, 1, 8, 4)),
        "ssd_chunk_bwd": lambda: SS.ssd_chunk_bwd(
            d(1, 1, 8, 2, 4), d(1, 1, 8, 2), d(1, 1, 8, 2), d(1, 1, 8, 4),
            d(1, 1, 8, 4), d(1, 1, 8, 2, 4), d(1, 1, 2, 4, 4)),
        "tiled_matmul": lambda: ops.tiled_matmul(d(4, 4), d(4, 4)),
        "lane_sort": lambda: LS.lane_sort(d(2, 8, dtype=torch.float64)),
        "maxplus_scan": lambda: MP.maxplus_scan(
            *(d(2, 4, dtype=torch.float64),) * 2, d(2, dtype=torch.float64),
            d(2, dtype=torch.float64), d(2, dtype=torch.float64)),
        "fused_window": lambda: FW.fused_window(
            d(2, 4, dtype=torch.float64), d(2, 4, dtype=torch.float64),
            d(2, 4, dtype=torch.float64), d(2, dtype=torch.int64),
            d(2, 4, dtype=torch.float64), 0.0, 1.0, False, 4),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:                       # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"
    return out


def card_case(payload: dict) -> dict:
    """One reduced configuration in float32 on the cards (NCCL): the port's
    own weights drawn on each rank's card, the unsharded steps, then the
    sharded ones on the (1, world) mesh; the largest logit difference of
    prefill and ``steps`` decode steps fed the unsharded run's tokens, and
    the attention and SSD kernels' launches in the sharded run."""
    from repro_torch.kernels.flash_attention import flash_attention as K3
    from repro_torch.kernels.ssd_scan import ssd_scan as K4
    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = f32_config(payload["arch"])
    b, p, n = payload["batch"], payload["prompt"], payload["steps"]
    mesh = MS.make_host_mesh(model=world)
    batch = C.make_batch(cfg, p, b, "prefill",
                         torch.Generator(device=dev).manual_seed(1))
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sharded = S.init_sharded_params(cfg, mesh, torch.Generator(
        device=dev).manual_seed(0))
    prefill, _ = ST.sharded_step(cfg, C.InputShape("p", p, b, "prefill"),
                                 mesh, max_seq_len=p + n,
                                 cache_dtype=torch.float32)
    decode, _ = ST.sharded_step(cfg, C.InputShape("d", p + n, b, "decode"),
                                mesh)
    with torch.no_grad():
        want, cache = M.prefill(params, batch, cfg, p + n, torch.float32)
        K3.flash_attention.launches = K4.ssd_chunk.launches = 0
        got, dcache = prefill(sharded, batch)
        launches = {"flash_attention": K3.flash_attention.launches,
                    "ssd_chunk": K4.ssd_chunk.launches}
        err, scale = [], []
        for step in range(n + 1):
            g = got.full_tensor()
            err.append(float((g - want).abs().max()))
            scale.append(float(want.abs().max()))
            if step == n:
                break
            tok = greedy(want, cfg)
            pos = torch.full((b,), p + step, dtype=torch.int32, device=dev)
            want, cache = M.decode_step(params, cache, {"tokens": tok}, pos,
                                        cfg)
            got, dcache = decode(sharded, dcache, {"tokens": tok}, pos)
    return {"err": err, "scale": scale, "launches": launches}


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

STEP_OPTIONS = ("microbatches",)      # a case's overrides of the step


def tree_key(arch: str, over: dict) -> str:
    """The name a case's parameters and batch go under in the inputs: the
    configuration's, and the expert count where the case changes it."""
    return arch + (f"@{over['n_experts']}" if "n_experts" in over else "")


def train_config(arch: str, over: dict) -> M.ModelConfig:
    """``f32_config(arch)`` with the case's overrides: ``n_experts``,
    ``remat``, and ``param_dtype`` by name (``"bfloat16"``: bf16 matrices
    with a float32 master copy in the optimizer state)."""
    over = {k: v for k, v in over.items() if k not in STEP_OPTIONS}
    if "param_dtype" in over:
        over["param_dtype"] = getattr(torch, over["param_dtype"])
    return dataclasses.replace(f32_config(arch), **over)


def train_params(tree: dict, cfg: M.ModelConfig) -> dict:
    """The port's parameters from a reference tree, matrices (and the
    router) in ``cfg.param_dtype``, as ``init_params`` stores them."""
    params = convert.model_params(tree, cfg)
    if cfg.param_dtype == torch.float32:
        return params
    return T.tree_map(lambda t: t.to(cfg.param_dtype) if t.dim() >= 2
                      else t, params)


def case_name(arch: str, fsdp: bool, over: dict) -> str:
    extra = ",".join(f"{k}={v}" for k, v in sorted(over.items()))
    return f"{arch}|{fsdp}|{extra}"


def _gathered(prefix: str, tree) -> dict:
    return {f"{prefix}/{p}": t.detach().full_tensor().float().clone()
            for p, t in S.flat_paths(tree)}


def _spied_update(record: dict):
    """A spy around the train step's AdamW update that keeps, at the first
    step, the gradients it is given (DTensors), whether each came in its
    parameter's placements, and the optimizer state it leaves."""
    real = ST.adamw_update

    def spy(grads, opt_state, params, opt_cfg):
        stats = real(grads, opt_state, params, opt_cfg)
        if not record:
            record["grads"] = T.tree_map(lambda g: g.detach(), grads)
            record["placed"] = all(
                g.placements == p.placements for g, p in
                zip(T.leaves(grads), T.leaves(params)))
            record["state"] = {k: _gathered(k, opt_state[k])
                               for k in ("m", "v")}
        return stats
    return spy


def _adamw_parity(cfg, mesh, fsdp: bool, params0: dict, grads: dict,
                  opt_cfg) -> dict:
    """Two AdamW updates from ``params0`` (whole tensors) with the same
    gradients ``grads`` (DTensors), on the mesh and on whole tensors: the
    largest difference of each tree after them, as a share of its leaf's
    largest |value|."""
    from repro_torch.optim import adamw as A
    whole = T.tree_map(lambda t: t.clone(), params0)
    sharded = S.distribute_params(T.tree_map(lambda t: t.clone(), params0),
                                  cfg, mesh, fsdp)
    g_whole = T.tree_map(lambda g: g.full_tensor(), grads)
    st_w, st_s = A.init_opt_state(whole), A.init_opt_state(sharded)
    for _ in range(2):
        A.adamw_update(g_whole, st_w, whole, opt_cfg)
        A.adamw_update(grads, st_s, sharded, opt_cfg)
    worst = {}
    for name, a, b in (("params", whole, sharded),
                       *((k, st_w[k], st_s[k]) for k in ("m", "v", "master")
                         if k in st_w)):
        errs = [float((y.full_tensor().float() - x.float()).abs().max())
                / max(float(x.float().abs().max()), 1e-30)
                for x, y in zip(T.leaves(a), T.leaves(b))]
        worst[name] = max(errs)
    return worst


def _train_case(mesh, inputs, arch: str, fsdp: bool, over: dict,
                payload: dict, out_dir: Path) -> dict:
    from repro_torch.optim import adamw as A
    cfg = train_config(arch, over)
    key = tree_key(arch, over)
    tree = nested({k.split("|", 2)[2]: inputs[k] for k in inputs.files
                   if k.startswith(f"{key}|param|")})
    params0 = train_params(tree, cfg)
    params = S.distribute_params(T.tree_map(torch.clone, params0), cfg,
                                 mesh, fsdp)
    batch = {k.split("|", 2)[2]: torch.from_numpy(inputs[k])
             for k in inputs.files if k.startswith(f"{key}|batch|")}
    opt_cfg = A.AdamWConfig(**payload["opt"])
    step, shardings = ST.sharded_step(
        cfg, C.InputShape("t", payload["seq"], payload["batch"], "train"),
        mesh, fsdp, opt_cfg=opt_cfg,
        microbatches=over.get("microbatches", 1))
    opt_state = A.init_opt_state(params)
    first: dict = {}
    real = ST.adamw_update
    ST.adamw_update = _spied_update(first)
    try:
        metrics = [step(params, opt_state, batch) for _ in range(2)]
    finally:
        ST.adamw_update = real
    arrays = _gathered("grads", first["grads"])
    for k, v in first["state"].items():
        arrays.update(v)
    name = case_name(arch, fsdp, over)
    if dist.get_rank() == 0:
        np.savez(out_dir / f"{name.replace('|', '_')}.npz",
                 **{k: v.numpy() for k, v in arrays.items()})
    local = {k: {p: list(t.to_local().shape) for p, t in S.flat_paths(tree)}
             for k, tree in (("params", params),
                             *((k, opt_state[k]) for k in ("m", "v", "master")
                               if k in opt_state))}
    opt_place = shardings["opt_state"]
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "grads_placed": first["placed"], "local": local,
            "adamw": _adamw_parity(cfg, mesh, fsdp, params0, first["grads"],
                                   opt_cfg),
            "opt_keys": sorted(opt_place),
            "step": {"value": int(opt_state["step"].full_tensor()),
                     "replicated": all(p.is_replicate() for p in
                                       opt_state["step"].placements),
                     "spec_replicated": all(p.is_replicate()
                                            for p in opt_place["step"])},
            "state": (params, opt_state)}


def train_cases(payload: dict) -> dict:
    """The sharded train step of every ``[arch, fsdp, overrides]`` case on
    the ``(data, model)`` mesh ``payload["shape"]``: two steps from the
    reference's parameters on the same batch; rank 0 writes the first
    step's gradients and the state after the second, gathered. Then the
    extras the payload names: ``prefetch``, ``spy``, ``checkpoint``."""
    data, model = payload["shape"]
    mesh = MS.make_host_mesh(model=model, device="cpu")
    inputs = np.load(payload["inputs"])
    out_dir = Path(payload["out"])
    found, kept = {}, None
    for arch, fsdp, over in payload["cases"]:
        rec = _train_case(mesh, inputs, arch, fsdp, over, payload, out_dir)
        state = rec.pop("state")
        if [arch, fsdp, over] == payload.get("checkpoint"):
            kept = (arch, fsdp, over, state)
        found[case_name(arch, fsdp, over)] = rec
    if payload.get("prefetch"):
        found["prefetch"] = _prefetch(mesh, payload)
    if payload.get("spy"):
        found["spy"] = _spy(mesh, inputs, payload)
    if payload.get("checkpoint"):
        found["checkpoint"] = _checkpoints(mesh, kept, payload, out_dir)
    return found


def _prefetch(mesh, payload: dict) -> dict:
    """Two batches of each configuration's ``SyntheticTokenSource`` through
    ``ShardedPrefetcher`` onto the mesh: each rank writes its local shards
    (``prefetch_rank<r>.npz``) and returns their placements."""
    from repro_torch.data.pipeline import ShardedPrefetcher, \
        SyntheticTokenSource
    b, s, seed = payload["batch"], payload["seq"], payload["prefetch_seed"]
    arrays, places = {}, {}
    for arch in payload["prefetch"]:
        cfg = f32_config(arch)
        _, shardings = ST.sharded_step(cfg, C.InputShape("t", s, b, "train"),
                                       mesh)
        pf = ShardedPrefetcher(SyntheticTokenSource(cfg, b, s, seed), mesh,
                               shardings["batch"])
        try:
            for i in range(2):
                batch = next(pf)
                for k, v in batch.items():
                    arrays[f"{arch}|{i}|{k}"] = v.to_local().numpy()
                    places[f"{arch}|{i}|{k}"] = {
                        "same": tuple(v.placements) ==
                        tuple(shardings["batch"][k]),
                        "shape": list(v.shape)}
        finally:
            pf.close()
    np.savez(Path(payload["out"]) / f"prefetch_rank{dist.get_rank()}.npz",
             **arrays)
    return {"coords": mesh.get_coordinate(), "placed": places}


def _spy(mesh, inputs, payload: dict) -> dict:
    """One sharded train step of ``payload["spy"]`` (remat on) with the
    attention and SSD kernels' entry points and their plain backwards
    wrapped in recorders: for every call, whether an argument was a
    DTensor, and the head count it saw."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.ssd_scan import ssd_scan as SS
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw as A
    calls = []

    def record(kind, head_dim, fn):
        def spy(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            calls.append({"kind": kind,
                          "dtensor": any(S.is_dtensor(a) for a in tensors),
                          "heads": int(args[0].shape[head_dim])})
            return fn(*args, **kw)
        return spy
    patched = ((L, "flash_attention", "K3", 1),
               (FA, "flash_attention_bwd_plain", "K3_bwd", 1),
               (ops, "ssd_chunk", "K4", 3),
               (SS, "ssd_chunk_bwd_plain", "K4_bwd", 3))
    real = {(mod, name): getattr(mod, name) for mod, name, _, _ in patched}
    arch = payload["spy"]
    cfg = dataclasses.replace(f32_config(arch), remat=True)
    tree = nested({k.split("|", 2)[2]: inputs[k] for k in inputs.files
                   if k.startswith(f"{arch}|param|")})
    params = S.distribute_params(convert.model_params(tree, cfg), cfg, mesh)
    batch = {k.split("|", 2)[2]: torch.from_numpy(inputs[k])
             for k in inputs.files if k.startswith(f"{arch}|batch|")}
    step, _ = ST.sharded_step(
        cfg, C.InputShape("t", payload["seq"], payload["batch"], "train"),
        mesh)
    for mod, name, kind, dim in patched:
        setattr(mod, name, record(kind, dim, real[(mod, name)]))
    try:
        loss = step(params, A.init_opt_state(params), batch)["loss"]
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return {"calls": calls, "finite": bool(torch.isfinite(loss))}


def _checkpoints(mesh, kept, payload: dict, out_dir: Path) -> dict:
    """The kept case's trained ``(params, opt_state)`` saved from this mesh,
    then restored onto the (4, 1) and (1, 4) meshes of the same ranks and
    unsharded, each held bitwise against the saved state (and its
    placements against the sharded step's); and the reference's checkpoint
    ``payload["ref_checkpoint"]`` restored onto this mesh, gathered by
    rank 0 into ``ref_restored.npz``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import checkpoint as CK
    arch, fsdp, over, state = kept
    cfg = train_config(arch, over)
    path = out_dir / "saved.npz"
    CK.save_checkpoint(path, state, step=2)
    want = {p: t.full_tensor() for p, t in S.flat_paths(list(state))}
    shape = C.InputShape("t", payload["seq"], payload["batch"], "train")
    out = {"written": path.exists()}
    for name, dims in (("4x1", (4, 1)), ("1x4", (1, 4))):
        other = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        _, sh = ST.sharded_step(cfg, shape, other, fsdp)
        place = (sh["params"], sh["opt_state"])
        got, step = CK.restore_checkpoint(path, state, place, other)
        flat_place = dict(S.flat_paths(list(place)))
        out[name] = {
            "step": step,
            "equal": all(torch.equal(t.full_tensor(), want[p])
                         and t.dtype == want[p].dtype
                         for p, t in S.flat_paths(list(got))),
            "placed": all(tuple(t.placements) == tuple(flat_place[p])
                          for p, t in S.flat_paths(list(got)))}
    like = T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), state)
    got, step = CK.restore_checkpoint(path, like)
    out["unsharded"] = {
        "step": step,
        "equal": all(not S.is_dtensor(t) and torch.equal(t, want[p])
                     for p, t in S.flat_paths(list(got)))}
    got, step = CK.restore_checkpoint(
        payload["ref_checkpoint"], state,
        (S.param_shardings(cfg, mesh, fsdp),
         ST.sharded_step(cfg, shape, mesh, fsdp)[1]["opt_state"]), mesh)
    arrays = {p: t.full_tensor().numpy() for p, t in S.flat_paths(list(got))}
    if dist.get_rank() == 0:
        np.savez(out_dir / "ref_restored.npz", **arrays)
    out["ref"] = {"step": step, "local": {
        p: list(t.to_local().shape) for p, t in S.flat_paths(list(got))}}
    return out


def card_train_case(payload: dict) -> dict:
    """One reduced configuration in float32 with remat on the cards (NCCL):
    the port's own weights on each rank's card, one unsharded train step
    and one sharded on the (1, world) mesh from the same weights and
    batch; the loss's and grad norm's relative differences, the largest
    gradient leaf's difference as a share of its largest |g|, and the
    sharded step's kernel launches."""
    from repro_torch.kernels.flash_attention import flash_attention as K3
    from repro_torch.kernels.ssd_scan import ssd_scan as K4
    from repro_torch.optim import adamw as A
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(f32_config(payload["arch"]), remat=True)
    b, s = payload["batch"], payload["seq"]
    mesh = MS.make_host_mesh(model=dist.get_world_size())
    batch = C.make_batch(cfg, s, b, "train",
                         torch.Generator(device=dev).manual_seed(1))
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    for p in T.leaves(params):
        p.requires_grad_(True)
    want, wgrads = ST.loss_and_grads(params, batch, cfg)
    sharded = S.init_sharded_params(cfg, mesh, torch.Generator(
        device=dev).manual_seed(0))
    step, _ = ST.sharded_step(cfg, C.InputShape("t", s, b, "train"), mesh)
    record: dict = {}
    real = ST.adamw_update
    ST.adamw_update = _spied_update(record)
    wrappers = (K3.flash_attention, K3.flash_attention_bwd, K4.ssd_chunk,
                K4.ssd_chunk_bwd)
    for fn in wrappers:
        fn.launches = 0
    try:
        got = step(sharded, A.init_opt_state(sharded), batch)
    finally:
        ST.adamw_update = real
    launches = {fn.__name__: fn.launches for fn in wrappers}
    wnorm = float(A.global_norm(wgrads))
    worst = max(float((g.full_tensor() - w).abs().max())
                / max(float(w.abs().max()), 1e-30)
                for g, w in zip(T.leaves(record["grads"]),
                                T.leaves(wgrads)))
    return {"loss": abs(float(got["loss"]) - float(want["loss"]))
            / abs(float(want["loss"])),
            "grad_norm": abs(float(got["grad_norm"]) - wnorm) / wnorm,
            "grads": worst, "launches": launches}
