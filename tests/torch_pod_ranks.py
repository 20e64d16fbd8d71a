"""Rank programs of ``tests/test_torch_pod_serve.py``.

``repro_torch.launch.ranks`` runs each function here in fresh
interpreters, one per rank, inside a gloo process group. Nothing here
imports jax: the reference's parameters and prompts arrive as NumPy
arrays in the payload's ``inputs`` file, and what a rank finds goes back
as JSON (tokens, local shard shapes, messages) and, from rank 0, as the
gathered logits and caches in one ``.npz`` per case under ``out``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
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
