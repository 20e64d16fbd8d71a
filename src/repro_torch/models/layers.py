"""Neural-net building blocks of the port, in PyTorch.

Counterpart of ``repro.models.layers``: RMS/LayerNorm, rotary embeddings
with split halves, dense projections, GQA causal self-attention with a
ring-buffer KV cache (bf16, float32, or int8 with per-(slot, head) bf16
scales), the SwiGLU and tanh-GELU MLPs, the top-k capacity-factor mixture
of experts, the Mamba2 SSD mixer and the tied embedding / output head.
Params are plain nested dicts of tensors with the reference's names and
layouts, so a JAX parameter tree converts leaf by leaf
(``repro_torch.convert``).

Where the reference reaches a Pallas kernel's function, the port calls its
hand-written kernel: prefill attention goes through ``flash_attention``
(K3) and the prefill SSD scan through ``ops.ssd_scan`` (K4 plus the
inter-chunk recurrence). Each kernel wrapper launches CUDA for CUDA tensors
and runs its plain version for CPU tensors, so a layer runs wherever its
inputs lie. Decode paths are plain torch ops, as in the reference. The
reference computes the MoE with ``einsum`` (no Pallas kernel): the port's
expert products are ``torch.bmm``.

The decode paths update the caches they are given in place (the reference
returns fresh arrays): a step touches O(B * H * D) cache entries instead of
copying the whole cache.

On a device mesh (``launch.steps.sharded_step``) the layers take DTensors
and torch ops carry the placements; ``constrain`` is the reference's
activation-sharding hook. A kernel never sees a DTensor: the attention
kernel, the SSD scan and decode's recurrence, the ring-buffer writes and
cached attention of decode, the experts' dispatch and the embedding's
lookup run on each rank's local shards through ``sharding.local_map``,
with local heads or experts where the model axis divides them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.models.sharding import (grad_scaled, is_dtensor, local_map,
                                         sum_over)

Params = dict
DEFAULT_ROPE_THETA = 10_000.0
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# activation-sharding hook (the reference's ``model.activation_sharding``)
#
# The sharded steps install a function here that re-pins (B, S, d)
# activations to batch-over-data at the layer boundaries, and (B, S, H, D)
# q, k and v to heads-over-model where the model axis divides the heads.
# Without one, ``constrain`` returns its input.
# ---------------------------------------------------------------------------

_ACT_CONSTRAINT: Optional[Callable] = None


@contextlib.contextmanager
def activation_sharding(fn: Callable):
    """Apply ``fn`` (tensor -> tensor) at every ``constrain`` site while the
    context is open."""
    global _ACT_CONSTRAINT
    prev = _ACT_CONSTRAINT
    _ACT_CONSTRAINT = fn
    try:
        yield
    finally:
        _ACT_CONSTRAINT = prev


def constrain(x: torch.Tensor) -> torch.Tensor:
    return x if _ACT_CONSTRAINT is None else _ACT_CONSTRAINT(x)


# ---------------------------------------------------------------------------
# local shards of a DTensor (the kernel boundaries on a mesh)
# ---------------------------------------------------------------------------

def _model_dim(mesh) -> int:
    return mesh.mesh_dim_names.index("model")


def _batch_plan(x) -> list:
    """Per mesh dim of DTensor ``x``: True where x's dim 0 (the batch) is
    split there, off the model axis."""
    m = _model_dim(x.device_mesh)
    return [i != m and p.is_shard(0) for i, p in enumerate(x.placements)]


def _split(plan: list, mesh, batch_dim: Optional[int],
           head_dim: Optional[int], heads_split: bool) -> tuple:
    """Placements that split ``batch_dim`` where ``plan`` holds the batch
    and ``head_dim`` on the model axis when ``heads_split``; the rest
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    m = _model_dim(mesh)
    out = []
    for i, batch in enumerate(plan):
        if i == m and heads_split and head_dim is not None:
            out.append(Shard(head_dim))
        elif batch and batch_dim is not None:
            out.append(Shard(batch_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def _model_coords(mesh) -> tuple[int, int]:
    """(this rank's index on the model axis, the axis's size)."""
    m = _model_dim(mesh)
    return mesh.get_local_rank(m), mesh.size(m)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"]).to(dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"] + p["bias"]).to(dtype)


def norm_init(kind: str, d: int, device=None) -> Params:
    return layernorm_init(d, device) if kind == "layernorm" \
        else rmsnorm_init(d, device)


def norm_apply(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return layernorm_apply(p, x) if kind == "layernorm" else rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# rotary embeddings (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = DEFAULT_ROPE_THETA,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32, (head_dim/2,), as the
    reference's float32 ``theta ** exponent`` gives it: NumPy's float32
    scalar power is the C library's ``powf``, which XLA's CPU ``pow`` calls
    too. torch's vectorised float32 ``pow`` parts from it by an ulp on some
    entries (one of 64 at head dim 128 and ``rope_theta`` 1e6). Made once
    per (head_dim, theta, device)."""
    return _rope_table(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(
        head_dim)
    freqs = np.array([np.float32(1.0) / np.float32(theta) ** e
                      for e in exponent], np.float32)
    with torch.inference_mode(False):    # usable later with autograd on
        return torch.from_numpy(freqs).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = DEFAULT_ROPE_THETA) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs        # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# dense projections
# ---------------------------------------------------------------------------

def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the weight cast to the activation dtype (a no-op when
    the weights were cast once at load, which gives the same values).

    On a mesh, a product whose contracted dim is split (a row-parallel
    weight, or FSDP storage) leaves each rank a partial product. Below
    float32 each rank's partial, rounded to x's dtype by the tensor-core
    product, is summed across ranks in float32 and rounded once (summed in
    the low type, each partial sum would round on its own)."""
    y = x @ p["w"].to(x.dtype)
    if is_dtensor(y) and y.dtype != torch.float32 and any(
            pl.is_partial() for pl in y.placements):
        from torch.distributed.tensor import Replicate
        y = y.float().redistribute(y.device_mesh, tuple(
            Replicate() if pl.is_partial() else pl for pl in y.placements)
        ).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, ring-buffer KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = DEFAULT_ROPE_THETA
    unroll: bool = False


def init_kv_cache(batch: int, spec: AttnSpec, cache_len: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Ring-buffer KV cache laid out (B, cache_len, Hkv, D), as in the
    reference. ``dtype=torch.int8`` gives the quantized cache: int8 values
    with per-(slot, head) bf16 scales ``k_scale`` / ``v_scale`` of shape
    (B, cache_len, Hkv, 1)."""
    shape = (batch, cache_len, spec.n_kv_heads, spec.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3] + (1,), dtype=torch.bfloat16,
                                      device=device)
    return cache


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 values, bf16 scale (..., 1)), the reference's
    rounding: the float32 scale ``max(amax, 1e-6) / 127`` quantizes (round
    half to even, clipped to +-127) and only then is stored as bf16."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv * group, S, D): query head ``h`` reads
    kv head ``h // group``, the grouping of the reference's
    ``_gqa_scores``."""
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def _slot_scale(scale: torch.Tensor) -> torch.Tensor:
    """(B, T, Hkv, 1) cache scales -> (B, Hkv, 1, 1, T), to multiply the
    (B, Hkv, group, S, T) scores or probabilities."""
    return scale[..., 0].transpose(1, 2)[:, :, None, None, :]


def _unflatten(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``t`` with dim ``dim`` split into ``sizes``. A DTensor split there
    on a mesh dim that does not divide ``sizes[0]`` is gathered on it
    first (a split that would cut a head; the reference's compiler
    reshards there on its own)."""
    dim %= t.ndim
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        if any(p.is_shard(dim) and sizes[0] % mesh.size(i)
               for i, p in enumerate(t.placements)):
            t = t.redistribute(mesh, tuple(
                Replicate() if p.is_shard(dim) else p for p in t.placements))
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def _attend_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int], group: int, h0: int = 0,
                  k0: int = 0) -> torch.Tensor:
    """The kernel on one device: (B, S, Hq, D) q over (B, S, Hk, D) k, v,
    (B, S, Hq, D) out. Query head i is global head ``h0 + i``; it reads
    global kv head ``(h0 + i) // group``, held here at that minus ``k0``."""
    qt = q.transpose(1, 2).contiguous()                  # (B, H, S, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if h0 == 0 and k0 == 0 and q.shape[2] == k.shape[2] * group:
        kt, vt = _repeat_kv(kt, group), _repeat_kv(vt, group)
    else:
        idx = (h0 + torch.arange(q.shape[2], device=q.device)) // group - k0
        kt, vt = kt.index_select(1, idx), vt.index_select(1, idx)
    out = flash_attention(qt, kt.contiguous(), vt.contiguous(),
                          window=window)
    return out.transpose(1, 2).contiguous()


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int], group: int) -> torch.Tensor:
    """Causal attention through the kernel, (B, S, H, D) in and out. On a
    mesh each rank runs it on its own batch rows and, where the model axis
    divides the heads, its own query heads with the kv heads they read
    (kv heads the axis does not divide are replicated, as their spec
    says)."""
    if not is_dtensor(q):
        return _attend_local(q, k, v, window, group)
    mesh = q.device_mesh
    plan = _batch_plan(q)
    coord, size = _model_coords(mesh)
    q_split, k_split = q.shape[2] % size == 0, k.shape[2] % size == 0
    pq = _split(plan, mesh, 0, 2, q_split)
    pk = _split(plan, mesh, 0, 2, k_split)
    attend = functools.partial(
        _attend_local, window=window, group=group,
        h0=coord * (q.shape[2] // size) if q_split else 0,
        k0=coord * (k.shape[2] // size) if k_split else 0)
    return local_map(attend, mesh, (pq, pk, pk), pq)(q, k, v)


def _ring_write(buf: torch.Tensor, val: torch.Tensor,
                pos: torch.Tensor) -> None:
    """``buf[b, pos[b] % clen] = val[b, 0]`` for every row b, in place:
    ``buf`` (B, clen, ...), ``val`` (B, 1, ...). On a mesh each rank
    writes into its own shard the rows and ring slots it holds."""
    clen = buf.shape[1]
    if not is_dtensor(buf):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, pos % clen] = val[:, 0].to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate
    mesh, place = buf.device_mesh, buf.placements

    def write(local, vl, pl):              # local: buf's own shard
        lo = sum(mesh.get_local_rank(i) * local.shape[1]
                 for i, p in enumerate(place) if p.is_shard(1))
        slot = pl % clen - lo
        mine = (slot >= 0) & (slot < local.shape[1])
        rows = torch.arange(local.shape[0], device=local.device)[mine]
        local[rows, slot[mine]] = vl[:, 0][mine].to(local.dtype)

    local_map(write, mesh, (
        place, tuple(Replicate() if p.is_shard(1) else p for p in place),
        tuple(p if p.is_shard(0) else Replicate() for p in place)),
        None)(buf, val, pos)


def attention_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                    spec: AttnSpec, cache: Optional[Params] = None,
                    cache_positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False) -> tuple[torch.Tensor, Any]:
    """Causal (optionally sliding-window) self-attention.

    Prefill (``cache`` None): ``positions`` must be ``0..S-1`` on every row
    (the kernel masks by index); attention runs through the
    ``flash_attention`` kernel in its (B, H, S, D) layout. Returns
    ``(y, (k, v))`` in (B, S, Hkv, D) when ``return_kv``.

    Decode (``cache`` given): x is (B, 1, d), ``positions`` (B, 1) the new
    token's absolute position, ``cache_positions`` (B, cache_len) the
    position held by each ring slot (-1 = empty). Writes the new K/V and
    position into the cache in place and returns ``(y, (cache,
    cache_positions))``."""
    b, s, _ = x.shape
    hd = spec.head_dim
    q = constrain(_unflatten(dense_apply(p["wq"], x), -1, (spec.n_heads, hd)))
    k = constrain(_unflatten(dense_apply(p["wk"], x), -1,
                             (spec.n_kv_heads, hd)))
    v = constrain(_unflatten(dense_apply(p["wv"], x), -1,
                             (spec.n_kv_heads, hd)))
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    group = spec.n_heads // spec.n_kv_heads

    if cache is None:
        out = _attend(q, k, v, spec.sliding_window, group)
        y = dense_apply(p["wo"], out.reshape(b, s, spec.n_heads * hd))
        return y, ((k, v) if return_kv else None)

    # --- decode: one new token against the ring buffer -------------------
    quantized = cache["k"].dtype == torch.int8
    pos = positions[:, 0].long()                          # (B,)
    if quantized:
        for name, t in (("k", k), ("v", v)):
            qt, st = quantize_kv(t)
            _ring_write(cache[name], qt, pos)
            _ring_write(cache[f"{name}_scale"], st, pos)
    else:
        _ring_write(cache["k"], k, pos)
        _ring_write(cache["v"], v, pos)
    _ring_write(cache_positions, pos[:, None], pos)

    out = _attend_cached(q, cache, cache_positions, pos, spec.sliding_window,
                         scale, x.dtype)
    y = dense_apply(p["wo"], out.reshape(b, s, spec.n_heads * hd))
    return y, (cache, cache_positions)


def _decode_local(q: torch.Tensor, cache: Params, cpos: torch.Tensor,
                  pos: torch.Tensor, window: Optional[int], scale: float,
                  dtype, group=None) -> torch.Tensor:
    """(B, 1, H, D) queries against one device's ring buffer (B, T, Hkv,
    D): (B, 1, H, D) in ``dtype``. With ``group`` (a process group over
    which the ring's slots are split) the softmax and the probabilities'
    product are completed over the group."""
    b, s, h, hd = q.shape
    hkv, t = cache["k"].shape[2], cache["k"].shape[1]
    quantized = cache["k"].dtype == torch.int8
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          cache["k"].to(q.dtype)).float() * scale
    if quantized:   # fold the per-(slot, head) scale into the float32 scores
        scores = scores * _slot_scale(cache["k_scale"])
    scores = scores.reshape(b, h, s, t)
    cpos = cpos.long()
    visible = (cpos >= 0) & (cpos <= pos[:, None])
    if window is not None:
        visible = visible & (cpos > pos[:, None] - window)
    scores = scores.masked_fill(~visible[:, None, None, :], NEG_INF)
    if group is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        import torch.distributed as dist
        top = scores.amax(dim=-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        probs = torch.exp(scores - top)
        total = probs.sum(dim=-1, keepdim=True)
        dist.all_reduce(total, group=group)
        probs = probs / total
    pg = probs.to(dtype).reshape(b, hkv, h // hkv, s, t)
    if quantized:   # and the v scale into the probabilities, in x's dtype
        pg = pg * _slot_scale(cache["v_scale"]).to(pg.dtype)
    if group is None:
        out = torch.einsum("bkgst,btkd->bskgd", pg, cache["v"].to(dtype))
        return out.reshape(b, s, h, hd)
    # the slots' partial products summed in float32, rounded once
    out = torch.einsum("bkgst,btkd->bskgd", pg.float(),
                       cache["v"].to(dtype).float()).reshape(b, s, h, hd)
    dist.all_reduce(out, group=group)
    return out.to(dtype)


def _attend_cached(q: torch.Tensor, cache: Params, cpos: torch.Tensor,
                   pos: torch.Tensor, window: Optional[int], scale: float,
                   dtype) -> torch.Tensor:
    """Decode attention of (B, 1, H, D) q over the ring buffer. On a mesh
    each rank takes its batch rows of the cache as its spec splits it: by
    kv heads (with their query heads), or by ring slots (every query head,
    the softmax completed over the model axis), or whole."""
    if not is_dtensor(q):
        return _decode_local(q, cache, cpos, pos, window, scale, dtype)
    mesh = q.device_mesh
    m = _model_dim(mesh)
    plan = _batch_plan(cache["k"])
    heads = cache["k"].placements[m].is_shard(2)
    slots = cache["k"].placements[m].is_shard(1)
    pq = _split(plan, mesh, 0, 2, heads)
    names = list(cache)

    def attend(ql, cpl, pl, *held):
        return _decode_local(ql, dict(zip(names, held)), cpl, pl, window,
                             scale, dtype,
                             mesh.get_group(m) if slots else None)
    return local_map(attend, mesh, (
        pq, _split(plan, mesh, 0, 1, slots), _split(plan, mesh, 0, None, False),
        *(cache[n].placements for n in names)), pq)(
        q, cpos, pos, *(cache[n] for n in names))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(p: Params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    h = dense_apply(p["w1"], x)
    if activation == "swiglu":
        h = F.silu(h) * dense_apply(p["w3"], x)
    else:
        h = F.gelu(h, approximate="tanh")
    return dense_apply(p["w2"], h)


# ---------------------------------------------------------------------------
# mixture of experts (top-k, capacity-factor dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 1024        # tokens per dispatch group (memory control)
    dense_residual: bool = False  # Arctic-style always-on dense branch
    dense_residual_ff: int = 0


def moe_groups(s: int, group_size: int) -> int:
    """Dispatch groups per batch row of ``s`` tokens: ``s // group_size``
    (at least 1), lowered to the largest divisor of ``s`` not above it.
    Groups never span rows, so one sequence's drops never depend on
    another's tokens."""
    g_row = max(1, s // group_size) if s >= group_size else 1
    while s % g_row:
        g_row -= 1
    return g_row


def moe_capacity(t: int, spec: MoeSpec) -> int:
    """Slots per expert and group of ``t`` tokens, in Python floats as the
    reference computes it."""
    return max(int(math.ceil(t * spec.top_k / spec.n_experts
                             * spec.capacity_factor)), spec.top_k)


@dataclasses.dataclass
class MoeRouting:
    """The routing of G groups of T tokens: float32 router ``probs`` (G, T,
    E); each (token, k) choice's ``expert`` (G, T, K), its ``gate``
    (normalised top-k probability, zeroed where dropped) and its ``pos``
    in the expert's queue; ``keep`` = ``pos < capacity``; the load-balance
    ``aux`` loss (float32 scalar)."""
    probs: torch.Tensor
    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor


def moe_route(router: torch.Tensor, xg: torch.Tensor,
              spec: MoeSpec) -> MoeRouting:
    """Route grouped tokens ``xg`` (G, T, d), the reference's steps: logits
    of ``xg`` in float32 by the float32 router, softmax; the Switch aux
    loss ``E * mean_g sum_e mean_t(probs) mean_t(one_hot(argmax))`` (first
    maximum); the top-k by a stable descending sort, so ties go to the
    lower expert index as ``lax.top_k`` breaks them (``torch.topk`` promises
    no order on ties); gates over their clipped sum; a choice's queue
    position is the count of earlier choices to its expert in flattened (t,
    k) order, dropped ones included, and it is kept iff below capacity."""
    g, t, _ = xg.shape
    e, k = spec.n_experts, spec.top_k
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    usage = F.one_hot(probs.argmax(dim=-1), e).float().mean(dim=1)
    aux = (probs.mean(dim=1) * usage).sum(dim=-1).mean() * e
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    sel = F.one_hot(expert.reshape(g, t * k), e)              # (G, T*K, E)
    pos = ((sel.cumsum(dim=1) - sel) * sel).sum(dim=-1).reshape(g, t, k)
    capacity = moe_capacity(t, spec)
    keep = pos < capacity
    return MoeRouting(probs, expert, gate * keep, pos, keep, capacity, aux)


def moe_apply(p: Params, x: torch.Tensor,
              spec: MoeSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k mixture of experts with capacity-factor dispatch. x: (B, S, d).
    Returns (y (B, S, d) in x's dtype, the float32 aux loss).

    Dispatch and combine are index gathers with the values of the
    reference's one-hot (G, T, E, C) einsums: a choice is dispatched iff
    its gate after the keep mask is > 0, to slot ``pos`` of its expert in
    its group; each expert runs ``silu(xe w1) * (xe w3) w2`` on its (G, C)
    slots (empty ones zero) in one batched product over (E, G * C, d) with
    the weights in x's dtype; a token's output is the sum of its choices'
    ``gate.to(x.dtype) * ye`` in float32, rounded once. No atomics: the
    slot table is written at distinct indices only, so ``"cuda"`` is
    deterministic. Arctic's dense residual adds the SwiGLU MLP of the same
    normed input after the combine. A DTensor ``x`` takes ``_moe_sharded``."""
    if is_dtensor(x):
        return _moe_sharded(p, x, spec)
    b, s, d = x.shape
    y, aux = _moe_local(p["router"], x, p["w1"], p["w3"], p["w2"], spec)
    y = y.to(x.dtype)
    if spec.dense_residual:
        y = y + mlp_apply(p["dense"], x)
    return y, aux


def _moe_local(router: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, spec: MoeSpec,
               e0: int = 0, reduce_ye: Optional[Callable] = None,
               route_grad: float = 1.0, aux_grad: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on one device's tokens x (B, S, d): the float32
    combine (B, S, d) and the aux loss of these tokens. ``w1`` ... hold
    experts ``e0 ..`` (all experts, or one rank's); a choice to an expert
    not held adds nothing here. ``reduce_ye`` sums the experts' float32
    outputs over ranks that each hold a slice of every expert's FFN dim.
    ``route_grad`` and ``aux_grad`` scale the gradients that reach the
    router and x through the routing, and through the aux loss alone
    (0 where another rank of the model axis counts them)."""
    b, s, d = x.shape
    g_row = moe_groups(s, spec.group_size)
    g, t = b * g_row, s // g_row
    e, k = spec.n_experts, spec.top_k
    xg = x.reshape(g, t, d)
    if route_grad != 1.0:
        r = moe_route(grad_scaled(router, route_grad),
                      grad_scaled(xg, route_grad), spec)
    else:
        r = moe_route(router, xg, spec)
    cap = r.capacity
    dev = x.device

    # (token, k) -> slot in the (E, G, C) expert batch
    sent = r.gate > 0
    group = torch.arange(g, device=dev)[:, None, None]
    slot = (r.expert * g + group) * cap + r.pos.clamp(max=cap - 1)
    # slot -> token (g * t: a zero row); a choice not sent writes an index
    # of its own past the slots, so every index is written once
    n_slots = e * g * cap
    spare = n_slots + torch.arange(g * t * k, device=dev).reshape(g, t, k)
    token = torch.arange(g * t, device=dev).reshape(g, t, 1).expand(g, t, k)
    src = torch.full((n_slots + g * t * k,), g * t, dtype=torch.long,
                     device=dev)
    src[torch.where(sent, slot, spare).reshape(-1)] = token.reshape(-1)
    xpad = torch.cat([xg.reshape(g * t, d), xg.new_zeros((1, d))])
    el = w1.shape[0]                                   # experts held here
    lo = e0 * g * cap
    xe = xpad[src[lo:lo + el * g * cap]].reshape(el, g * cap, d)

    h = F.silu(torch.bmm(xe, w1.to(x.dtype))) * torch.bmm(xe, w3.to(x.dtype))
    ye = torch.bmm(h, w2.to(x.dtype))
    if reduce_ye is not None:
        ye = reduce_ye(ye.float()).to(x.dtype)
    ye = ye.reshape(el * g * cap, d)

    held = sent & (r.expert >= e0) & (r.expert < e0 + el)
    picked = ye[torch.where(held, slot - lo, 0)]             # (G, T, K, d)
    weight = (r.gate * held).to(x.dtype).float()[..., None]
    y = (weight * picked.float()).sum(dim=2)
    aux = r.aux if aux_grad == 1.0 else grad_scaled(r.aux, aux_grad)
    return y.reshape(b, s, d), aux


def _moe_sharded(p: Params, x: torch.Tensor,
                 spec: MoeSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on a mesh. Each rank routes its own batch rows (groups
    never span rows) and runs, by the expert rule of ``models.sharding``,
    its own experts when the model axis divides them (expert parallelism:
    a token's choices to other ranks' experts add nothing here, and the
    float32 combine is summed over the model axis) or else every expert
    on its slice of the FFN dim (the experts' float32 outputs summed over
    the axis before the combine). The weights are gathered over the data
    axes first (their FSDP storage). The aux loss is averaged over the
    batch shards. Arctic's dense residual runs as a DTensor MLP (tensor
    parallel).

    Under autograd the router's and x's gradients are partial over every
    mesh dim: the ranks of a batch axis route other rows, and those of the
    model axis run other experts (or other slices of the FFN dim, whose
    sum passes its gradient to each slice unchanged). What every rank of
    the model axis repeats adds to them on its first rank only: the aux
    loss, and with the FFN dim split the routing and combine too."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    m = _model_dim(mesh)
    plan = _batch_plan(x)
    coord, size = _model_coords(mesh)
    ep = spec.n_experts % size == 0
    once = 1.0 if coord == 0 else 0.0
    shards = math.prod(mesh.size(i) for i, b in enumerate(plan) if b)

    def weight(ffn_dim: int) -> tuple:
        return tuple((Shard(0) if ep else Shard(ffn_dim)) if i == m
                     else Replicate() for i in range(mesh.ndim))

    def experts(router, xl, w1, w3, w2):
        y, aux = _moe_local(
            router, xl, w1, w3, w2, spec,
            e0=coord * w1.shape[0] if ep else 0,
            reduce_ye=None if ep else functools.partial(
                sum_over, group=mesh.get_group(m)),
            route_grad=1.0 if ep else once, aux_grad=once if ep else 1.0)
        # each batch shard's mean over its groups, summed: the mean
        return y, aux / shards
    whole = (Replicate(),) * mesh.ndim
    rows = _split(plan, mesh, 0, None, False)
    every = tuple(Partial() if i == m or b else Replicate()
                  for i, b in enumerate(plan))
    y, aux = local_map(experts, mesh, (
        whole, rows, weight(2), weight(2), weight(1)), (
        tuple(Partial() if i == m and ep else pl for i, pl in enumerate(rows)),
        tuple(Partial() if b else Replicate() for b in plan)),
        grads=(every, tuple(Partial() if i == m else pl
                            for i, pl in enumerate(rows)),
               *(tuple(Partial() if pl.is_replicate() and b else pl
                       for pl, b in zip(weight(f), plan)) for f in (2, 2, 1))
               ))(p["router"], x, p["w1"], p["w3"], p["w2"])
    y = y.redistribute(mesh, rows).to(x.dtype)
    aux = aux.redistribute(mesh, whole)
    if spec.dense_residual:
        y = y + mlp_apply(p["dense"], x)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba2 / SSD mixer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_ssm_cache(batch: int, spec: SSMSpec, dtype=torch.float32,
                   device=None) -> Params:
    conv_dim = spec.d_inner + 2 * spec.n_groups * spec.d_state
    return {
        "conv": torch.zeros((batch, spec.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state),
                           dtype=dtype, device=device),
    }


def _causal_conv(xin: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """Depthwise causal conv1d: ``out[:, t] = sum_k xin[:, t + k] * w[k]``
    over the (d_conv - 1)-padded input, summed in float32 and rounded once
    (the reference's ``einsum('bskc,kc->bsc')`` over the windows)."""
    acc = xin[:, 0:s].float() * w[0].float()
    for k in range(1, w.shape[0]):
        acc = acc + xin[:, k:k + s].float() * w[k].float()
    return acc.to(xin.dtype)


def _ssd_prefill_local(xi: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                       rep: int, h0: int = 0) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The SSD scan of a prompt on one device: xi (b, s, h, p), dt (b, s,
    h), A (h,), the groups' B and C (b, s, G, n); head i (global head ``h0
    + i``) reads group ``(h0 + i) // rep``. Returns y (b, s, h, p) float32
    and the final state (b, h, p, n). The sequence is padded to a chunk
    multiple (dt = 0 there leaves the state as it was) and each group's
    heads go through ``ops.ssd_scan`` (K4 and the inter-chunk recurrence)
    together."""
    b, s, h, p = xi.shape
    pad_s = (-s) % chunk
    xi_p, dt_p, B_p, C_p = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_s))
                            for t in (xi, dt, Bm, Cm))
    nc = (s + pad_s) // chunk
    n = Bm.shape[-1]
    xs = xi_p.float().reshape(b, nc, chunk, h, p)
    dts = dt_p.reshape(b, nc, chunk, h)
    parts = []
    for j in range(h0 // rep, (h0 + h - 1) // rep + 1):
        lo, hi = max(j * rep, h0) - h0, min((j + 1) * rep, h0 + h) - h0
        parts.append(ops.ssd_scan(
            xs[..., lo:hi, :], dts[..., lo:hi], A[lo:hi],
            B_p[:, :, j].float().reshape(b, nc, chunk, n),
            C_p[:, :, j].float().reshape(b, nc, chunk, n)))
    y, final_state = (parts[0] if len(parts) == 1 else
                      (torch.cat([q[0] for q in parts], dim=3),
                       torch.cat([q[1] for q in parts], dim=1)))
    return y.reshape(b, nc * chunk, h, p)[:, :s], final_state


def _ssd_prefill(xi: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_ssd_prefill_local``. On a mesh each rank scans its own batch rows
    and, where the model axis divides the heads, its own heads (B and C
    whole): y comes back split on h, the state (b, h, p, n) on h."""
    rep = xi.shape[2] // Bm.shape[2]
    if not is_dtensor(xi):
        return _ssd_prefill_local(xi, dt, A, Bm, Cm, chunk, rep)
    mesh = xi.device_mesh
    plan = _batch_plan(xi)
    coord, size = _model_coords(mesh)
    split = xi.shape[2] % size == 0
    heads = _split(plan, mesh, 0, 2, split)
    rows = _split(plan, mesh, 0, None, False)
    h0 = coord * (xi.shape[2] // size) if split else 0

    def scan(xl, dtl, Al, Bl, Cl):
        y, state = _ssd_prefill_local(xl, dtl, Al, Bl, Cl, chunk, rep, h0)
        return y.contiguous(), state
    return local_map(scan, mesh, (
        heads, heads, _split(plan, mesh, None, 0, split), rows, rows), (
        heads, _split(plan, mesh, 0, 1, split)))(xi, dt, A, Bm, Cm)


def _ssm_step(state: torch.Tensor, xv: torch.Tensor, dt1: torch.Tensor,
              A: torch.Tensor, Bg: torch.Tensor, Cg: torch.Tensor,
              rep: int, h0: int = 0) -> torch.Tensor:
    """One recurrent step on one device, the state (B, H, P, N) updated in
    place: ``h' = h exp(dt A) + dt x B``, returns ``y = C h'`` (B, H, P).
    Head i (global head ``h0 + i``) reads group ``(h0 + i) // rep`` of B
    and C (B, G, N)."""
    idx = (h0 + torch.arange(xv.shape[1], device=xv.device)) // rep
    B1 = Bg.index_select(1, idx)[:, :, None, :]          # (B, H, 1, N)
    C1 = Cg.index_select(1, idx)                         # (B, H, N)
    decay = torch.exp(dt1 * A[None, :])[..., None, None]
    upd = dt1[..., None, None] * xv[..., None] * B1
    h_new = state.float() * decay + upd                  # (B, H, P, N)
    state.copy_(h_new)
    return torch.einsum("bhpn,bhn->bhp", h_new, C1)


def _ssm_decode(state: torch.Tensor, xv: torch.Tensor, dt1: torch.Tensor,
                A: torch.Tensor, Bg: torch.Tensor,
                Cg: torch.Tensor) -> torch.Tensor:
    """``_ssm_step`` of x (B, H, P), dt (B, H), A (H,) and the groups' B, C
    (B, G, N). On a mesh each rank steps its own batch rows and, where the
    cache's spec splits them, its own heads."""
    rep = xv.shape[1] // Bg.shape[1]
    if not is_dtensor(xv):
        return _ssm_step(state, xv, dt1, A, Bg, Cg, rep)
    mesh = xv.device_mesh
    plan = _batch_plan(state)
    coord, size = _model_coords(mesh)
    heads = state.placements[_model_dim(mesh)].is_shard(1)
    split = _split(plan, mesh, 0, 1, heads)
    rows = _split(plan, mesh, 0, None, False)
    step = functools.partial(_ssm_step, rep=rep,
                             h0=coord * (xv.shape[1] // size) if heads else 0)
    return local_map(step, mesh, (
        state.placements, split, split, _split(plan, mesh, None, 0, heads),
        rows, rows), split)(state, xv, dt1, A, Bg, Cg)


def ssm_apply(p: Params, x: torch.Tensor, spec: SSMSpec,
              cache: Optional[Params] = None,
              return_state: bool = False) -> tuple[torch.Tensor, Optional[Params]]:
    """Mamba2 block: prefill when ``cache`` is None, else one-token decode.

    ``cache = {"conv": (B, d_conv-1, conv_dim), "ssm": (B, H, P, N)}``;
    decode writes the new state into it in place and returns it. With
    ``n_groups`` G > 1, head ``h`` reads group ``h // (H / G)``'s B and C
    (the reference's ``repeat``): prefill runs one SSD scan per group of
    heads."""
    b, s, _ = x.shape
    din = spec.d_inner
    gn = spec.n_groups * spec.d_state
    proj = dense_apply({"w": p["in_proj"]}, x)
    z = proj[..., :din]
    xbc = proj[..., din:2 * din + 2 * gn]
    dt = proj[..., 2 * din + 2 * gn:]

    conv_w = p["conv_w"].to(x.dtype)                     # (d_conv, conv_dim)
    if cache is None:
        pad = xbc.new_zeros((b, spec.d_conv - 1, xbc.shape[-1]))
        xin = torch.cat([pad, xbc], dim=1)
        new_conv = xin[:, -(spec.d_conv - 1):] if return_state else None
    else:
        xin = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
        new_conv = xin[:, 1:]
    xbc = F.silu(_causal_conv(xin, conv_w, s) + p["conv_b"].to(x.dtype))

    xi = xbc[..., :din].reshape(b, s, spec.n_heads, spec.head_dim)
    ng = spec.n_groups
    Bm = xbc[..., din:din + gn].reshape(b, s, ng, spec.d_state)
    Cm = xbc[..., din + gn:].reshape(b, s, ng, spec.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])           # (B, S, H)
    A = -torch.exp(p["A_log"])                           # (H,)

    if cache is None:
        y, final_state = _ssd_prefill(xi, dt, A, Bm, Cm, spec.chunk)
        new_cache = ({"conv": new_conv, "ssm": final_state}
                     if return_state else None)
    else:
        # one step: h' = h * exp(dt A) + dt * x B ; y = C h'
        y = _ssm_decode(cache["ssm"], xi[:, 0].float(), dt[:, 0], A,
                        Bm[:, 0].float(), Cm[:, 0].float())[:, None]
        cache["conv"].copy_(new_conv)
        new_cache = cache

    y = y + xi.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    return dense_apply({"w": p["out_proj"]}, y), new_cache


# ---------------------------------------------------------------------------
# embeddings / output head (tied table)
# ---------------------------------------------------------------------------

def embedding_apply(p: Params, tokens: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    if is_dtensor(p["table"]):
        return _embedding_sharded(p["table"], tokens, dtype)
    return F.embedding(tokens.long(), p["table"].to(dtype))


def _embedding_sharded(table: torch.Tensor, tokens: torch.Tensor,
                       dtype) -> torch.Tensor:
    """The lookup on a mesh, vocabulary-parallel: each rank gathers its
    rows of the table (split on the model axis where it divides them, the
    d dim whole) and looks up the tokens of its batch rows that fall in
    them, zero elsewhere. The result is a partial sum over the model axis
    with one non-zero term per entry, so its sum is the lookup exactly."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    m = _model_dim(mesh)
    coord, size = _model_coords(mesh)
    split = table.shape[0] % size == 0
    batch = _split(_batch_plan(tokens), mesh, 0, None, False)
    first = coord * (table.shape[0] // size) if split else 0

    def lookup(rows, ids):
        ids = ids.long() - first
        inside = (ids >= 0) & (ids < rows.shape[0])
        out = F.embedding(ids.clamp(0, rows.shape[0] - 1), rows.to(dtype))
        return torch.where(inside[..., None], out, out.new_zeros(()))
    return local_map(lookup, mesh, (
        tuple(Shard(0) if i == m and split else Replicate()
              for i in range(mesh.ndim)), batch),
        tuple(Partial() if i == m and split else pl
              for i, pl in enumerate(batch)))(table, tokens)


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].to(x.dtype).T
