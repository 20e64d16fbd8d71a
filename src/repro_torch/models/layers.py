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
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention

Params = dict
DEFAULT_ROPE_THETA = 10_000.0
NEG_INF = -1e30


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
    the weights were cast once at load, which gives the same values)."""
    y = x @ p["w"].to(x.dtype)
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
    q = dense_apply(p["wq"], x).reshape(b, s, spec.n_heads, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, spec.n_kv_heads, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, spec.n_kv_heads, hd)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    group = spec.n_heads // spec.n_kv_heads

    if cache is None:
        qt = q.transpose(1, 2).contiguous()              # (B, H, S, D)
        kt = _repeat_kv(k.transpose(1, 2), group).contiguous()
        vt = _repeat_kv(v.transpose(1, 2), group).contiguous()
        out = flash_attention(qt, kt, vt, window=spec.sliding_window)
        out = out.transpose(1, 2).reshape(b, s, spec.n_heads * hd)
        y = dense_apply(p["wo"], out)
        return y, ((k, v) if return_kv else None)

    # --- decode: one new token against the ring buffer -------------------
    cache_len = cache["k"].shape[1]
    quantized = cache["k"].dtype == torch.int8
    b_idx = torch.arange(b, device=x.device)
    pos = positions[:, 0].long()                          # (B,)
    slot = pos % cache_len
    if quantized:
        for name, t in (("k", k), ("v", v)):
            cache[name][b_idx, slot], cache[f"{name}_scale"][b_idx, slot] = \
                quantize_kv(t[:, 0])
    else:
        cache["k"][b_idx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][b_idx, slot] = v[:, 0].to(cache["v"].dtype)
    cache_positions[b_idx, slot] = pos.to(cache_positions.dtype)

    hkv = spec.n_kv_heads
    qg = q.reshape(b, s, hkv, group, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          cache["k"].to(q.dtype)).float() * scale
    if quantized:   # fold the per-(slot, head) scale into the float32 scores
        scores = scores * _slot_scale(cache["k_scale"])
    scores = scores.reshape(b, spec.n_heads, s, cache_len)
    cpos = cache_positions.long()
    visible = (cpos >= 0) & (cpos <= pos[:, None])
    if spec.sliding_window is not None:
        visible = visible & (cpos > pos[:, None] - spec.sliding_window)
    scores = scores.masked_fill(~visible[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    pg = probs.reshape(b, hkv, group, s, cache_len)
    if quantized:   # and the v scale into the probabilities, in x's dtype
        pg = pg * _slot_scale(cache["v_scale"]).to(pg.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", pg, cache["v"].to(x.dtype))
    y = dense_apply(p["wo"], out.reshape(b, s, spec.n_heads * hd))
    return y, (cache, cache_positions)


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
    normed input after the combine."""
    b, s, d = x.shape
    g_row = moe_groups(s, spec.group_size)
    g, t = b * g_row, s // g_row
    e, k = spec.n_experts, spec.top_k
    xg = x.reshape(g, t, d)
    r = moe_route(p["router"], xg, spec)
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
    xe = xpad[src[:n_slots]].reshape(e, g * cap, d)

    h = F.silu(torch.bmm(xe, p["w1"].to(x.dtype))) \
        * torch.bmm(xe, p["w3"].to(x.dtype))
    ye = torch.bmm(h, p["w2"].to(x.dtype)).reshape(n_slots, d)

    picked = ye[torch.where(sent, slot, 0)]                  # (G, T, K, d)
    weight = r.gate.to(x.dtype).float()[..., None]
    y = (weight * picked.float()).sum(dim=2).to(x.dtype)
    if spec.dense_residual:
        y = y + mlp_apply(p["dense"], xg)
    return y.reshape(b, s, d), r.aux


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
        # pad the sequence to a chunk multiple; dt = 0 there leaves the
        # state as it was
        pad_s = (-s) % spec.chunk
        xi_p, dt_p, B_p, C_p = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_s))
                                for t in (xi, dt, Bm, Cm))
        nc = (s + pad_s) // spec.chunk
        l = spec.chunk
        xs = xi_p.float().reshape(b, nc, l, spec.n_heads, spec.head_dim)
        dts = dt_p.reshape(b, nc, l, spec.n_heads)
        rep = spec.n_heads // ng
        parts = [ops.ssd_scan(
            xs[..., j * rep:(j + 1) * rep, :], dts[..., j * rep:(j + 1) * rep],
            A[j * rep:(j + 1) * rep],
            B_p[:, :, j].float().reshape(b, nc, l, spec.d_state),
            C_p[:, :, j].float().reshape(b, nc, l, spec.d_state))
            for j in range(ng)]
        y, final_state = (parts[0] if ng == 1 else
                          (torch.cat([q[0] for q in parts], dim=3),
                           torch.cat([q[1] for q in parts], dim=1)))
        y = y.reshape(b, nc * l, spec.n_heads, spec.head_dim)[:, :s]
        new_cache = ({"conv": new_conv, "ssm": final_state}
                     if return_state else None)
    else:
        # one step: h' = h * exp(dt A) + dt * x B ; y = C h'
        rep = spec.n_heads // ng                         # head h: group h // rep
        B1 = Bm[:, 0].float().repeat_interleave(rep, dim=1)[:, :, None, :]
        C1 = Cm[:, 0].float().repeat_interleave(rep, dim=1)  # (B, H, N)
        dt1 = dt[:, 0]                                   # (B, H)
        xv = xi[:, 0].float()                            # (B, H, P)
        decay = torch.exp(dt1 * A[None, :])[..., None, None]
        upd = dt1[..., None, None] * xv[..., None] * B1
        h_new = cache["ssm"].float() * decay + upd       # (B, H, P, N)
        y = torch.einsum("bhpn,bhn->bhp", h_new, C1)[:, None]
        cache["ssm"].copy_(h_new)
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
    return F.embedding(tokens.long(), p["table"].to(dtype))


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].to(x.dtype).T
