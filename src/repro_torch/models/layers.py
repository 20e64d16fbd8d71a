"""Neural-net building blocks of the port, in PyTorch.

Counterpart of ``repro.models.layers`` for the blocks the dense, ssm,
hybrid, vlm and audio stacks run: RMS/LayerNorm, rotary embeddings with
split halves, dense projections, GQA causal self-attention with a
ring-buffer KV cache (bf16, float32, or int8 with per-(slot, head) bf16
scales), the SwiGLU and tanh-GELU MLPs, the Mamba2 SSD mixer and the tied
embedding / output head. The MoE layer waits (ROADMAP queue 1 item 7).
Params are plain nested dicts of tensors with the reference's names and
layouts, so a JAX parameter tree converts leaf by leaf
(``repro_torch.convert``).

Where the reference reaches a Pallas kernel's function, the port calls its
hand-written kernel: prefill attention goes through ``flash_attention``
(K3) and the prefill SSD scan through ``ops.ssd_scan`` (K4 plus the
inter-chunk recurrence). Each kernel wrapper launches CUDA for CUDA tensors
and runs its plain version for CPU tensors, so a layer runs wherever its
inputs lie. Decode paths are plain torch ops, as in the reference.

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
    decode writes the new state into it in place and returns it."""
    if spec.n_groups != 1:
        raise NotImplementedError("the SSD kernel takes one SSM group; "
                                  "grouped B/C waits (ROADMAP queue 1 item 7)")
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
    Bm = xbc[..., din:din + gn]                          # (B, S, N): one group
    Cm = xbc[..., din + gn:]
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
        y, final_state = ops.ssd_scan(
            xi_p.float().reshape(b, nc, l, spec.n_heads, spec.head_dim),
            dt_p.reshape(b, nc, l, spec.n_heads), A,
            B_p.float().reshape(b, nc, l, gn),
            C_p.float().reshape(b, nc, l, gn))
        y = y.reshape(b, nc * l, spec.n_heads, spec.head_dim)[:, :s]
        new_cache = ({"conv": new_conv, "ssm": final_state}
                     if return_state else None)
    else:
        # one step: h' = h * exp(dt A) + dt * x B ; y = C h'
        B1 = Bm[:, 0].float()[:, None, None, :]          # (B, 1, 1, N)
        C1 = Cm[:, 0].float()                            # (B, N)
        dt1 = dt[:, 0]                                   # (B, H)
        xv = xi[:, 0].float()                            # (B, H, P)
        decay = torch.exp(dt1 * A[None, :])[..., None, None]
        upd = dt1[..., None, None] * xv[..., None] * B1
        h_new = cache["ssm"].float() * decay + upd       # (B, H, P, N)
        y = torch.einsum("bhpn,bn->bhp", h_new, C1)[:, None]
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
