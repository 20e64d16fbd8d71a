"""Decoder-LM skeleton of the port: the configuration record and the hybrid
(Zamba2) stack.

Counterpart of ``repro.models.model``. ``ModelConfig`` keeps every field of
the reference (dtype fields hold torch dtypes), so later families drop in;
this slice runs the ``hybrid`` architecture only — a Mamba2 stack with one
shared attention block applied before every layer ``i % attn_every == 0``,
each application with its own KV cache. Other ``arch_type`` values raise
``NotImplementedError``.

The layer stack is a Python loop over ``params["layers"]`` (a list of
per-layer dicts; the reference stacks them on a leading axis for
``lax.scan``). Caches keep the reference's stacked layout:
``{"ssm": {"conv": (L, B, d_conv-1, C), "ssm": (L, B, H, P, N)},
"kv": {"k", "v": (sites, B, clen, Hkv, D)}, "kv_pos": (sites, B, clen)}``.

Entry points:
  init_params(cfg, generator, device)           -> params
  forward(params, batch, cfg)                   -> (logits, aux)
  train_loss(params, batch, cfg)                -> (loss, metrics)
  prefill(params, batch, cfg, max_seq_len)      -> (last logits, cache)
  init_cache(cfg, batch, seq_len)               -> decode cache
  decode_step(params, cache, batch, pos, cfg)   -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L

_NOT_PORTED = ("is not ported yet: this slice runs the hybrid (Zamba2) "
               "stack; the dense, ssm, moe, vlm and audio families are "
               "ROADMAP queue 1 item 7")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int                        # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    qkv_bias: bool = False
    sliding_window: Optional[int] = None      # training-time SWA (Mixtral)
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_dense_residual: bool = False
    moe_aux_weight: float = 0.01
    # SSM
    ssm_state: int = 0
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # hybrid (Zamba2): shared attention block every `attn_every` SSM layers
    attn_every: int = 6
    # VLM stub frontend
    n_patches: int = 256
    d_vision: int = 1024
    # audio stub frontend (EnCodec codebooks)
    n_codebooks: int = 4
    # serving
    kv_cache_quant: bool = False        # int8 KV cache with bf16 scales
    long_context_mode: str = "native"   # native | swa (ring-buffer window)
    serve_window: int = 8192
    swa_activation_len: int = 65536     # swa mode kicks in beyond this context
    # numerics / memory
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    unroll: bool = False
    vocab_pad_multiple: int = 2048
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def attn_spec(self) -> L.AttnSpec:
        return L.AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, sliding_window=self.sliding_window,
            rope_theta=self.rope_theta, unroll=self.unroll)

    @property
    def ssm_spec(self) -> L.SSMSpec:
        return L.SSMSpec(
            d_model=self.d_model, d_state=self.ssm_state,
            expand=self.ssm_expand, head_dim=self.ssm_head_dim,
            n_groups=self.ssm_groups, chunk=self.ssm_chunk)

    @property
    def n_attn_sites(self) -> int:
        """Number of shared-attention applications in a hybrid stack."""
        if self.arch_type != "hybrid":
            return 0
        return len([i for i in range(self.num_layers) if i % self.attn_every == 0])

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack + head)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        per_layer = 0
        if self.arch_type in ("dense", "vlm", "audio"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = d * f * (3 if self.activation == "swiglu" else 2)
            per_layer = attn + mlp + 2 * d
        elif self.arch_type == "moe":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            moe = self.n_experts * 3 * d * f + d * self.n_experts
            if self.moe_dense_residual:
                moe += 3 * d * f
            per_layer = attn + moe + 2 * d
        elif self.arch_type in ("ssm", "hybrid"):
            s = self.ssm_spec
            din = s.d_inner
            gn = s.n_groups * s.d_state
            per_layer = d * (2 * din + 2 * gn + s.n_heads) + din * d + s.d_conv * (din + 2 * gn) + 2 * din
        total = self.num_layers * per_layer + v * d
        if self.arch_type == "hybrid":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            total += attn + 3 * d * f + 4 * d   # one shared block
        if self.arch_type == "vlm":
            total += self.d_vision * d
        if self.arch_type == "audio":
            total += (self.n_codebooks - 1) * v * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.arch_type != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.num_layers * self.n_experts * 3 * d * f
        active = self.num_layers * (self.top_k + (1 if self.moe_dense_residual else 0)) * 3 * d * f
        return dense_like + active


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.arch_type != "hybrid":
        raise NotImplementedError(f"arch_type {cfg.arch_type!r} {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# init (the port's own seeded draws, of the reference's distributions)
# ---------------------------------------------------------------------------

def _normal(gen, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def _dense_init(gen, d_in: int, d_out: int, device, bias: bool = False) -> dict:
    p = {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=device)
    return p


def _attention_init(gen, spec: L.AttnSpec, device) -> dict:
    hq, hkv = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
    return {"wq": _dense_init(gen, spec.d_model, hq, device, spec.qkv_bias),
            "wk": _dense_init(gen, spec.d_model, hkv, device, spec.qkv_bias),
            "wv": _dense_init(gen, spec.d_model, hkv, device, spec.qkv_bias),
            "wo": _dense_init(gen, hq, spec.d_model, device)}


def _mlp_init(gen, d_model: int, d_ff: int, activation: str, device) -> dict:
    p = {"w1": _dense_init(gen, d_model, d_ff, device),
         "w2": _dense_init(gen, d_ff, d_model, device)}
    if activation == "swiglu":
        p["w3"] = _dense_init(gen, d_model, d_ff, device)
    return p


def _ssm_init(gen, spec: L.SSMSpec, device) -> dict:
    din = spec.d_inner
    d_in_proj = 2 * din + 2 * spec.n_groups * spec.d_state + spec.n_heads
    conv_dim = din + 2 * spec.n_groups * spec.d_state
    f32 = dict(dtype=torch.float32, device=device)
    a = 1.0 + 15.0 * torch.rand(spec.n_heads, generator=gen, **f32)
    dt = torch.exp(torch.rand(spec.n_heads, generator=gen, **f32)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": _normal(gen, (spec.d_model, d_in_proj),
                           1.0 / math.sqrt(spec.d_model), device),
        "conv_w": _normal(gen, (spec.d_conv, conv_dim), 0.1, device),
        "conv_b": torch.zeros(conv_dim, **f32),
        "A_log": torch.log(a),
        "D": torch.ones(spec.n_heads, **f32),
        "dt_bias": torch.log(torch.expm1(torch.clamp(dt, min=1e-4))),
        "norm": L.rmsnorm_init(din, device),
        "out_proj": _normal(gen, (din, spec.d_model), 1.0 / math.sqrt(din),
                            device),
    }


def cast_params(params: Any, dtype) -> Any:
    """Cast every weight matrix (ndim >= 2) to ``dtype``, keeping 1-D params
    (norms, biases, A_log / D / dt_bias) in float32 — the reference's
    ``_apply_param_dtype``. Casting to ``cfg.compute_dtype`` once at load
    gives the values every ``dense_apply`` would cast to."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.dim() >= 2 else params


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights of the reference's distributions, drawn from
    ``generator`` on ``device`` (the generator's device by default)."""
    _require_hybrid(cfg)
    device = generator.device if device is None else device
    d = cfg.d_model
    params = {
        "embed": {"table": _normal(generator, (cfg.padded_vocab, d), 0.02,
                                   device)},
        "layers": [{"ln": L.norm_init(cfg.norm, d, device),
                    "ssm": _ssm_init(generator, cfg.ssm_spec, device)}
                   for _ in range(cfg.num_layers)],
        "final_norm": L.norm_init(cfg.norm, d, device),
        "shared_attn": {
            "ln1": L.norm_init(cfg.norm, d, device),
            "attn": _attention_init(generator, cfg.attn_spec, device),
            "ln2": L.norm_init(cfg.norm, d, device),
            "mlp": _mlp_init(generator, d, cfg.d_ff, cfg.activation, device),
        },
    }
    if cfg.param_dtype != torch.float32:
        params = cast_params(params, cfg.param_dtype)
    return params


# ---------------------------------------------------------------------------
# embedding frontend and output head
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Map a batch to (B, S, d_model) in the compute dtype."""
    _require_hybrid(cfg)
    return L.embedding_apply(params["embed"], batch["tokens"],
                             cfg.compute_dtype)


def output_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    return L.unembed_apply(params["embed"], x)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

def _shared_block(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, spec: L.AttnSpec, cache=None, cpos=None,
                  return_kv: bool = False):
    sp = params["shared_attn"]
    h, kv = L.attention_apply(sp["attn"], L.norm_apply(cfg.norm, sp["ln1"], x),
                              positions, spec, cache, cpos, return_kv)
    x = x + h
    x = x + L.mlp_apply(sp["mlp"], L.norm_apply(cfg.norm, sp["ln2"], x),
                        cfg.activation)
    return x, kv


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _hybrid_layer(params: dict, i: int, x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Layer ``i`` of the stack: the shared attention block where
    ``i % attn_every == 0``, then the Mamba2 block (the reference's scan
    body)."""
    if i % cfg.attn_every == 0:
        x, _ = _shared_block(params, x, positions, cfg, cfg.attn_spec)
    lp = params["layers"][i]
    h, _ = L.ssm_apply(lp["ssm"], L.norm_apply(cfg.norm, lp["ln"], x),
                       cfg.ssm_spec)
    return x + h


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor,
                                                                  torch.Tensor]:
    """Full-sequence forward (train / prefill). Returns (logits, aux).

    With ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward pass, as the reference wraps each scan
    body in ``jax.checkpoint``."""
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(len(params["layers"])):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _hybrid_layer, params, i, x, positions, cfg,
                use_reentrant=False)
        else:
            x = _hybrid_layer(params, i, x, positions, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return output_logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in float32; the logsumexp runs over every
    column of ``logits`` (the padded vocabulary, as in the reference)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


def train_loss(params: dict, batch: dict, cfg: ModelConfig
               ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` plus the (zero) MoE auxiliary term. Returns
    (loss, {"loss", "xent", "moe_aux"})."""
    logits, aux = forward(params, batch, cfg)
    xent = softmax_xent(logits, batch["labels"]).mean()
    loss = xent + cfg.moe_aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


# ---------------------------------------------------------------------------
# prefill (process a prompt, fill the cache, emit last-token logits)
# ---------------------------------------------------------------------------

def _ring_fill(k_full: torch.Tensor, v_full: torch.Tensor, clen: int):
    """Scatter full-sequence KV (L, B, S, H, hd) into a ring buffer of
    length clen laid out (L, B, clen, H, hd). Slot i holds the *latest*
    position p < S with p % clen == i. Returns (k_cache, v_cache,
    slot_positions (clen,) int32), -1 for never-written slots."""
    s = k_full.shape[2]
    i = torch.arange(clen, device=k_full.device)
    src = (s - 1) - ((s - 1 - i) % clen)      # torch's % floors, as Python's
    valid = src >= 0
    srcc = src.clamp(min=0)
    keep = valid[None, None, :, None, None]
    k_cache = torch.where(keep, k_full.index_select(2, srcc),
                          k_full.new_zeros(()))
    v_cache = torch.where(keep, v_full.index_select(2, srcc),
                          v_full.new_zeros(()))
    slot_pos = torch.where(valid, src, -1).to(torch.int32)
    return k_cache, v_cache, slot_pos


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """KV ring-buffer length for a max context of seq_len. The ring buffer
    *is* the sliding window: when cache_len < seq_len old entries are
    overwritten, which enforces the window without extra masking."""
    if cfg.arch_type in ("ssm",):
        return 0
    if cfg.sliding_window is not None:                  # native SWA (Mixtral)
        return min(seq_len, cfg.sliding_window)
    if cfg.long_context_mode == "swa" and seq_len > cfg.swa_activation_len:
        return min(seq_len, cfg.serve_window)           # serving-only window
    return seq_len


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_seq_len: int,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; return (last-token logits (B, 1, V), decode
    cache sized for a total context of max_seq_len)."""
    if cfg.kv_cache_quant:
        raise NotImplementedError("the int8 KV cache (kv_cache_quant) is "
                                  "not ported yet (ROADMAP queue 1 item 7)")
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    clen = cache_len_for(cfg, max_seq_len)
    ks, vs, convs, ssms = [], [], [], []
    for i, lp in enumerate(params["layers"]):
        if i % cfg.attn_every == 0:
            x, (k, v) = _shared_block(params, x, positions, cfg,
                                      cfg.attn_spec, return_kv=True)
            ks.append(k.to(cache_dtype))
            vs.append(v.to(cache_dtype))
        h, st = L.ssm_apply(lp["ssm"], L.norm_apply(cfg.norm, lp["ln"], x),
                            cfg.ssm_spec, return_state=True)
        x = x + h
        convs.append(st["conv"])
        ssms.append(st["ssm"].float())
    kc, vc, slot_pos = _ring_fill(torch.stack(ks), torch.stack(vs), clen)
    cache = {
        "ssm": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)},
        "kv": {"k": kc, "v": vc},
        "kv_pos": slot_pos[None, None].expand(len(ks), b, clen).contiguous(),
    }
    return output_logits(params, x[:, -1:], cfg), cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache for a maximum context of ``seq_len`` tokens."""
    _require_hybrid(cfg)
    clen = cache_len_for(cfg, seq_len)
    n_sites = cfg.n_attn_sites
    ssm = L.init_ssm_cache(batch, cfg.ssm_spec, device=device)
    kv = L.init_kv_cache(batch, cfg.attn_spec, clen, dtype, device)
    return {
        "ssm": {k: t[None].repeat((cfg.num_layers,) + (1,) * t.dim())
                for k, t in ssm.items()},
        "kv": {k: t[None].repeat((n_sites,) + (1,) * t.dim())
               for k, t in kv.items()},
        "kv_pos": torch.full((n_sites, batch, clen), -1, dtype=torch.int32,
                             device=device),
    }


def _effective_decode_spec(cfg: ModelConfig) -> L.AttnSpec:
    # the ring-buffer overwrite already enforces the window during decode
    # (cache_len == window), so the decode mask needs no window term
    return dataclasses.replace(cfg.attn_spec, sliding_window=None)


def decode_step(params: dict, cache: dict, batch: dict, pos: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode. ``batch['tokens']``: (B, 1); ``pos``: (B,) absolute
    positions. Updates ``cache`` in place and returns (logits (B, 1, V),
    cache)."""
    x = embed_inputs(params, batch, cfg)                  # (B, 1, d)
    positions = pos[:, None].to(torch.int32)
    spec = _effective_decode_spec(cfg)
    site = 0
    for i, lp in enumerate(params["layers"]):
        if i % cfg.attn_every == 0:
            kv_site = {k: t[site] for k, t in cache["kv"].items()}
            x, _ = _shared_block(params, x, positions, cfg, spec, kv_site,
                                 cache["kv_pos"][site])
            site += 1
        sc = {k: t[i] for k, t in cache["ssm"].items()}
        h, _ = L.ssm_apply(lp["ssm"], L.norm_apply(cfg.norm, lp["ln"], x),
                           cfg.ssm_spec, sc)
        x = x + h
    return output_logits(params, x, cfg), cache
