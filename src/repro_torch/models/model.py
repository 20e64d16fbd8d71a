"""Decoder-LM skeleton of the port: the configuration record and the
dense, moe, ssm, hybrid, vlm and audio stacks.

Counterpart of ``repro.models.model``. ``ModelConfig`` keeps every field of
the reference (dtype fields hold torch dtypes). Three stacks:

 * dense blocks (``dense``, ``moe``, ``vlm``, ``audio``): pre-norm
   attention and MLP in every layer, each with its own KV cache; ``moe``
   layers put the mixture of experts (``layers.moe_apply``) in the MLP's
   place, and ``forward`` returns the mean of their load-balance losses.
   ``vlm`` prepends ``n_patches`` projected vision embeddings to the text;
   ``audio`` sums ``n_codebooks`` token embeddings per position and emits
   one logit row per codebook;
 * Mamba2 blocks only (``ssm``), with an O(1) recurrent decode state;
 * ``hybrid`` (Zamba2): the Mamba2 stack with one shared attention block
   applied before every layer ``i % attn_every == 0``, each application
   with its own KV cache.

The int8 KV cache (``kv_cache_quant``) runs on the dense-block stack; on the
hybrid stack it raises, because the reference's hybrid prefill keeps no
scales and its decode fails (ROADMAP queue 3, R4).

The layer stack is a Python loop over ``params["layers"]`` (a list of
per-layer dicts; the reference stacks them on a leading axis for
``lax.scan``). Caches keep the reference's stacked layout:
``{"kv": {"k", "v": (L, B, clen, Hkv, D)}, "kv_pos": (L, B, clen)}`` for
dense blocks (int8 ``k`` / ``v`` with bf16 ``k_scale`` / ``v_scale`` of
(L, B, clen, Hkv, 1) when quantized), ``{"ssm": {"conv": (L, B,
d_conv-1, C), "ssm": (L, B, H, P, N)}}`` for ssm, and both for hybrid, its
``kv`` stacked over the attention sites.

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
# the activation-sharding hook (the reference keeps it in this module)
from repro_torch.models.layers import activation_sharding, constrain  # noqa: F401
from repro_torch.models.sharding import is_dtensor

DENSE_ARCHS = ("dense", "moe", "vlm", "audio")
ARCH_TYPES = DENSE_ARCHS + ("ssm", "hybrid")


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
    def moe_spec(self) -> L.MoeSpec:
        return L.MoeSpec(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            group_size=self.moe_group_size,
            dense_residual=self.moe_dense_residual,
            dense_residual_ff=self.d_ff)

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


def _require_known(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def _kv_cache_dtype(cfg: ModelConfig, dtype):
    """The KV cache's dtype: int8 under ``kv_cache_quant`` (dense blocks
    only), else ``dtype``."""
    if not cfg.kv_cache_quant:
        return dtype
    if cfg.arch_type == "hybrid":
        raise NotImplementedError(
            "kv_cache_quant on the hybrid stack is refused: the reference's "
            "hybrid prefill casts K/V to int8 with no scales and its next "
            "decode_step raises KeyError 'k_scale' (ROADMAP queue 3, R4)")
    return torch.int8


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


def _experts(gen, spec: L.MoeSpec, d_in: int, d_out: int, device,
             to) -> torch.Tensor:
    """(E, d_in, d_out) expert matrices drawn one expert at a time at scale
    ``1 / sqrt(d_in)``, each cast by ``to`` as soon as it is drawn, into a
    tensor of the cast's dtype: the peak is the cast stack plus one float32
    expert matrix."""
    scale = 1.0 / math.sqrt(d_in)
    first = to(_normal(gen, (d_in, d_out), scale, device))
    out = first.new_empty((spec.n_experts, d_in, d_out))
    out[0] = first
    for i in range(1, spec.n_experts):
        out[i] = to(_normal(gen, (d_in, d_out), scale, device))
    return out


def _moe_init(gen, spec: L.MoeSpec, device, to, put=lambda _, t: t) -> dict:
    """An MoE layer's params; ``put(name, leaf)`` takes each expert matrix
    as soon as it is drawn."""
    p = {"router": _normal(gen, (spec.d_model, spec.n_experts),
                           1.0 / math.sqrt(spec.d_model), device)}
    for name, d_in, d_out in (("w1", spec.d_model, spec.d_ff),
                              ("w3", spec.d_model, spec.d_ff),
                              ("w2", spec.d_ff, spec.d_model)):
        p[name] = put(name, _experts(gen, spec, d_in, d_out, device, to))
    if spec.dense_residual:
        p["dense"] = _mlp_init(gen, spec.d_model,
                               spec.dense_residual_ff or spec.d_ff,
                               "swiglu", device)
    return p


def _layer_init(gen, cfg: ModelConfig, device, to=lambda t: t,
                put=lambda _, t: t) -> dict:
    """Params of one layer of the stack (the reference's ``_layer_init``).
    ``to`` casts an MoE layer's expert matrices as they are drawn, and
    ``put(path, leaf)`` then takes each of them."""
    d = cfg.d_model
    if cfg.arch_type in DENSE_ARCHS:
        p = {"ln1": L.norm_init(cfg.norm, d, device),
             "attn": _attention_init(gen, cfg.attn_spec, device),
             "ln2": L.norm_init(cfg.norm, d, device)}
        if cfg.arch_type == "moe":
            p["moe"] = _moe_init(gen, cfg.moe_spec, device, to,
                                 lambda name, t: put(f"moe/{name}", t))
        else:
            p["mlp"] = _mlp_init(gen, d, cfg.d_ff, cfg.activation, device)
        return p
    return {"ln": L.norm_init(cfg.norm, d, device),
            "ssm": _ssm_init(gen, cfg.ssm_spec, device)}


def _cast_matrices(params: Any, dtype, keep: tuple = ()) -> Any:
    if isinstance(params, dict):
        return {k: v if k in keep else _cast_matrices(v, dtype, keep)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_matrices(v, dtype, keep) for v in params]
    return params.to(dtype) if params.dim() >= 2 else params


def cast_params(params: Any, dtype) -> Any:
    """The load-time cast: every weight matrix (ndim >= 2) to ``dtype``,
    keeping 1-D params (norms, biases, A_log / D / dt_bias) in float32 and
    the MoE ``router`` as it is. Casting to ``cfg.compute_dtype`` once at
    load gives the values every ``dense_apply`` would cast to; the
    reference never casts the router (``moe_apply`` multiplies float32
    activations by it), and a bf16 router would move the routing."""
    return _cast_matrices(params, dtype, keep=("router",))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, cast=None, place=None) -> dict:
    """Random weights of the reference's distributions, drawn from
    ``generator`` on ``device`` (the generator's device by default), their
    matrices in ``cfg.param_dtype`` (the router too, as the reference's
    ``_apply_param_dtype`` casts it). With ``cast`` given, each piece (the
    embedding, every layer, the shared block, the frontends; an MoE
    layer's expert matrices one expert at a time) has its matrices cast to
    ``cast`` as soon as it is drawn: the values of
    ``cast_params(init_params(...), cast)``, with at most one float32 piece
    alive at a time. With ``place`` given, ``place(path, leaf)`` (path as
    ``layers/3/attn/wq/w``) replaces every leaf once its piece is drawn
    and cast, an expert matrix as soon as it is drawn: the sharded
    steps keep each rank's shard of it there."""
    _require_known(cfg)
    device = generator.device if device is None else device
    d = cfg.d_model

    def to(t):
        if cfg.param_dtype != torch.float32:
            t = t.to(cfg.param_dtype)
        return t if cast is None else t.to(cast)

    def cast_piece(tree):
        if cfg.param_dtype != torch.float32:
            tree = _cast_matrices(tree, cfg.param_dtype)
        return tree if cast is None else cast_params(tree, cast)

    def done(tree, path: str):
        tree = cast_piece(tree)
        return tree if place is None else _placed(tree, path, place)

    def layer(i: int) -> dict:
        put = ((lambda name, t: place(f"layers/{i}/{name}", t))
               if place is not None else (lambda _, t: t))
        return done(_layer_init(generator, cfg, device, to, put),
                    f"layers/{i}")

    params = {
        "embed": done({"table": _normal(generator, (cfg.padded_vocab, d),
                                        0.02, device)}, "embed"),
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "final_norm": done(L.norm_init(cfg.norm, d, device), "final_norm"),
    }
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = done({
            "ln1": L.norm_init(cfg.norm, d, device),
            "attn": _attention_init(generator, cfg.attn_spec, device),
            "ln2": L.norm_init(cfg.norm, d, device),
            "mlp": _mlp_init(generator, d, cfg.d_ff, cfg.activation, device),
        }, "shared_attn")
    if cfg.arch_type == "vlm":
        params["vision_proj"] = done(_dense_init(generator, cfg.d_vision, d,
                                                 device), "vision_proj")
    if cfg.arch_type == "audio":
        # one (CB-1, V, d) table, stacked as the reference's vmap stacks
        # it; drawn one codebook at a time
        tables = [cast_piece({"table": _normal(
            generator, (cfg.padded_vocab, d), 0.02, device)})["table"]
            for _ in range(cfg.n_codebooks - 1)]
        params["embed_cb"] = done({"table": torch.stack(tables)}, "embed_cb")
    return params


def _placed(tree: Any, path: str, place) -> Any:
    """``place(path/..., leaf)`` of every leaf; a leaf placed while it was
    drawn (a DTensor already) stays."""
    if isinstance(tree, dict):
        return {k: _placed(v, f"{path}/{k}" if path else k, place)
                for k, v in tree.items()}
    return tree if is_dtensor(tree) else place(path, tree)


# ---------------------------------------------------------------------------
# embedding frontends and output head
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Map a batch to (B, S, d_model) in the compute dtype: audio sums the
    codebooks' embeddings (codebook 0 first, in the reference's order: in
    bf16 the order of the sum matters); vlm puts the projected vision
    embeddings, where the batch has them, before the text."""
    _require_known(cfg)
    dt = cfg.compute_dtype
    if cfg.arch_type == "audio":
        toks = batch["tokens"]                                 # (B, S, CB)
        x = L.embedding_apply(params["embed"], toks[..., 0], dt)
        for i in range(cfg.n_codebooks - 1):
            tab = {"table": params["embed_cb"]["table"][i]}
            x = x + L.embedding_apply(tab, toks[..., i + 1], dt)
        return x
    x = L.embedding_apply(params["embed"], batch["tokens"], dt)
    if cfg.arch_type == "vlm" and "vision" in batch:      # decode: text only
        vis = L.dense_apply(params["vision_proj"], batch["vision"].to(dt))
        # both pinned first on a mesh: DTensor cannot join a partial sum
        # (the vision projection's, under FSDP) to a batch split
        x = torch.cat([constrain(vis), constrain(x)], dim=1)
    return x


def output_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, V) logits of the tied head; audio (B, S, CB, V), one row per
    codebook."""
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    if cfg.arch_type == "audio":
        tables = params["embed_cb"]["table"]
        outs = [L.unembed_apply(params["embed"], x)]
        outs += [L.unembed_apply({"table": tables[i]}, x)
                 for i in range(cfg.n_codebooks - 1)]
        return torch.stack(outs, dim=-2)
    return L.unembed_apply(params["embed"], x)


# ---------------------------------------------------------------------------
# the layers of the three stacks
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _attn_mlp_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, spec: L.AttnSpec, cache=None, cpos=None,
                    return_kv: bool = False):
    """Pre-norm attention then MLP (an MoE layer: its mixture of experts),
    with residuals: a dense-block layer, or the hybrid stack's shared
    block. Returns (x, kv as ``attention_apply``, the MoE aux loss or
    None)."""
    h, kv = L.attention_apply(p["attn"], L.norm_apply(cfg.norm, p["ln1"], x),
                              positions, spec, cache, cpos, return_kv)
    x = x + h
    normed = L.norm_apply(cfg.norm, p["ln2"], x)
    if "moe" in p:
        h, aux = L.moe_apply(p["moe"], normed, cfg.moe_spec)
        return x + h, kv, aux
    return x + L.mlp_apply(p["mlp"], normed, cfg.activation), kv, None


def _ssm_block(lp: dict, x: torch.Tensor, cfg: ModelConfig, cache=None,
               return_state: bool = False):
    """Pre-norm Mamba2 block with its residual. Returns (x, state) as
    ``ssm_apply``."""
    h, st = L.ssm_apply(lp["ssm"], L.norm_apply(cfg.norm, lp["ln"], x),
                        cfg.ssm_spec, cache, return_state)
    return x + h, st


def _attention_at(params: dict, i: int, cfg: ModelConfig):
    """The attention block that layer ``i`` applies first: the layer's own
    in a dense-block stack, the shared block at a hybrid stack's sites
    (``i % attn_every == 0``), else None."""
    if cfg.arch_type in DENSE_ARCHS:
        return params["layers"][i]
    if cfg.arch_type == "hybrid" and i % cfg.attn_every == 0:
        return params["shared_attn"]
    return None


def _layer(params: dict, i: int, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i`` of the stack (the reference's scan body): its attention
    block, if any, then for ssm and hybrid the Mamba2 block. Returns (x,
    the MoE aux loss or None)."""
    aux = None
    block = _attention_at(params, i, cfg)
    if block is not None:
        x, _, aux = _attn_mlp_block(block, x, positions, cfg, cfg.attn_spec)
    if cfg.arch_type not in DENSE_ARCHS:
        x, _ = _ssm_block(params["layers"][i], x, cfg)
    return x, aux


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor,
                                                                  torch.Tensor]:
    """Full-sequence forward (train / prefill). Returns (logits, aux); aux is
    the mean of the MoE layers' load-balance losses, 0 for the other
    families.

    With ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward pass, as the reference wraps each scan
    body in ``jax.checkpoint``."""
    x = constrain(embed_inputs(params, batch, cfg))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for i in range(len(params["layers"])):
        x = constrain(x)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer, params, i, x, positions, cfg, use_reentrant=False)
        else:
            x, aux = _layer(params, i, x, positions, cfg)
        if aux is not None:
            auxs.append(aux)
    aux = torch.stack(auxs).mean() if auxs else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return output_logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in float32; the logsumexp runs over every
    column of ``logits`` (the padded vocabulary, as in the reference).
    DTensor logits take ``_softmax_xent_sharded``."""
    if is_dtensor(logits):
        return _softmax_xent_sharded(logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


def _softmax_xent_sharded(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """``softmax_xent`` on a mesh, each rank on its own rows and, where the
    model axis divides the vocabulary, its own columns: the row's largest
    logit (a max over the axis, outside autograd: the logsumexp's
    gradient does not depend on it), the sum of exps and the gold logit
    (held by the rank whose columns hold the label, zero on the others)
    are completed over the model axis. Its result is (..., ) per token,
    split as the rows. A model axis of one card, or one that does not
    divide the vocabulary, runs ``softmax_xent`` on whole rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    m = mesh.mesh_dim_names.index("model")
    group = mesh.get_group(m)
    first = mesh.get_local_rank(m) * (logits.shape[-1] // mesh.size(m))
    split = mesh.size(m) > 1 and logits.shape[-1] % mesh.size(m) == 0
    rows = tuple(Shard(0) if i != m and p.is_shard(0) else Replicate()
                 for i, p in enumerate(logits.placements))
    cols = tuple(Shard(logits.ndim - 1) if i == m and split else p
                 for i, p in enumerate(rows))

    def xent(lg, lb):
        if not split:
            return softmax_xent(lg, lb)
        lg = lg.float()
        top = lg.detach().amax(dim=-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        total = L.sum_over(torch.exp(lg - top).sum(dim=-1), group)
        ids = lb.long() - first
        inside = (ids >= 0) & (ids < lg.shape[-1])
        gold = lg.gather(-1, ids.clamp(0, lg.shape[-1] - 1)[..., None])
        gold = L.sum_over(torch.where(inside, gold[..., 0], 0.0), group)
        return top[..., 0] + torch.log(total) - gold
    return L.local_map(xent, mesh, (cols, rows), rows)(logits, labels)


def train_loss(params: dict, batch: dict, cfg: ModelConfig
               ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy of the logits against
    ``batch["labels"]`` (vlm: over the text positions only; audio: over
    every codebook) plus ``moe_aux_weight`` times the MoE auxiliary loss. Returns (loss,
    {"loss", "xent", "moe_aux"})."""
    logits, aux = forward(params, batch, cfg)
    if cfg.arch_type == "vlm":
        logits = logits[:, cfg.n_patches:]
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


def _kv_cache(ks: list, vs: list, clen: int, b: int, dtype) -> dict:
    """The decode cache of per-layer (B, S, Hkv, D) keys and values: cast
    to ``dtype``, or for int8 quantized per (position, head) with bf16
    scales (``layers.quantize_kv``), then ring-filled."""
    if dtype == torch.int8:
        def quantized(ts: list) -> tuple:
            qs, scales = zip(*map(L.quantize_kv, ts))
            return torch.stack(qs), torch.stack(scales)
        (kq, ksc), (vq, vsc) = quantized(ks), quantized(vs)
        kc, vc, slot_pos = _ring_fill(kq, vq, clen)
        kscale, vscale, _ = _ring_fill(ksc, vsc, clen)
        kv = {"k": kc, "v": vc, "k_scale": kscale, "v_scale": vscale}
    else:
        kc, vc, slot_pos = _ring_fill(
            torch.stack([k.to(dtype) for k in ks]),
            torch.stack([v.to(dtype) for v in vs]), clen)
        kv = {"k": kc, "v": vc}
    return {"kv": kv, "kv_pos": slot_pos[None, None].expand(
        len(ks), b, clen).contiguous()}


def _ssm_cache(states: list) -> dict:
    return {"ssm": {"conv": torch.stack([st["conv"] for st in states]),
                    "ssm": torch.stack([st["ssm"].float() for st in states])}}


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_seq_len: int,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; return (last-token logits (B, 1, V), or (B,
    1, CB, V) for audio, and the decode cache sized for a total context of
    max_seq_len)."""
    cache_dtype = _kv_cache_dtype(cfg, cache_dtype)
    x = constrain(embed_inputs(params, batch, cfg))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    clen = cache_len_for(cfg, max_seq_len)
    ks, vs, states = [], [], []
    for i, lp in enumerate(params["layers"]):
        x = constrain(x)
        block = _attention_at(params, i, cfg)
        if block is not None:
            x, (k, v), _ = _attn_mlp_block(block, x, positions, cfg,
                                           cfg.attn_spec, return_kv=True)
            ks.append(k)
            vs.append(v)
        if cfg.arch_type not in DENSE_ARCHS:
            x, st = _ssm_block(lp, x, cfg, return_state=True)
            states.append(st)
    cache = _ssm_cache(states) if states else {}
    if ks:
        cache.update(_kv_cache(ks, vs, clen, b, cache_dtype))
    return output_logits(params, x[:, -1:], cfg), cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache for a maximum context of ``seq_len`` tokens."""
    _require_known(cfg)
    dtype = _kv_cache_dtype(cfg, dtype)

    def stacked(tree: dict, n: int) -> dict:
        return {k: t[None].repeat((n,) + (1,) * t.dim())
                for k, t in tree.items()}

    cache = {}
    if cfg.arch_type in ("ssm", "hybrid"):
        cache["ssm"] = stacked(L.init_ssm_cache(batch, cfg.ssm_spec,
                                                device=device),
                               cfg.num_layers)
    n_kv = (cfg.n_attn_sites if cfg.arch_type == "hybrid" else
            cfg.num_layers if cfg.arch_type in DENSE_ARCHS else 0)
    if n_kv:
        clen = cache_len_for(cfg, seq_len)
        cache["kv"] = stacked(L.init_kv_cache(batch, cfg.attn_spec, clen,
                                              dtype, device), n_kv)
        cache["kv_pos"] = torch.full((n_kv, batch, clen), -1,
                                     dtype=torch.int32, device=device)
    return cache


def _effective_decode_spec(cfg: ModelConfig) -> L.AttnSpec:
    # the ring-buffer overwrite already enforces the window during decode
    # (cache_len == window), so the decode mask needs no window term
    return dataclasses.replace(cfg.attn_spec, sliding_window=None)


def decode_step(params: dict, cache: dict, batch: dict, pos: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode. ``batch['tokens']``: (B, 1), or (B, 1, CB) for
    audio; ``pos``: (B,) absolute positions. Updates ``cache`` in place and
    returns (logits (B, 1, V) or (B, 1, CB, V), cache)."""
    x = constrain(embed_inputs(params, batch, cfg))       # (B, 1, d)
    positions = pos[:, None].to(torch.int32)
    spec = _effective_decode_spec(cfg)
    site = 0
    for i, lp in enumerate(params["layers"]):
        x = constrain(x)
        block = _attention_at(params, i, cfg)
        if block is not None:
            kv = {k: t[site] for k, t in cache["kv"].items()}
            x, _, _ = _attn_mlp_block(block, x, positions, cfg, spec, kv,
                                      cache["kv_pos"][site])
            site += 1
        if cfg.arch_type not in DENSE_ARCHS:
            sc = {k: t[i] for k, t in cache["ssm"].items()}
            x, _ = _ssm_block(lp, x, cfg, sc)
    return output_logits(params, x, cfg), cache
