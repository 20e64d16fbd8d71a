"""The port's dense, ssm, vlm and audio families against the JAX package:
the configurations, the parameter trees, the forward pass and the training
gradients.

Each of the seven configurations runs at its reduced size (2 layers,
d_model 256) in float32 compute from the same parameters on both sides,
drawn with NumPy from a seed and converted leaf by leaf
(``convert.model_params``). Every leaf is drawn, not only the matrices:
the reference initialises qkv and LayerNorm biases to 0 and norm scales
and ``D`` to 1, where a wrong bias or scale would not show, so here biases
are N(0, 0.1), scales and ``D`` 1 + N(0, 0.1), ``A_log`` and ``dt_bias``
of the reference's distributions.

Tolerances: ``forward`` logits within 1e-4 of the largest |logit| in
float32 and 2e-2 in bf16 (the two packages round at other places in bf16:
the reference casts the attention probabilities to bf16 before the PV
product, the port's kernel keeps them in float32); ``train_loss`` within
1e-5 and each gradient leaf within 1e-4 of its largest |g|, as
``tests/test_torch_train.py`` holds the hybrid stack. A narrow GQA case
(8 heads on 2 KV heads, D = 128, ``rope_theta`` 1e6, qkv bias) and
``stablelm-12b`` at its real head dim 160 (which the card's attention
kernel refuses; the plain version on the CPU takes any D) meet the same
limits. Rotary frequencies are bitwise the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import tree as T
from repro_torch.configs import base as TC
from repro_torch.convert import model_params
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

FAMILIES = ["stablelm-1.6b", "minitron-4b", "qwen2.5-14b", "stablelm-12b",
            "mamba2-780m", "internvl2-1b", "musicgen-medium"]
F32_TOL, BF16_TOL = 1e-4, 2e-2
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 45          # S = 45: the SSD scan pads to 64 (two chunks of 32)


def cfgs(arch: str, f32: bool = True, **over):
    """The reference's and the port's reduced configuration of ``arch``."""
    jcfg, tcfg = j_reduced(j_get_config(arch)), TC.reduced(TC.get_config(arch))
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


def numpy_params(jcfg, seed: int) -> dict:
    """A parameter tree of the reference's structure with every leaf drawn
    by NumPy: matrices normal at the reference's own scale, biases N(0,
    0.1), norm scales and ``D`` 1 + N(0, 0.1), ``A_log`` log U(1, 16),
    ``dt_bias`` the inverse softplus of log-uniform dt in [1e-3, 0.1]."""
    rng = np.random.default_rng(seed)
    ref = JM.init_params(jax.random.key(seed), jcfg)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['A_log']"):
            out = np.log(rng.uniform(1.0, 16.0, shape))
        elif name.endswith("['dt_bias']"):
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
            out = np.log(np.expm1(dt))
        elif name.endswith(("['scale']", "['D']")):
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith(("['bias']", "['b']", "['conv_b']")):
            out = 0.1 * rng.standard_normal(shape)
        else:
            out = rng.standard_normal(shape) * float(np.std(np.asarray(leaf)))
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, ref)


def numpy_batch(cfg, seed: int, b: int = B, s: int = S,
                kind: str = "train") -> dict:
    """NumPy inputs of ``cfg``'s shapes: tokens (audio: with a codebook
    axis), next-token labels for ``kind="train"``, and for vlm float32
    vision embeddings before ``s - n_patches`` text tokens."""
    rng = np.random.default_rng(seed)
    cb = (cfg.n_codebooks,) if cfg.arch_type == "audio" else ()
    s_txt = s - cfg.n_patches if cfg.arch_type == "vlm" else s
    toks = rng.integers(0, cfg.vocab_size, (b, s_txt + 1) + cb).astype(
        np.int32)
    out = {"tokens": toks[:, :-1]}
    if kind == "train":
        out["labels"] = toks[:, 1:]
    if cfg.arch_type == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def within(got, want, tol: float, what: str = "") -> None:
    """|got - want| within ``tol`` of want's largest |value|."""
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One configuration's reduced float32 pair and one NumPy parameter
    tree, as the reference's arrays and the port's tensors."""
    jcfg, tcfg = cfgs(request.param)
    ptree = numpy_params(jcfg, FAMILIES.index(request.param))
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, ptree),
            model_params(ptree, tcfg), ptree)


# ---------------------------------------------------------------------------
# configurations and trees
# ---------------------------------------------------------------------------

def test_configs_match_the_reference_for_all_ten():
    """``ARCH_IDS`` is the reference's list, in its order, and every
    configuration (the MoE pair included) holds the reference's fields."""
    assert TC.ARCH_IDS == J_ARCH_IDS and len(TC.ARCH_IDS) == 10
    for arch in TC.ARCH_IDS:
        jcfg, tcfg = j_get_config(arch), TC.get_config(arch)
        for f in dataclasses.fields(jcfg):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                    (arch, f.name)
        assert tcfg.param_count() == jcfg.param_count(), arch
        assert tcfg.active_param_count() == jcfg.active_param_count(), arch
        assert tcfg.padded_vocab == jcfg.padded_vocab, arch
        assert tcfg.resolved_head_dim == jcfg.resolved_head_dim, arch
    with pytest.raises(ValueError, match="unknown"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_tree(arch):
    jcfg, tcfg = cfgs(arch)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    assert len(own["layers"]) == tcfg.num_layers
    flat_own = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(
                    {**own, "layers": own["layers"][0]})}
    flat_ref = {jax.tree_util.keystr(k): v.shape[1:] if "layers" in
                jax.tree_util.keystr(k) else v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(ref)}
    assert flat_own == flat_ref
    # the reference's own tree converts leaf by leaf (vision_proj, embed_cb,
    # qkv and LayerNorm biases included)
    conv = model_params(ref, tcfg)
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(
                {**conv, "layers": conv["layers"][1]})} == flat_own


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium",
                                  "stablelm-1.6b"])
def test_make_batch_has_the_reference_shapes(arch):
    jcfg, tcfg = cfgs(arch)
    gen = torch.Generator().manual_seed(3)
    from repro.configs.base import batch_struct
    for kind in ("train", "prefill", "decode"):
        got = TC.make_batch(tcfg, 40, 3, kind, gen)
        want = batch_struct(jcfg, 40, 3, kind)
        assert list(got) == list(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, (kind, k)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
        assert int(got["tokens"].max()) < tcfg.vocab_size
    if arch == "internvl2-1b":
        with pytest.raises(ValueError, match="must exceed 16"):
            TC.make_batch(tcfg, 16, 1, "prefill", gen)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("head_dim", [64, 128, 160])
def test_rope_frequencies_are_the_references(theta, head_dim):
    np.testing.assert_array_equal(
        TL.rope_frequencies(head_dim, theta).numpy(),
        np.asarray(JL.rope_frequencies(head_dim, theta)))


# ---------------------------------------------------------------------------
# forward and training
# ---------------------------------------------------------------------------

def test_forward_matches_the_reference_in_f32(family):
    arch, jcfg, tcfg, jp, tp, _ = family
    batch = numpy_batch(tcfg, 0, kind="prefill")
    jl, jaux = jax.jit(JM.forward, static_argnums=2)(jp, to_jax(batch), jcfg)
    tl, aux = TM.forward(tp, to_torch(batch), tcfg)
    want_shape = (B, S) + ((tcfg.n_codebooks,) if arch == "musicgen-medium"
                           else ()) + (tcfg.padded_vocab,)
    assert tuple(tl.shape) == want_shape == jl.shape
    within(tl.numpy(), jl, F32_TOL, arch)
    assert float(aux) == float(jaux) == 0.0


def test_forward_in_bf16_is_within_two_percent_of_the_largest_logit(family):
    arch, _, _, _, _, ptree = family
    jcfg, tcfg = cfgs(arch, f32=False)
    tp = TM.cast_params(model_params(ptree, tcfg), tcfg.compute_dtype)
    batch = numpy_batch(tcfg, 1, kind="prefill")
    jl = np.asarray(jax.jit(JM.forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, ptree), to_jax(batch), jcfg)[0], np.float32)
    tl = TM.forward(tp, to_torch(batch), tcfg)[0]
    assert tl.dtype == torch.bfloat16
    within(tl.float().numpy(), jl, BF16_TOL, arch)


def test_train_loss_and_gradients_match_the_reference(family):
    """vlm scores the text positions only, audio every codebook."""
    arch, jcfg, tcfg, jp, tp, _ = family
    batch = numpy_batch(tcfg, 2)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(JM.train_loss, has_aux=True), static_argnums=2)(
            jp, to_jax(batch), jcfg)
    params = T.tree_map(lambda p: p.clone().requires_grad_(), tp)
    met, grads = TS.loss_and_grads(params, to_torch(batch), tcfg)
    np.testing.assert_allclose(float(met["loss"]), float(jloss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    want = model_params(jax.tree.map(np.asarray, jgrads), tcfg)
    named = jax.tree_util.tree_leaves_with_path(
        {**want, "layers": {str(i): l for i, l in enumerate(want["layers"])}})
    got = T.leaves({**grads, "layers": {str(i): l for i, l in
                                        enumerate(grads["layers"])}})
    assert len(got) == len(named)
    for (path, w), g in zip(named, got):
        within(g.numpy(), w.numpy(), GRAD_TOL,
               f"{arch} {jax.tree_util.keystr(path)}")


def test_remat_leaves_the_dense_gradients_unchanged():
    _, tcfg = cfgs("minitron-4b")
    tp = model_params(numpy_params(cfgs("minitron-4b")[0], 5), tcfg)
    batch = to_torch(numpy_batch(tcfg, 5))
    _, g1 = TS.loss_and_grads(T.tree_map(lambda p: p.clone()
                                         .requires_grad_(), tp), batch, tcfg)
    _, g2 = TS.loss_and_grads(T.tree_map(lambda p: p.clone()
                                         .requires_grad_(), tp), batch,
                              dataclasses.replace(tcfg, remat=True))
    for a, b in zip(T.leaves(g1), T.leaves(g2)):
        within(b.numpy(), a.numpy(), 1e-6, "remat")


# ---------------------------------------------------------------------------
# attention shapes the reduced configurations do not reach
# ---------------------------------------------------------------------------

# reduced() makes qwen2.5-14b and minitron-4b MHA and gives every attention
# family head dim 64: a narrow GQA case with a group of 4 at head dim 128,
# rope_theta 1e6 and qkv bias; and stablelm-12b's real head dim, 160
NARROW = {
    "gqa4-d128": ("qwen2.5-14b", dict(n_heads=8, n_kv_heads=2,
                                      head_dim=128)),
    "stablelm-12b-d160": ("stablelm-12b", dict(d_model=320, n_heads=2,
                                               n_kv_heads=2, head_dim=0,
                                               d_ff=640)),
}


@pytest.mark.parametrize("case", list(NARROW))
def test_narrow_attention_cases_match_the_reference(case):
    arch, over = NARROW[case]
    jcfg, tcfg = cfgs(arch, **over)
    if case.endswith("d160"):
        assert tcfg.resolved_head_dim == jcfg.resolved_head_dim == 160
    else:
        assert tcfg.qkv_bias and tcfg.rope_theta == 1e6
    ptree = numpy_params(jcfg, 11)
    if tcfg.qkv_bias:
        assert np.abs(ptree["layers"]["attn"]["wk"]["b"]).min() > 0
    jp, tp = jax.tree.map(jnp.asarray, ptree), model_params(ptree, tcfg)
    batch = numpy_batch(tcfg, 7)
    jl, _ = jax.jit(JM.forward, static_argnums=2)(jp, to_jax(batch), jcfg)
    tl, _ = TM.forward(tp, to_torch(batch), tcfg)
    within(tl.numpy(), jl, F32_TOL, case)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JM.train_loss, has_aux=True), static_argnums=2)(
            jp, to_jax(batch), jcfg)
    met, grads = TS.loss_and_grads(
        T.tree_map(lambda p: p.clone().requires_grad_(), tp),
        to_torch(batch), tcfg)
    np.testing.assert_allclose(float(met["loss"]), float(jloss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    want = model_params(jax.tree.map(np.asarray, jgrads), tcfg)
    for g, w in zip(T.leaves(grads), T.leaves(want)):
        within(g.numpy(), w.numpy(), GRAD_TOL, case)
