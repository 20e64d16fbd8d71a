"""The port's mixture of experts against the JAX package: ``moe_apply`` on
its own, then the reduced ``mixtral-8x22b`` and ``arctic-480b`` stacks
(configurations, parameter trees, the forward pass with its aux loss, the
training loss and its gradients).

Inputs and parameters are drawn with NumPy from a seed and handed to both
packages (``test_torch_families.numpy_params`` for the stacks: every leaf
drawn, the router at the reference's scale).

Tolerances: ``moe_apply`` in float32, y within 1e-5 of its largest |y| and
aux within 1e-6; in bf16, y within 2e-2. The routing (each choice's expert,
the keep mask, the count of dropped choices) is equal. Routing is where
the two packages may part for a reason that is not a fault: both compute
the float32 router softmax to within ulps, so where the k-th and (k+1)-th
probabilities of a token (or the first two, for the aux loss's argmax) lie
within 1e-6 of each other the two may pick different experts. No seed is
chosen to hide that: each case prints its smallest top-k margin and how
many choices fell within 1e-6 of a tie, and a group of tokens that holds
such a near tie is left out of the routing and y comparisons (none did
when these tests were written). An exact tie (two equal router columns)
is not a near tie: both packages give it to the lower expert index. The
stacks, in float32: logits within 1e-4 of the largest |logit|, aux within
1e-6, the loss within 1e-5 and every gradient leaf (router included)
within 1e-4 of its largest |g|, as ``tests/test_torch_families.py`` holds
the other families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from test_torch_families import (F32_TOL, GRAD_TOL, LOSS_TOL, cfgs,
                                 numpy_batch, numpy_params, to_jax, to_torch,
                                 within)

MOE_ARCHS = ["mixtral-8x22b", "arctic-480b"]
Y_TOL, AUX_TOL, BF16_TOL = 1e-5, 1e-6, 2e-2
NEAR_TIE = 1e-6
D, FF, E, GROUP = 64, 128, 8, 128


# ---------------------------------------------------------------------------
# the reference's routing, step for step (repro/models/layers.py:363-396),
# which its moe_apply computes and does not return
# ---------------------------------------------------------------------------

def reference_routing(router, x, spec) -> dict:
    """Expert of each (token, k) choice, its queue position, the keep mask
    and the float32 probabilities of ``x`` (B, S, d), grouped as
    ``JL.moe_apply`` groups it."""
    b, s, d = x.shape
    g_row = TL.moe_groups(s, spec.group_size)
    xg = jnp.asarray(x).reshape(b * g_row, s // g_row, d)
    g, t = xg.shape[:2]
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32),
                        jnp.asarray(router))
    probs = jax.nn.softmax(logits, axis=-1)
    capacity = max(int(np.ceil(t * spec.top_k / spec.n_experts
                               * spec.capacity_factor)), spec.top_k)
    _, idx = jax.lax.top_k(probs, spec.top_k)
    sel = jax.nn.one_hot(idx, spec.n_experts, dtype=jnp.float32)
    flat = sel.reshape(g, t * spec.top_k, spec.n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    pos = pos.reshape(g, t, spec.top_k)
    return {"expert": np.asarray(idx), "pos": np.asarray(pos, np.int64),
            "keep": np.asarray(pos < capacity), "probs": np.asarray(probs),
            "capacity": capacity}


def near_ties(probs: np.ndarray, k: int) -> tuple[float, np.ndarray]:
    """(smallest gap between neighbours among each token's k + 1 largest
    probabilities, the number of such gaps within NEAR_TIE per group);
    exact ties are decided alike in both packages and are not counted."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]                # (G, T, k)
    open_ = gaps > 0
    smallest = float(gaps[open_].min(initial=np.inf))
    return smallest, ((gaps <= NEAR_TIE) & open_).sum(axis=(1, 2))


def moe_case(seed: int, s: int, capacity_factor: float, dense: bool,
             b: int = 2, router=None, n_experts: int = E,
             group_size: int = GROUP):
    """Spec pair, NumPy params and input of one ``moe_apply`` case."""
    kw = dict(d_model=D, d_ff=FF, n_experts=n_experts, top_k=2,
              capacity_factor=capacity_factor, group_size=group_size,
              dense_residual=dense, dense_residual_ff=FF)
    jspec, tspec = JL.MoeSpec(**kw), TL.MoeSpec(**kw)
    rng = np.random.default_rng(seed)
    ref = JL.moe_init(jax.random.key(seed), jspec)
    p = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                * float(np.std(np.asarray(a)))
                                ).astype(np.float32), ref)
    if router is not None:
        p["router"] = router(p["router"])
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    return jspec, tspec, p, x


def compare_moe(jspec, tspec, p, x, dtype=torch.float32) -> dict:
    """Run both packages' ``moe_apply`` (and the routing) on one case and
    hold them together; returns the port's routing and the counts."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy, jaux = JL.moe_apply(jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x).astype(jdt), jspec)
    tp = jax.tree.map(torch.from_numpy, p)
    tx = torch.from_numpy(x).to(dtype)
    ty, taux = TL.moe_apply(tp, tx, tspec)
    assert ty.dtype == dtype and taux.dtype == torch.float32
    b, s, d = x.shape
    g_row = TL.moe_groups(s, tspec.group_size)
    ref = reference_routing(p["router"], np.asarray(tx.float()), jspec)
    got = TL.moe_route(tp["router"], tx.reshape(b * g_row, s // g_row, d),
                       tspec)
    assert got.capacity == ref["capacity"]
    smallest, near = near_ties(ref["probs"], tspec.top_k)
    print(f"s={s} capacity_factor={tspec.capacity_factor}: smallest top-k "
          f"margin {smallest:.3g}, {int(near.sum())} choice(s) within "
          f"{NEAR_TIE} of a tie")
    held = near == 0                                     # groups compared
    np.testing.assert_array_equal(got.expert.numpy()[held],
                                  ref["expert"][held])
    np.testing.assert_array_equal(got.pos.numpy()[held], ref["pos"][held])
    np.testing.assert_array_equal(got.keep.numpy()[held], ref["keep"][held])
    dropped = int((~got.keep).sum())
    if held.all():
        assert dropped == int((~ref["keep"]).sum())
        np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_TOL,
                                   atol=AUX_TOL)
    rows = np.repeat(held.reshape(b, g_row), s // g_row, axis=1)  # (B, S)
    want = np.asarray(jy, np.float32)
    tol = Y_TOL if dtype == torch.float32 else BF16_TOL
    within(ty.float().numpy()[rows], want[rows], tol, f"y (s={s})")
    return {"routing": got, "dropped": dropped, "near": int(near.sum())}


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("s", [1, 45, 128, 257, 300])
def test_moe_apply_matches_the_reference(s, capacity_factor, dense):
    """Groups: one per row up to s = 255; s = 257 is prime (the divisor
    search falls back to one group of 257), s = 300 two of 150. At
    capacity factor 0.5 every sequence past one token drops choices; one
    token's two choices always fit (capacity is at least top_k)."""
    case = moe_case(s + int(10 * capacity_factor) + dense, s,
                    capacity_factor, dense)
    out = compare_moe(*case)
    if capacity_factor == 0.5 and s > 1:
        assert out["dropped"] > 0
    if s == 1:
        assert out["dropped"] == 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_matches_the_reference_over_arctic_experts(capacity_factor):
    """Arctic's routing at its served size: 128 experts, top 2, one group
    of 512 tokens a row (group size 1024), so 10 slots an expert (4 at
    factor 0.5): queue positions over 128 experts, heavy drops, and the
    dense residual."""
    case = moe_case(60 + int(10 * capacity_factor), 512, capacity_factor,
                    True, n_experts=128, group_size=1024)
    out = compare_moe(*case)
    assert out["routing"].capacity == {1.25: 10, 0.5: 4}[capacity_factor]
    assert out["near"] == 0 and out["dropped"] > 0


def test_moe_groups_and_capacity_are_the_references():
    for s in (1, 45, 127, 128, 255, 256, 257, 300, 1024, 8704):
        g = TL.moe_groups(s, GROUP)
        assert s % g == 0 and 1 <= g <= max(1, s // GROUP)
        assert all(s % h for h in range(g + 1, max(1, s // GROUP) + 1))
    assert TL.moe_groups(257, 128) == 1 and TL.moe_groups(300, 128) == 2
    assert TL.moe_groups(8704, 1024) == 8              # Mixtral's long prompt
    spec = TL.MoeSpec(6144, 16384, 8)
    assert [TL.moe_capacity(t, spec) for t in (1, 512, 1088)] == [2, 160, 340]
    arctic = TL.MoeSpec(7168, 4864, 128)
    assert [TL.moe_capacity(t, arctic) for t in (1, 512, 1024)] == [2, 10, 20]


def test_equal_router_columns_go_to_the_lower_expert():
    """Experts 1 and 2 share one router column, so every token ties them
    exactly; where they are its 2nd and 3rd choice, both packages take
    expert 1 (``lax.top_k``'s order)."""
    def tie(r):
        r = r.copy()
        r[:, 2] = r[:, 1]
        return r
    case = moe_case(3, 300, 1.25, False, router=tie)
    got = compare_moe(*case)["routing"].expert.numpy()
    has1, has2 = (got == 1).any(-1), (got == 2).any(-1)
    assert (has1 >= has2).all()                  # never 2 without 1
    assert (has1 & ~has2).sum() > 0              # the tie was decided
    assert (has1 & has2).sum() > 0               # and both fit where top two


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("s", [45, 300])
def test_moe_apply_in_bf16_is_within_two_percent(s, dense):
    """bf16 activations, expert weights cast to bf16 on both sides, the
    router in float32: the same routing, y within 2e-2 of its largest."""
    case = moe_case(40 + s + dense, s, 1.25, dense)
    compare_moe(*case, dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# the reduced MoE stacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_family(request):
    """One MoE configuration's reduced float32 pair, one NumPy parameter
    tree as the reference's arrays and the port's tensors, and the
    reference's forward, loss and gradients on one batch."""
    arch = request.param
    jcfg, tcfg = cfgs(arch)
    ptree = numpy_params(jcfg, 60 + MOE_ARCHS.index(arch))
    jp = jax.tree.map(jnp.asarray, ptree)
    batch = numpy_batch(tcfg, 61)
    jl, jaux = jax.jit(JM.forward, static_argnums=2)(jp, to_jax(batch), jcfg)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(JM.train_loss, has_aux=True), static_argnums=2)(
            jp, to_jax(batch), jcfg)
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "ptree": ptree,
            "tp": model_params(ptree, tcfg), "batch": batch,
            "logits": np.asarray(jl), "aux": float(jaux),
            "loss": float(jloss), "xent": float(jmet["xent"]),
            "grads": model_params(jax.tree.map(np.asarray, jgrads), tcfg)}


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-k margin of every ``moe_route`` call the port makes
    while the test runs (the model reaches it through ``moe_apply``)."""
    seen = []
    route = TL.moe_route

    def recording(router, xg, spec):
        r = route(router, xg, spec)
        seen.append(near_ties(r.probs.detach().numpy(), spec.top_k)[0])
        return r
    monkeypatch.setattr(TL, "moe_route", recording)
    return seen


def test_reduced_moe_configs_are_the_references():
    for arch in MOE_ARCHS:
        jcfg = j_reduced(j_get_config(arch))
        tcfg = TC.reduced(TC.get_config(arch))
        for f in dataclasses.fields(jcfg):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                    (arch, f.name)
        assert dataclasses.asdict(tcfg.moe_spec) == \
            dataclasses.asdict(jcfg.moe_spec)
        assert (tcfg.n_experts, tcfg.moe_group_size) == (4, 128)
        assert tcfg.active_param_count() == jcfg.active_param_count()
    assert TC.reduced(TC.get_config("mixtral-8x22b")).sliding_window == 64


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_params_has_the_reference_tree(arch):
    """The same leaves and shapes as the reference's tree; the cast while
    drawing (one expert matrix at a time) bitwise the cast of the float32
    tree; the router left float32 by the load-time cast."""
    jcfg, tcfg = cfgs(arch, f32=False)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    flat_own = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(
                    {**own, "layers": own["layers"][0]})}
    flat_ref = {jax.tree_util.keystr(k): v.shape[1:] if "layers" in
                jax.tree_util.keystr(k) else v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(ref)}
    assert flat_own == flat_ref
    assert ("dense" in own["layers"][0]["moe"]) == tcfg.moe_dense_residual
    conv = model_params(ref, tcfg)
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(
                {**conv, "layers": conv["layers"][1]})} == flat_own
    cast = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          cast=torch.bfloat16)
    want = TM.cast_params(own, torch.bfloat16)
    assert T.tree_map(lambda t: t.dtype, cast) == \
        T.tree_map(lambda t: t.dtype, want)
    for a, b in zip(T.leaves(cast), T.leaves(want)):
        assert torch.equal(a, b)
    for layer in cast["layers"]:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w2"].dtype == torch.bfloat16
    # the scales: 1 / sqrt(d) for the router, w1 and w3; 1 / sqrt(f) for w2
    moe = own["layers"][0]["moe"]
    for name, fan_in in (("router", tcfg.d_model), ("w1", tcfg.d_model),
                         ("w2", tcfg.d_ff)):
        assert abs(float(moe[name].std()) * fan_in ** 0.5 - 1.0) < 0.05


def test_moe_forward_matches_the_reference_in_f32(moe_family, margins):
    f = moe_family
    tl, aux = TM.forward(f["tp"], to_torch(f["batch"]), f["tcfg"])
    assert margins and len(margins) == f["tcfg"].num_layers
    what = f"{f['arch']} (smallest top-k margin {min(margins):.3g})"
    within(tl.numpy(), f["logits"], F32_TOL, what)
    assert f["aux"] > 0
    np.testing.assert_allclose(float(aux), f["aux"], rtol=AUX_TOL,
                               atol=AUX_TOL, err_msg=what)


def test_moe_train_loss_and_gradients_match_the_reference(moe_family,
                                                          margins):
    """The loss carries ``moe_aux_weight`` times the aux loss; the router's
    gradient comes through the gates and the aux loss's density."""
    f = moe_family
    tcfg = f["tcfg"]
    params = T.tree_map(lambda p: p.clone().requires_grad_(), f["tp"])
    met, grads = TS.loss_and_grads(params, to_torch(f["batch"]), tcfg)
    what = f"{f['arch']} (smallest top-k margin {min(margins):.3g})"
    np.testing.assert_allclose(float(met["loss"]), f["loss"], rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=what)
    np.testing.assert_allclose(float(met["xent"]), f["xent"], rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=what)
    np.testing.assert_allclose(
        float(met["loss"]) - float(met["xent"]),
        tcfg.moe_aux_weight * float(met["moe_aux"]), rtol=1e-4, atol=1e-7)
    want = f["grads"]
    named = jax.tree_util.tree_leaves_with_path(
        {**want, "layers": {str(i): l for i, l in enumerate(want["layers"])}})
    got = T.leaves({**grads, "layers": {str(i): l for i, l in
                                        enumerate(grads["layers"])}})
    assert len(got) == len(named)
    assert any("router" in jax.tree_util.keystr(p) for p, _ in named)
    for (path, w), g in zip(named, got):
        within(g.numpy(), w.numpy(), GRAD_TOL,
               f"{what} {jax.tree_util.keystr(path)}")


def test_remat_returns_the_aux_and_leaves_the_gradients(moe_family):
    """Under remat each layer's checkpointed function returns its aux
    loss as well: the same loss and gradients as without."""
    f = moe_family
    batch = to_torch(f["batch"])
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(f["tcfg"], remat=remat)
        params = T.tree_map(lambda p: p.clone().requires_grad_(), f["tp"])
        runs.append(TS.loss_and_grads(params, batch, cfg))
    (m1, g1), (m2, g2) = runs
    assert float(m2["moe_aux"]) == pytest.approx(float(m1["moe_aux"]),
                                                 rel=1e-6)
    assert float(m1["moe_aux"]) > 0
    for a, b in zip(T.leaves(g1), T.leaves(g2)):
        within(b.numpy(), a.numpy(), 1e-6, "remat")
