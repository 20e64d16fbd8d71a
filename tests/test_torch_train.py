"""The port's training path against the JAX package, on the reduced Zamba2
(2 layers, d_model 256, chunk 32) in float32 compute with the reference's
parameters converted leaf by leaf (``convert.model_params``,
``convert.opt_state``) and inputs made with NumPy from a seed.

Tolerances: the synthetic tokens are bitwise equal; ``schedule`` and one
AdamW step within 1e-6 (float32, another summation order in the global
norm); ``train_loss`` within 1e-5 and each gradient leaf within 1e-4 of
that leaf's largest |g| (float32 forward and backward through other
kernels' summation orders); three ``Trainer`` steps' losses within 1e-4.
Remat on and off give gradients within 1e-6 of each leaf's largest |g|
(the same arithmetic recomputed), one microbatch against two within 1e-5
(two half-batch means averaged: another summation order). Checkpoints cross between the packages
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import SyntheticTokenSource as JSource
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.runtime.train_loop import Trainer as JTrainer
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import base as TC
from repro_torch.convert import model_params, opt_state
from repro_torch.data.pipeline import Prefetcher, SyntheticTokenSource
from repro_torch.launch import steps as TS
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.runtime.train_loop import Trainer


def _cfgs(**over):
    jcfg = dataclasses.replace(j_reduced(j_get_config("zamba2-1.2b")),
                               compute_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("zamba2-1.2b")),
                               compute_dtype=torch.float32, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, model_params(jax.tree.map(np.asarray, jp), tcfg)


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grad_leaves(params):
    return T.tree_map(lambda p: p.clone().requires_grad_(), params)


def _near(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------

def test_synthetic_tokens_are_bitwise_the_references():
    jcfg, tcfg = _cfgs()
    ref, got = iter(JSource(jcfg, 3, 17, seed=5)), iter(
        SyntheticTokenSource(tcfg, 3, 17, seed=5))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])


def test_prefetcher_places_batches_and_raises_source_errors():
    _, tcfg = _cfgs()
    pf = Prefetcher(SyntheticTokenSource(tcfg, 2, 8, seed=1), "cpu")
    want = next(iter(SyntheticTokenSource(tcfg, 2, 8, seed=1)))
    got = next(pf)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    pf.close()

    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise OSError("corpus gone")
    pf = Prefetcher(broken(), "cpu")
    next(pf)
    with pytest.raises(OSError, match="corpus gone"):
        next(pf)
    pf.close()


def test_schedule_matches_the_reference():
    cfg = TA.AdamWConfig()
    jcfg = JA.AdamWConfig()
    steps = np.array([0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000],
                     np.int32)
    want = np.asarray(JA.schedule(jcfg, jnp.asarray(steps)))
    got = TA.schedule(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_the_reference(model, master):
    """Two steps from the reference's state, float32 parameters (no master)
    or bf16 ones (a float32 master copy); grads large enough to clip."""
    jcfg, tcfg, jp, _ = model
    rng = np.random.default_rng(3)
    f32 = jax.tree.map(np.asarray, jp)
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32), f32)
    jparams = jax.tree.map(jnp.asarray, f32)
    tparams = model_params(f32, tcfg)
    if master:
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tparams = T.tree_map(lambda t: t.to(torch.bfloat16), tparams)
    cfg = TA.AdamWConfig(warmup_steps=1)
    jstate = JA.init_opt_state(jparams)
    tstate = TA.init_opt_state(tparams)
    assert ("master" in tstate) == ("master" in jstate) == master
    tgrads = model_params(grads, tcfg)
    jupdate = jax.jit(JA.adamw_update, static_argnums=3)
    for _ in range(2):
        jparams, jstate, jstats = jupdate(
            jax.tree.map(jnp.asarray, grads), jstate, jparams,
            JA.AdamWConfig(warmup_steps=1))
        tstats = TA.adamw_update(tgrads, tstate, tparams, cfg)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    want_state = opt_state(jax.tree.map(np.asarray, jstate), tcfg)
    for key in ("m", "v") + (("master",) if master else ()):
        for a, b in zip(T.leaves(tstate[key]), T.leaves(want_state[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    want = model_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     jparams), tcfg)
    for a, b in zip(T.leaves(tparams), T.leaves(want)):
        if master:    # bf16 parameters: at most one bf16 step apart
            np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                       rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_decays_what_the_reference_holds_as_matrices():
    """The reference stacks per-layer leaves, so a per-layer vector has two
    axes there and is decayed; the shared block's vectors are not."""
    p = {"layers": [{"v": torch.ones(3)}], "norm": torch.ones(3),
         "w": torch.ones(2, 2)}
    g = T.tree_map(torch.zeros_like, p)
    state = TA.init_opt_state(p)
    TA.adamw_update(g, state, p, TA.AdamWConfig(warmup_steps=0, lr=0.1))
    assert float(p["norm"][0]) == 1.0
    assert float(p["layers"][0]["v"][0]) < 1.0 and float(p["w"][0, 0]) < 1.0


# ---------------------------------------------------------------------------
# loss, gradients, trainer
# ---------------------------------------------------------------------------

def test_train_loss_and_gradients_match_the_reference(model):
    """Sequence 50: the SSD scan pads to 64 (two chunks of 32)."""
    jcfg, tcfg, jp, tp = model
    batch = _batch(0, 2, 50, jcfg.vocab_size)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(JM.train_loss, has_aux=True), static_argnums=2)(
            jp, jax.tree.map(jnp.asarray, batch), jcfg)
    met, grads = TS.loss_and_grads(
        _grad_leaves(tp), {k: torch.from_numpy(v) for k, v in batch.items()},
        tcfg)
    np.testing.assert_allclose(float(met["loss"]), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]),
                               rtol=1e-5, atol=1e-5)
    want = model_params(jax.tree.map(np.asarray, jgrads), tcfg)
    flat = jax.tree_util.tree_leaves_with_path(
        {**want, "layers": {str(i): l for i, l in enumerate(want["layers"])}})
    got = T.leaves({**grads, "layers": {str(i): l for i, l in
                                        enumerate(grads["layers"])}})
    assert len(got) == len(flat)
    for (path, w), g in zip(flat, got):
        _near(g.numpy(), w.numpy(), 1e-4, jax.tree_util.keystr(path))


def test_softmax_xent_runs_over_the_padded_vocabulary():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 640)).astype(np.float32)
    labels = rng.integers(0, 512, (2, 5)).astype(np.int32)
    want = np.asarray(JM.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = TM.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_remat_and_microbatches_leave_the_gradients_unchanged(model):
    _, tcfg, _, tp = model
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(1, 4, 40, tcfg.vocab_size).items()}
    m1, g1 = TS.loss_and_grads(_grad_leaves(tp), batch, tcfg)
    m2, g2 = TS.loss_and_grads(_grad_leaves(tp), batch,
                               dataclasses.replace(tcfg, remat=True))
    m3, g3 = TS.loss_and_grads(_grad_leaves(tp), batch, tcfg, microbatches=2)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m3["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for a, b, c in zip(T.leaves(g1), T.leaves(g2), T.leaves(g3)):
        _near(b.numpy(), a.numpy(), 1e-6, "remat")
        _near(c.numpy(), a.numpy(), 1e-5, "microbatches")


def test_three_trainer_steps_match_the_reference(model):
    jcfg, tcfg, _, _ = model
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    ref = JTrainer(jcfg, 2, 48, JA.AdamWConfig(**opt), seed=2)
    params = model_params(jax.tree.map(np.asarray, ref.params), tcfg)
    state = opt_state(jax.tree.map(np.asarray, ref.opt_state), tcfg)
    table = params["embed"]["table"].clone()
    trainer = Trainer(tcfg, 2, 48, TA.AdamWConfig(**opt), seed=2,
                      backend="cpu", params=params, opt_state=state)
    try:
        got = trainer.train(3, log_every=0)
    finally:
        trainer.close()
    want = ref.train(3, log_every=0)
    assert got.steps == want.steps == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got.losses[2] < got.losses[0]
    # the trainer updates its own copy, not the params it was given
    assert torch.equal(params["embed"]["table"], table)


def test_trainer_times_and_steps_on_the_cpu():
    _, tcfg = _cfgs()
    trainer = Trainer(tcfg, 2, 32, backend="cpu", seed=1)
    try:
        assert trainer.train_minibatch_time(warmup=1, iters=1) > 0
        before = trainer.params["embed"]["table"].detach().clone()
        trainer.step_minibatch()
        assert trainer.step == 1
        assert not torch.equal(before, trainer.params["embed"]["table"])
    finally:
        trainer.close()
    if not torch.cuda.is_available():          # the default never degrades
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tcfg, 2, 32)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def _state_after_one_step(jp, jcfg):
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), jp)
    _, state, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        grads, JA.init_opt_state(jp), jp, JA.AdamWConfig())
    return state


def test_checkpoints_cross_between_the_packages(model, tmp_path):
    jcfg, tcfg, jp, tp = model
    jstate = _state_after_one_step(jp, jcfg)
    tstate = opt_state(jax.tree.map(np.asarray, jstate), tcfg)

    j_save(tmp_path / "ref.npz", (jp, jstate), step=7)
    like = (T.tree_map(torch.zeros_like, tp),
            T.tree_map(torch.zeros_like, tstate))
    (gp, gs), step = restore_checkpoint(tmp_path / "ref.npz", like)
    assert step == 7 and gs["step"].dtype == torch.int32
    for a, b in zip(T.leaves((gp, gs)), T.leaves((tp, tstate))):
        assert torch.equal(a, b)

    save_checkpoint(tmp_path / "port.npz", (tp, tstate), step=9)
    (rp, rs), step = j_restore(tmp_path / "port.npz", (jp, jstate))
    assert step == 9
    for a, b in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((jp, jstate))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_cli_runs_reduced_on_the_cpu_and_resumes(capsys, tmp_path):
    ck = str(tmp_path / "ck.npz")
    args = ["--arch", "zamba2-1.2b", "--reduced", "--backend", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt", ck,
            "--ckpt-every", "2"]
    ttrain.main(args)
    out = capsys.readouterr().out
    assert "training zamba2-1.2b (hybrid), 2L d=256, batch=2 seq=32 on cpu" \
        in out and "done: loss" in out
    _, tcfg = _cfgs()
    trainer = Trainer(TC.reduced(TC.get_config("zamba2-1.2b")), 2, 32,
                      backend="cpu", ckpt_path=ck)
    try:
        trainer.restore()
        assert trainer.step == 2 and int(trainer.opt_state["step"]) == 2
        assert all(p.requires_grad for p in T.leaves(trainer.params))
    finally:
        trainer.close()
