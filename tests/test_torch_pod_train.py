"""The pod layer's training half: the port's sharded train step
(``launch.steps.sharded_step`` with ``kind="train"``) on DTensor meshes,
against its own unsharded step and the reference's.

The ten configurations run reduced, in float32, with FSDP on the (data,
model) meshes (1, 4), (2, 2) and (4, 1), and with FSDP off on (2, 2): one
launch of four gloo ranks per mesh shape through ``launch.ranks``, and a
second on (2, 2) for FSDP off, each running every case it is given
(``torch_pod_ranks.train_cases``). Two
more cases run with FSDP on every mesh: zamba2-1.2b with bf16 parameters (a float32
``master`` in the optimizer state) and Mixtral with 6 experts, whose FFN
dim splits over the model axis of (1, 4) where 4 experts split by expert.
On (2, 2) zamba2-1.2b and Mixtral also run in 2 microbatches. This process
makes no process group: it draws the parameters and batches with NumPy,
hands them to the ranks in a file and meanwhile runs the port's unsharded
steps and the reference's (jitted) from the same parameters.

Each case takes two AdamW steps on one batch of B x SEQ tokens.
Tolerances: the sharded first step's metrics and every gradient leaf, and
m and v after it (linear in the gradients), within 1e-5 of the port's
unsharded step, of the largest |value| in the leaf's layer (or top-level
block): reductions split over ranks reorder float32 sums, whose error
scales with the terms summed, and a per-head vector such as ``A_log``
sums terms of its layer's size that cancel to ~1e-3 of it (its own
largest |g|, the yardstick of a whole matrix, would put that noise at
2e-5 of it). The second step's metrics within 1e-4 (the
trajectory tolerance of ``test_torch_train.py``: Adam's first update
divides each gradient element by its own size, so where an element is
near zero a reordering moves that element's update by up to lr, and the
second step starts from parameters that differ by that much). The sharded
AdamW update itself is held at 1e-6: two updates on the mesh against two
on whole tensors, given the same gradients, leave params, m, v and master
within 1e-6 of each leaf's largest |value| (bf16 parameters, their master
rounded, within one bf16 step). A microbatched case is held
against the unsharded step in one batch. With bf16 parameters the
gradients are rounded to bf16 (each element once, so two summation orders
may round it one bf16 step apart): there the gradients and m are held
within 2^-7 of the largest in their layer, and v (their square) within
twice that (the float32 cases hold v at twice their tolerance too), and so
are the grad norm and the second step's metrics. Against the reference, on converted
parameters, ``test_torch_train.py``'s tolerances: the first step's loss
within 1e-5 and every gradient leaf within 1e-4, the two steps' losses and
grad norms within 1e-4.

The (2, 2) launch also saves its zamba2-1.2b state after the two steps
(``checkpoint.save_checkpoint`` of DTensors) and restores it onto the
(4, 1) and (1, 4) meshes of the same ranks and unsharded, bitwise, and
restores a checkpoint written by the reference's ``save_checkpoint`` onto
(2, 2). The (2, 2) and (4, 1) launches draw batches through
``ShardedPrefetcher``; the (1, 4) launch records what reaches the
attention and SSD kernels' entry points in a step with remat.
"""
import concurrent.futures
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import save_checkpoint as j_save
from repro.data.pipeline import SyntheticTokenSource as JSource
from repro.launch import steps as RST
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch import tree as T
from repro_torch.configs import base as TC
from repro_torch.convert import model_params
from repro_torch.launch import ranks
from repro_torch.launch import steps as TS
from repro_torch.models import sharding as S
from repro_torch.optim import adamw as TA
from test_torch_families import cfgs, numpy_batch, within
from test_torch_pod_serve import _flat, _numpy_params
import torch_pod_ranks as R

RANKS = str(Path(__file__).with_name("torch_pod_ranks.py"))
SHAPES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
# one launch per mesh shape, and a second on (2, 2) for its TP-only and
# microbatched cases (the launches share the cores)
LAUNCHES = {**SHAPES, "2x2tp": (2, 2)}
ARCHS = TC.ARCH_IDS
B, SEQ = 4, 40
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SHARDED_TOL, STATE_TOL = 1e-5, 1e-6
BF16_TOL = 2 ** -7      # one bf16 step: gradients rounded to bf16
LOSS_TOL, GRAD_TOL, STEPS_TOL = 1e-5, 1e-4, 1e-4
MASTER = ("zamba2-1.2b", True, {"param_dtype": "bfloat16"})
FFN_SPLIT = ("mixtral-8x22b", True, {"n_experts": 6})
MICRO = [(a, True, {"microbatches": 2})
         for a in ("zamba2-1.2b", "mixtral-8x22b")]
SAVED = ["zamba2-1.2b", True, {}]
PREFETCHED = ("zamba2-1.2b", "internvl2-1b", "musicgen-medium")
PREFETCH_SEED = 5
SPIED = "zamba2-1.2b"
WALL_S = 600        # a launch: ~40 s alone, longer beside other workers


def _cases(launch: str) -> list:
    if launch == "2x2tp":
        cases = [(a, False, {}) for a in ARCHS] + MICRO
    else:
        cases = [(a, True, {}) for a in ARCHS] + [MASTER, FFN_SPLIT]
    return [list(c) for c in cases]


def _case_ids():
    return [(launch, R.case_name(*c)) for launch in LAUNCHES
            for c in _cases(launch)]


def _unsharded(cfg, params: dict, batch: dict) -> dict:
    """The port's unsharded first-step gradients, m and v after it, and the
    two steps' metrics."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fresh = T.tree_map(lambda p: p.clone().requires_grad_(), params)
    _, grads = TS.loss_and_grads(fresh, tb, cfg)
    state = TA.init_opt_state(fresh)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT))
    metrics = [{k: float(v) for k, v in step(fresh, state, tb).items()}]
    out = {f"grads/{p}": g.float().numpy() for p, g in S.flat_paths(grads)}
    for k in ("m", "v"):
        out.update({f"{k}/{p}": t.numpy().copy()
                    for p, t in S.flat_paths(state[k])})
    metrics.append({k: float(v) for k, v in step(fresh, state, tb).items()})
    return {"arrays": out, "metrics": metrics}


def _reference(arch: str, ptree: dict, batch: dict) -> dict:
    """The reference's first-step loss and gradients and its two steps
    (``make_train_step``), jitted, converted to the port's paths."""
    jcfg, tcfg = cfgs(arch)
    jp = jax.tree.map(jnp.asarray, ptree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(JM.train_loss,
                                                  has_aux=True),
                               static_argnums=2)(jp, jb, jcfg)
    step = jax.jit(RST.make_train_step(jcfg, JA.AdamWConfig(**OPT)))
    p, st = jp, JA.init_opt_state(jp)
    metrics = []
    for _ in range(2):
        p, st, m = step(p, st, jb)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})

    def flat(tree):
        return {q: t.numpy() for q, t in S.flat_paths(
            model_params(jax.tree.map(np.asarray, tree), tcfg))}
    return {"loss": float(loss), "grads": flat(grads), "metrics": metrics}


def _ref_checkpoint(d: Path, ptree: dict) -> dict:
    """The reference's ``save_checkpoint`` of reduced zamba2-1.2b's
    ``(params, opt_state)`` after one AdamW update, at step 7; returns the
    leaves at the port's paths."""
    jcfg, tcfg = cfgs("zamba2-1.2b")
    jp = jax.tree.map(jnp.asarray, ptree)
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), jp)
    _, state, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        grads, JA.init_opt_state(jp), jp, JA.AdamWConfig())
    j_save(d / "ref.npz", (jp, state), step=7)
    np_state = jax.tree.map(np.asarray, state)
    tree = [model_params(jax.tree.map(np.asarray, jp), tcfg),
            {"m": model_params(np_state["m"], tcfg),
             "v": model_params(np_state["v"], tcfg),
             "step": torch.tensor(int(np_state["step"]), dtype=torch.int32)}]
    return {p: t.numpy() for p, t in S.flat_paths(tree)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Starts the three launches, runs the unsharded steps and the
    reference meanwhile, and returns ``(port runs, reference runs, {shape:
    rank results or the error}, out dir, reference checkpoint leaves)``."""
    d = tmp_path_factory.mktemp("pod_train")
    flat, trees, batches = {}, {}, {}
    cases = [c for launch in LAUNCHES for c in _cases(launch)]
    keys = {R.tree_key(a, o): (a, {k: v for k, v in o.items()
                                   if k == "n_experts"}) for a, _, o in cases}
    variants = {(R.tree_key(a, o), o.get("param_dtype")): (
        a, {k: v for k, v in o.items() if k not in R.STEP_OPTIONS})
        for a, _, o in cases}
    for i, (key, (arch, over)) in enumerate(sorted(keys.items())):
        tcfg = R.train_config(arch, over)
        trees[key] = _numpy_params(tcfg, 100 + i)
        batches[key] = numpy_batch(tcfg, 200 + i, b=B, s=SEQ)
        flat.update({f"{key}|param|{k}": v
                     for k, v in _flat(trees[key]).items()})
        flat.update({f"{key}|batch|{k}": v for k, v in batches[key].items()})
    np.savez(d / "inputs.npz", **flat)
    ref_ckpt = _ref_checkpoint(d, trees["zamba2-1.2b"])
    with concurrent.futures.ThreadPoolExecutor(len(LAUNCHES)) as pool:
        futures = {}
        for name, shape in LAUNCHES.items():
            (d / name).mkdir()
            payload = {"shape": list(shape), "inputs": str(d / "inputs.npz"),
                       "batch": B, "seq": SEQ, "opt": OPT,
                       "cases": _cases(name), "out": str(d / name)}
            if name in ("2x2", "4x1"):
                payload.update(prefetch=list(PREFETCHED),
                               prefetch_seed=PREFETCH_SEED)
            if name == "2x2":
                payload.update(checkpoint=SAVED,
                               ref_checkpoint=str(d / "ref.npz"))
            if name == "1x4":
                payload["spy"] = SPIED
            futures[name] = pool.submit(ranks.run, f"{RANKS}:train_cases",
                                        payload, math.prod(shape),
                                        device="cpu", wall_s=WALL_S)
        runs = {}
        for (key, dtype), (arch, over) in variants.items():
            cfg = R.train_config(arch, over)
            runs[key, dtype] = _unsharded(
                cfg, R.train_params(trees[key], cfg), batches[key])
        refs = {arch: _reference(arch, trees[arch], batches[arch])
                for arch in ARCHS}
        results = {}
        for name, f in futures.items():
            try:
                results[name] = f.result()
            except ranks.RankError as e:
                results[name] = e
    return runs, refs, results, d, ref_ckpt


def _shape_results(trained, shape: str) -> list:
    results = trained[2][shape]
    if isinstance(results, Exception):
        raise results
    return results


def _run_of(trained, arch: str, over: dict) -> dict:
    return trained[0][R.tree_key(arch, over), over.get("param_dtype")]


def _case(trained, shape: str, name: str):
    results = _shape_results(trained, shape)
    arch, fsdp, _ = name.split("|")
    over = next(o for a, f, o in _cases(shape)
                if R.case_name(a, f, o) == name)
    got = np.load(trained[3] / shape / f"{name.replace('|', '_')}.npz")
    return arch, over, results, got


def _block(key: str) -> str:
    """``grads/layers/3/ssm/A_log`` -> ``grads/layers/3``; ``m/embed/table``
    -> ``m/embed``: the tree, and the layer or top-level block."""
    parts = key.split("/")
    return "/".join(parts[:3] if parts[1] == "layers" else parts[:2])


def _block_scales(arrays: dict) -> dict:
    out: dict = {}
    for k, v in arrays.items():
        out[_block(k)] = max(out.get(_block(k), 0.0),
                             float(np.abs(v).max(initial=0.0)))
    return {k: max(v, 1e-30) for k, v in out.items()}


@pytest.mark.parametrize("shape,name", _case_ids())
def test_sharded_train_steps_match_the_unsharded_one(trained, shape, name):
    arch, over, results, got = _case(trained, shape, name)
    run = _run_of(trained, arch, over)
    want = run["arrays"]
    tol = BF16_TOL if "param_dtype" in over else SHARDED_TOL
    assert sorted(got.files) == sorted(want), name
    scale = _block_scales(want)
    for k in want:
        # v is the square: twice the gradients' share
        t = tol * (2 if k.startswith("v/") else 1)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= t * scale[_block(k)], \
            f"{shape} {name} {k}: {err} > {t} * {scale[_block(k)]}"
    for r, found in enumerate(results):
        rec = found[name]
        assert rec["grads_placed"], (r, name)
        for step, (g, w) in enumerate(zip(rec["metrics"], run["metrics"])):
            for k in ("loss", "grad_norm", "xent", "moe_aux", "lr"):
                t = SHARDED_TOL if step == 0 else STEPS_TOL
                if "param_dtype" in over and (step or k == "grad_norm"):
                    t = BF16_TOL        # from gradients rounded to bf16
                assert g[k] == pytest.approx(w[k], rel=t, abs=t), \
                    (r, name, step, k)
        assert rec["step"] == {"value": 2, "replicated": True,
                               "spec_replicated": True}
        for tree, share in rec["adamw"].items():
            # bf16 parameters are their master rounded: where the masters
            # differ in the last float32 bit, a rounding may part
            t = BF16_TOL if tree == "params" and "param_dtype" in over \
                else STATE_TOL
            assert share <= t, (r, name, rec["adamw"])


def _spec_shape(shape: tuple, spec, mesh: S.MeshShape) -> list:
    return [n // S.axis_size(mesh, axes) for n, axes in zip(shape, spec)]


@pytest.mark.parametrize("shape", list(LAUNCHES))
def test_every_local_shard_of_the_trained_state_has_its_specs_shape(
        trained, shape):
    results = _shape_results(trained, shape)
    mesh = S.MeshShape(LAUNCHES[shape], ("data", "model"))
    for arch, fsdp, over in _cases(shape):
        cfg = R.train_config(arch, over)
        specs = dict(S.flat_paths(S.param_specs(cfg, mesh, fsdp)))
        full = dict(S.flat_paths(S._param_shapes(cfg)))
        want = {k: _spec_shape(full[k], specs[k], mesh) for k in specs}
        keys = ["m", "v", "step"] + (["master"] if "param_dtype" in over
                                     else [])
        for r, found in enumerate(results):
            rec = found[R.case_name(arch, fsdp, over)]
            assert rec["opt_keys"] == sorted(keys), (r, arch, over)
            assert set(rec["local"]) == {"params", *keys} - {"step"}
            for tree, shapes in rec["local"].items():
                assert shapes == want, (r, arch, fsdp, over, tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_sharded_train_step_follows_the_reference(trained, shape, arch):
    """The first step's loss and every gradient leaf against
    ``jax.value_and_grad(train_loss)``, and both steps' loss and grad norm
    against the reference's ``make_train_step``."""
    name = R.case_name(arch, True, {})
    _, _, results, got = _case(trained, shape, name)
    ref = trained[1][arch]
    for k, w in ref["grads"].items():
        within(got[f"grads/{k}"], w, GRAD_TOL, f"{shape} {arch} grads/{k}")
    assert len(ref["grads"]) == sum(k.startswith("grads/")
                                    for k in got.files)
    for found in results:
        metrics = found[name]["metrics"]
        assert metrics[0]["loss"] == pytest.approx(
            ref["loss"], rel=LOSS_TOL, abs=LOSS_TOL)
        for g, w in zip(metrics, ref["metrics"]):
            for k in ("loss", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=STEPS_TOL,
                                             abs=STEPS_TOL), (arch, k)


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_sharded_prefetcher_keeps_each_ranks_slice_of_the_references_batches(
        trained, shape):
    results = _shape_results(trained, shape)
    d = trained[3] / shape
    mesh = S.MeshShape(SHAPES[shape], ("data", "model"))
    for arch in PREFETCHED:
        jcfg, tcfg = cfgs(arch)
        source = iter(JSource(jcfg, B, SEQ, seed=PREFETCH_SEED))
        specs = S.batch_specs(TC.batch_shapes(tcfg, SEQ, B, "train"), mesh)
        for i in range(2):
            batch = next(source)
            for r, found in enumerate(results):
                local = np.load(d / f"prefetch_rank{r}.npz")
                coords = found["prefetch"]["coords"]
                for k, v in batch.items():
                    rec = found["prefetch"]["placed"][f"{arch}|{i}|{k}"]
                    assert rec == {"same": True, "shape": list(v.shape)}
                    rows = v.shape[0] // S.axis_size(mesh, specs[k][0])
                    lo = coords[0] * rows if specs[k][0] else 0
                    assert np.array_equal(local[f"{arch}|{i}|{k}"],
                                          np.asarray(v)[lo:lo + rows]), \
                        (arch, i, k, r)


def test_a_checkpoint_saved_on_2x2_restores_on_other_meshes_and_unsharded(
        trained):
    for r, found in enumerate(_shape_results(trained, "2x2")):
        ck = found["checkpoint"]
        assert ck["written"]
        for name in ("4x1", "1x4"):
            assert ck[name] == {"step": 2, "equal": True, "placed": True}, \
                (r, name)
        assert ck["unsharded"] == {"step": 2, "equal": True}, r


def test_a_reference_checkpoint_restores_onto_a_mesh(trained):
    results = _shape_results(trained, "2x2")
    want = trained[4]
    got = np.load(trained[3] / "2x2" / "ref_restored.npz")
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    mesh = S.MeshShape((2, 2), ("data", "model"))
    cfg = R.train_config("zamba2-1.2b", {})
    specs = dict(S.flat_paths(S.param_specs(cfg, mesh)))
    full = dict(S.flat_paths(S._param_shapes(cfg)))
    for found in results:
        ref = found["checkpoint"]["ref"]
        assert ref["step"] == 7
        for k, spec in specs.items():
            for tree in ("0", "1/m", "1/v"):
                assert ref["local"][f"{tree}/{k}"] == _spec_shape(
                    full[k], spec, mesh), (tree, k)


def test_the_kernels_see_local_shards_of_the_local_heads(trained):
    """On (1, 4) with remat, the attention kernel's entry point runs twice
    per attention site (forward and remat's recompute) and its backward
    once, the SSD kernel's twice per Mamba2 layer and its backward once,
    each on plain tensors of the rank's heads."""
    cfg = TC.reduced(TC.get_config(SPIED))
    model = SHAPES["1x4"][1]
    sites = math.ceil(cfg.num_layers / cfg.attn_every)
    want = {"K3": (2 * sites, cfg.n_heads // model),
            "K3_bwd": (sites, cfg.n_heads // model),
            "K4": (2 * cfg.num_layers, cfg.ssm_spec.n_heads // model),
            "K4_bwd": (cfg.num_layers, cfg.ssm_spec.n_heads // model)}
    for r, found in enumerate(_shape_results(trained, "1x4")):
        spy = found["spy"]
        assert spy["finite"]
        for kind, (n, heads) in want.items():
            calls = [c for c in spy["calls"] if c["kind"] == kind]
            assert len(calls) == n, (r, kind, len(calls))
            assert all(not c["dtensor"] and c["heads"] == heads
                       for c in calls), (r, kind, calls)
