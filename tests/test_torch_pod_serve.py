"""The pod layer's serving half: the port's sharded prefill and decode
steps (``launch.steps.sharded_step``) on DTensor meshes, against its own
unsharded steps and the reference's greedy tokens.

The ten configurations run reduced, in float32, FSDP on and off, on the
(data, model) meshes (1, 4), (2, 2) and (4, 1): one launch of four gloo
ranks per mesh shape through ``launch.ranks``, each running every case of
its shape (``torch_pod_ranks.serve_cases``). This process makes no
process group: it draws the parameters and prompts with NumPy (every leaf,
as ``test_torch_families.numpy_params`` draws them, at the scales of the
port's own initialisation), hands them to the ranks in a file, and
meanwhile runs the reference's ``prefill`` / ``decode_step`` (jitted,
float32 caches) and the port's unsharded steps from the same parameters.

Each case is a prompt of ``P`` positions at batch ``B`` and ``N`` greedy
decode steps. Tolerances: the sharded logits at every step and the
gathered prefill and final caches within 1e-5 of the largest |value| of
the port's unsharded steps (reductions split over ranks reorder float32
sums); the port's unsharded logits within the families tests' 1e-4 of the
reference's; the ranks' greedy tokens equal the reference's. Every rank's
local parameter and cache shards have the shapes their ``Spec`` gives.

A world-8 launch builds the multi-pod production mesh, draws one reduced
tree piece by piece on it (``init_sharded_params``) and holds it bitwise
against the whole tree distributed, and hands every kernel wrapper a
DTensor, which each refuses. ``_logits_spec`` is held against the
reference's on ``AbstractMesh`` here, with no group.
"""
import concurrent.futures
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.launch import steps as RST
from repro.models import model as JM
from repro_torch.configs import base as TC
from repro_torch.convert import model_params
from repro_torch.launch import ranks
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models import sharding as S
from test_torch_families import cfgs, numpy_batch, within

RANKS = str(Path(__file__).with_name("torch_pod_ranks.py"))
SHAPES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
ARCHS = TC.ARCH_IDS
B, P, N = 4, 40, 4              # batch, prompt positions, decode steps
SHARDED_TOL, REF_TOL = 1e-5, 1e-4
WALL_S = 480        # a launch: ~30 s alone, ~120 s beside five other workers


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def _numpy_params(cfg, seed: int) -> dict:
    """A reference parameter tree (layers stacked) with every leaf drawn by
    NumPy: matrices normal at the scale of the port's own draw, biases N(0,
    0.1), norm scales and ``D`` 1 + N(0, 0.1), ``A_log`` log U(1, 16),
    ``dt_bias`` the inverse softplus of log-uniform dt in [1e-3, 0.1]."""
    rng = np.random.default_rng(seed)
    own = TM.init_params(cfg, torch.Generator().manual_seed(seed))

    def draw(path: str, t: torch.Tensor) -> np.ndarray:
        last, shape = path.rsplit("/", 1)[-1], tuple(t.shape)
        if last == "A_log":
            out = np.log(rng.uniform(1.0, 16.0, shape))
        elif last == "dt_bias":
            out = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3),
                                                     np.log(0.1), shape))))
        elif last in ("scale", "D"):
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif last in ("bias", "b", "conv_b"):
            out = 0.1 * rng.standard_normal(shape)
        else:
            out = rng.standard_normal(shape) * float(t.std())
        return out.astype(np.float32)

    tree = S.map_with_path(draw, {k: v for k, v in own.items()
                                  if k != "layers"})
    layers = [S.map_with_path(draw, lp) for lp in own["layers"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return np.stack(leaves)
    tree["layers"] = stack(*layers)
    return tree


def _greedy(logits: np.ndarray, vocab: int) -> np.ndarray:
    return np.argmax(np.asarray(logits)[..., :vocab], axis=-1).astype(
        np.int32)


def _cache_leaves(cache) -> dict:
    out = {}
    S.map_with_path(lambda p, t: out.__setitem__(p, t.numpy().copy()),
                    cache)
    return out


def _unsharded(arch: str, ptree: dict, prompt: dict) -> dict:
    """The reference's greedy run and the port's unsharded steps fed the
    reference's tokens."""
    jcfg, tcfg = cfgs(arch)
    jp = jax.tree.map(jnp.asarray, ptree)
    tp = model_params(ptree, tcfg)
    jlog, jc = jax.jit(JM.prefill, static_argnums=(2, 3, 4))(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()}, jcfg, P + N,
        jnp.float32)
    tlog, tc = TM.prefill(tp, {k: torch.from_numpy(v)
                               for k, v in prompt.items()}, tcfg, P + N,
                          cache_dtype=torch.float32)
    run = {"jlogits": [np.asarray(jlog)], "tlogits": [tlog.numpy()],
           "prefill": _cache_leaves(tc), "tokens": []}
    jdec = jax.jit(JM.decode_step, static_argnums=4)
    for step in range(N):
        tok = _greedy(jlog, tcfg.vocab_size)
        run["tokens"].append(tok)
        pos = np.full((B,), P + step, np.int32)
        jlog, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)},
                        jnp.asarray(pos), jcfg)
        tlog, tc = TM.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                                  torch.from_numpy(pos), tcfg)
        run["jlogits"].append(np.asarray(jlog))
        run["tlogits"].append(tlog.numpy())
    run["decode"] = _cache_leaves(tc)
    return run


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Starts the three launches, runs the unsharded steps meanwhile, and
    returns ``(unsharded runs, {shape: rank results or the error}, out
    dir)``."""
    d = tmp_path_factory.mktemp("pod_serve")
    flat, trees, prompts = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = cfgs(arch)
        trees[arch] = _numpy_params(tcfg, 60 + i)
        prompts[arch] = numpy_batch(tcfg, 80 + i, b=B, s=P, kind="prefill")
        flat.update({f"{arch}|param|{k}": v
                     for k, v in _flat(trees[arch]).items()})
        flat.update({f"{arch}|batch|{k}": v
                     for k, v in prompts[arch].items()})
    np.savez(d / "inputs.npz", **flat)
    cases = [[arch, fsdp] for arch in ARCHS for fsdp in (True, False)]
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {}
        for name, shape in SHAPES.items():
            (d / name).mkdir()
            payload = {"shape": list(shape), "inputs": str(d / "inputs.npz"),
                       "batch": B, "prompt": P, "steps": N, "cases": cases,
                       "out": str(d / name)}
            futures[name] = pool.submit(ranks.run, f"{RANKS}:serve_cases",
                                        payload, math.prod(shape),
                                        device="cpu", wall_s=WALL_S)
        runs = {arch: _unsharded(arch, trees[arch], prompts[arch])
                for arch in ARCHS}
        results = {}
        for name, f in futures.items():
            try:
                results[name] = f.result()
            except ranks.RankError as e:
                results[name] = e
    return runs, results, d


def _shape_results(served, shape: str):
    results = served[1][shape]
    if isinstance(results, Exception):
        raise results
    return results


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_steps_match_the_unsharded_ones(served, shape, arch, fsdp):
    runs, _, d = served
    results = _shape_results(served, shape)
    run = runs[arch]
    got = np.load(d / shape / f"{arch}-{fsdp}.npz")
    for step in range(N + 1):
        within(got[f"logits{step}"], run["tlogits"][step], SHARDED_TOL,
               f"{shape} {arch} logits {step}")
    for when in ("prefill", "decode"):
        assert sorted(k for k in got.files if k.startswith(when)) == \
            sorted(f"{when}/{k}" for k in run[when])
        for k, want in run[when].items():
            assert got[f"{when}/{k}"].shape == want.shape, (when, k)
            within(got[f"{when}/{k}"], want, SHARDED_TOL,
                   f"{shape} {arch} {when} cache {k}")
    for r, found in enumerate(results):
        assert np.array_equal(np.asarray(found[f"{arch}|{fsdp}"]["tokens"]),
                              np.asarray(run["tokens"])), (r, arch)


def _spec_shape(shape: tuple, spec, mesh: S.MeshShape) -> list:
    return [n // S.axis_size(mesh, axes) for n, axes in zip(shape, spec)]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_local_shard_has_its_specs_shape(served, shape):
    results = _shape_results(served, shape)
    mesh = S.MeshShape(SHAPES[shape], ("data", "model"))
    for arch in ARCHS:
        cfg = TC.reduced(TC.get_config(arch))
        for fsdp in (True, False):
            specs = dict(S.flat_paths(S.param_specs(cfg, mesh, fsdp)))
            full = dict(S.flat_paths(S._param_shapes(cfg)))
            cache_specs, cache_shapes = {}, {}
            S.map_with_path(cache_specs.__setitem__,
                            S.cache_specs(cfg, mesh, B, P + N))
            S.map_with_path(lambda p, t: cache_shapes.__setitem__(
                p, tuple(t.shape)), TM.init_cache(cfg, B, P + N,
                                                  dtype=torch.float32,
                                                  device="meta"))
            want = {k: _spec_shape(full[k], specs[k], mesh) for k in specs}
            want_cache = {k: _spec_shape(cache_shapes[k], cache_specs[k],
                                         mesh) for k in cache_specs}
            for r, found in enumerate(results):
                got = found[f"{arch}|{fsdp}"]["shapes"]
                assert got["params"] == want, (r, arch, fsdp)
                assert got["prefill"] == want_cache, (r, arch, fsdp)
                assert got["decode"] == want_cache, (r, arch, fsdp)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_port_unsharded_follows_the_reference(served, arch):
    """The reference's greedy run the ranks' tokens are held to: the port's
    unsharded logits within 1e-4 at every step."""
    run = served[0][arch]
    for step, (t, j) in enumerate(zip(run["tlogits"], run["jlogits"])):
        within(t, j, REF_TOL, f"{arch} step {step}")


@pytest.fixture(scope="module")
def multi_pod():
    """One eight-rank launch on the multi-pod mesh (2, 1, 4)."""
    return ranks.run(f"{RANKS}:place_multi_pod", {"arch": "zamba2-1.2b"}, 8,
                     device="cpu", wall_s=WALL_S)


def test_the_multi_pod_mesh_places_a_tree_drawn_piece_by_piece(multi_pod):
    arch, results = "zamba2-1.2b", multi_pod
    mesh = S.MeshShape((2, 1, 4), ("pod", "data", "model"))
    cfg = TC.reduced(TC.get_config(arch))
    specs = dict(S.flat_paths(S.param_specs(cfg, mesh)))
    full = dict(S.flat_paths(S._param_shapes(cfg)))
    want = {k: _spec_shape(full[k], specs[k], mesh) for k in specs}
    # the FSDP axes (pod, data) split the embedding's d over both pods
    assert specs["embed/table"] == S.Spec("model", ("pod", "data"))
    assert want["embed/table"] == [cfg.padded_vocab // 4, cfg.d_model // 2]
    for found in results:
        assert found["mesh"] == [[2, 1, 4], ["pod", "data", "model"]]
        assert found["paths"] and found["differ"] == []
        assert found["shapes"] == want
        for name, msg in found["refused"].items():
            assert msg is not None and msg.startswith("TypeError") and \
                "DTensor" in msg and name in msg, (name, msg)
    assert len(results[0]["refused"]) == 8


def test_a_bf16_split_contraction_sums_its_bf16_partials_in_float32(
        multi_pod):
    """The four ranks of a pod each multiply their slice of the contracted
    dim on bf16 operands; the partials are summed in float32 and rounded
    to bf16 once (a bf16 sum would round each partial sum on this
    input)."""
    got = [r["bf16_product"] for r in multi_pod]
    parts = [torch.tensor(r["partial"], dtype=torch.float64)
             for r in got[:4]]
    # four bf16 values sum exactly in float32 here, in any order
    want = sum(parts).bfloat16()
    in_bf16 = parts[0].bfloat16()
    for part in parts[1:]:
        in_bf16 = in_bf16 + part.bfloat16()
    assert not torch.equal(in_bf16, want)
    for r in got:
        assert r["dtype"] == "torch.bfloat16"
        assert r["replicated"] == [True, True, True]
        assert torch.equal(torch.tensor(r["y"]).bfloat16(), want)


MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("batch", [1, 4, 128])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logits_spec_is_the_references(mesh, batch):
    sizes, names = MESHES[mesh]
    jmesh, tmesh = AbstractMesh(sizes, names), S.MeshShape(sizes, names)
    from repro.configs import get_config as j_get_config
    for arch in ARCHS:
        want = RST._logits_spec(j_get_config(arch), jmesh, batch)
        got = TS._logits_spec(TC.get_config(arch), tmesh, batch)
        assert isinstance(want, PartitionSpec)
        assert tuple(got) == tuple(want), (arch, got, want)


def test_placements_follow_the_spec_in_the_meshs_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = S.MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert S.placements(S.Spec("model", ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    assert S.placements(S.Spec(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        S.placements(S.Spec(("data", "pod")), mesh)
    # an axis of size 1 splits nothing: it replicates
    one = S.MeshShape((2, 1, 4), ("pod", "data", "model"))
    assert S.placements(S.Spec("model", ("pod", "data")), one) == \
        (Shard(1), Replicate(), Shard(0))
