"""The dry run (``repro_torch.launch.dryrun``): sharded steps
measured at the probe depths, their collectives counted by kind and
extrapolated to the full depth, against the reference's
``repro.launch.dryrun``.

Four launches of gloo ranks through ``launch.ranks`` run at once (rank
programs in ``tests/torch_dryrun_ranks.py``): the production meshes (1, 4)
and (1, 1, 4), the host mesh (2, 2), and one rank (1, 1). On each mesh of
four ranks, a dense, an MoE, a hybrid and an SSM configuration, reduced,
take a train, a prefill and a decode step at the two probe depths, a third
depth and their full depth; the collective bytes at the last two must be
``_lin_extrapolate`` of the probes' exactly, kind by kind (the hybrid's
depths are multiples of ``attn_every``). At one rank every count is 0.
The (1, 4) launch also puts the reference's three collectives of
``tests/test_dryrun.py`` through DTensor and ``torch.distributed`` under
the counter, and the (2, 2) launch splits steps and sums the state bytes
of placed tensors.

The split (``split_rule``) is measured where a slice's activations
outweigh a layer's weights, as they do at the dry run's own sizes (32,768
tokens a slice): DTensor picks each op's strategy by its tensors' sizes,
and where a slice's activations are as small as the weights it may
gather activations in place of weights, so that halving a slice changes
which collectives a step issues (at d_model 256 and 32 tokens a row, the
FSDP all-gathers grow 1.17x, not 2x, from one slice to two).

The host-only tests hold the records' analytic keys and the variants'
configurations to the reference's, the split rule's choices on the
production and the reference's meshes, and ``main``'s keys, skips,
``--force`` and failure records (on one gloo rank, through ``main``'s
``device="cpu"`` and ``testing`` hooks).
"""
import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import base as TC
from repro_torch.launch import dryrun as DR
from repro_torch.launch import ranks
from repro_torch.models import sharding as S

ROOT = Path(__file__).resolve().parents[1]
RANKS = str(Path(__file__).with_name("torch_dryrun_ranks.py"))
WALL_S = 900        # a launch: ~2 min alone, longer beside other workers
MESHES = ("1x4", "2x2", "1x1x4")
KINDS = ("train", "prefill", "decode")
# [arch, full depth, a third depth]: a dense, an MoE, a hybrid (reduced:
# attn_every 2, probes 2 and 4) and an SSM configuration
ARCHS = {"qwen2.5-14b": (5, 3), "mixtral-8x22b": (5, 3),
         "zamba2-1.2b": (8, 6), "mamba2-780m": (5, 3)}
SIZES = {"train": [32, 4], "prefill": [32, 4], "decode": [48, 4]}
# the split: a dense prefill, a dense and an MoE train step, narrowed so a
# slice's activations outweigh the weights; 8 rows of 512 tokens, so 1, 2
# and 4 slices split evenly over the data axis of (2, 2)
SPLIT_CASES = [["qwen2.5-14b", "prefill"], ["qwen2.5-14b", "train"],
               ["mixtral-8x22b", "train"]]
SPLIT_NARROW = {"d_model": 64, "head_dim": 16, "d_ff": 128}
SPLIT_SIZES = {"train": [512, 8], "prefill": [512, 8]}
FIT_CASES = [["qwen2.5-14b", "train", True, "float32"],
             ["qwen2.5-14b", "train", True, "bfloat16"],
             ["mixtral-8x22b", "train", False, "bfloat16"],
             ["mixtral-8x22b", "decode", True, "float32"],
             ["zamba2-1.2b", "prefill", False, "bfloat16"],
             ["mamba2-780m", "decode", True, "float32"]]
FIT_SKIPPED = ["qwen2.5-14b", "train"]
# run_pair on four ranks: a reduced stablelm-1.6b at a tiny decode_32k
RUN_PAIR = {"arch": "stablelm-1.6b",
            "testing": {"config": {"num_layers": 4},
                        "shapes": {"decode_32k": [48, 4]}}}
# tests/test_dryrun.py:17-22, the reference's own parser test
REFERENCE_HLO = """
  %ag = bf16[32,1024]{1,0} all-gather(bf16[2,1024]{1,0} %x), replica_groups={}
  %ar.1 = f32[128]{0} all-reduce(f32[128]{0} %y), to_apply=%sum
  %rs = f32[8,16]{1,0} reduce-scatter(f32[128,16]{1,0} %z), dimensions={0}
  %nothing = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)
"""


@pytest.fixture(scope="module")
def reference():
    """``repro.launch.dryrun``, imported with the process's ``XLA_FLAGS``
    kept (the module sets it at import), and ``repro.configs.base``."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    import repro.configs.base as ref_base
    return ref, ref_base


def _linearity_cases(probes_only: bool = False) -> dict:
    return {"cases": [[a, k, full, third] for a, (full, third) in
                      ARCHS.items() for k in KINDS],
            "sizes": SIZES, "probes_only": probes_only}


@pytest.fixture(scope="module")
def launched():
    """The four launches, run at once; ``{launch: rank 0's results, or the
    error}`` (every rank returns the same record)."""
    launches = {
        "1x4": (4, {"programs": ["linearity", "convention", "run_pair"],
                    "linearity": {"mesh": "1x4", **_linearity_cases()},
                    "convention": {}, "run_pair": RUN_PAIR}),
        "2x2": (4, {"programs": ["linearity", "split", "fit"],
                    "linearity": {"mesh": "2x2", **_linearity_cases()},
                    "split": {"cases": SPLIT_CASES, "narrow": SPLIT_NARROW,
                              "sizes": SPLIT_SIZES},
                    "fit": {"cases": FIT_CASES, "sizes": SIZES,
                            "skipped": FIT_SKIPPED, "budget": 1e6}}),
        "1x1x4": (4, {"programs": ["linearity"],
                      "linearity": {"mesh": "1x1x4",
                                    **_linearity_cases()}}),
        "1x1": (1, {"programs": ["linearity"],
                    "linearity": {"mesh": "1x1",
                                  **_linearity_cases(probes_only=True)}}),
    }
    with concurrent.futures.ThreadPoolExecutor(len(launches)) as pool:
        futures = {name: pool.submit(ranks.run, f"{RANKS}:programs",
                                     payload, world, device="cpu",
                                     wall_s=WALL_S)
                   for name, (world, payload) in launches.items()}
        out = {}
        for name, f in futures.items():
            try:
                out[name] = f.result()
            except ranks.RankError as e:
                out[name] = e
    return out


def _results(launched, name: str) -> list:
    got = launched[name]
    if isinstance(got, Exception):
        raise got
    return got


def _program(launched, name: str, program: str) -> dict:
    results = _results(launched, name)
    assert all(r[program] == results[0][program] for r in results), \
        "the ranks' records differ"
    return results[0][program]


# ---------------------------------------------------------------------------
# the collective counter
# ---------------------------------------------------------------------------

def test_counter_convention_equals_the_reference(launched, reference):
    """An all-gather of a (2, 1024) bf16 shard counts its local input, an
    all-reduce of (128,) float32 its input, a reduce-scatter of a (128,
    16) float32 input its whole input: the bytes and counts of the
    reference's ``collective_bytes`` on the HLO of the same three ops."""
    ref, _ = reference
    want = ref.collective_bytes(REFERENCE_HLO)
    got = _program(launched, "1x4", "convention")["record"]
    for k in ref._COLLECTIVES:
        assert got[k] == want[k], k
        assert got["counts"][k] == want["counts"][k], k
    assert got["total"] == want["total"] == 2 * 1024 * 2 + 128 * 4 \
        + 128 * 16 * 4


def test_counter_counts_what_comm_debug_mode_counts(launched):
    conv = _program(launched, "1x4", "convention")
    assert conv["debug_total"] == sum(conv["record"]["counts"].values()) == 3
    assert sorted(conv["debug"].values()) == [1, 1, 1]


def test_counter_skips_a_group_of_one_rank(launched):
    solo = _program(launched, "1x4", "convention")["solo"]
    assert solo["total"] == 0
    assert sum(solo["counts"].values()) == 0


def test_counter_refuses_a_collective_it_cannot_map(launched):
    refused = _program(launched, "1x4", "convention")["refused"]
    assert refused is not None and "c10d::broadcast_" in refused


def test_counter_passes_every_other_op_through():
    """Outside any process group: ops run under the counter as without
    it, and nothing is counted."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    counter = DR.CollectiveCounter()
    with counter:
        y = (x @ x.T).softmax(-1).sum(0)
    assert torch.equal(y, (x @ x.T).softmax(-1).sum(0))
    assert counter.record()["total"] == 0


# ---------------------------------------------------------------------------
# linearity in depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", MESHES)
def test_collective_bytes_extrapolate_exactly(launched, mesh, arch, kind):
    """The bytes at a third depth and at the configuration's full depth
    are the probes' linear extrapolation, kind by kind, exactly; every
    rank counted the same."""
    got = _program(launched, mesh, "linearity")[f"{arch}|{kind}"]
    assert got["equal_over_ranks"]
    (l1, c1), (l2, c2) = sorted((int(d), c) for d, c in
                                got["probes"].items())
    assert (l1, l2) == DR._probe_depths(TC.reduced(TC.get_config(arch)))
    assert c2["all-reduce"] > c1["all-reduce"] > 0
    for depth, c in got["depths"].items():
        for k in DR._COLLECTIVES:
            want = DR._lin_extrapolate(c1[k], c2[k], l1, l2, int(depth))
            assert c[k] == want, (depth, k)
            assert c["counts"][k] == DR._lin_extrapolate(
                c1["counts"][k], c2["counts"][k], l1, l2, int(depth)), \
                (depth, k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_rank_counts_nothing(launched, arch, kind):
    got = _program(launched, "1x1", "linearity")[f"{arch}|{kind}"]
    for c in got["probes"].values():
        assert all(c[k] == 0 for k in DR._COLLECTIVES)
        assert all(v == 0 for v in c["counts"].values())


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [tuple(c) for c in SPLIT_CASES])
def test_split_repeats_only_what_a_forward_gathers(launched, arch, kind):
    """In n slices every kind's bytes are A + n W: what each slice moves
    once (W: weights gathered, gradients reduced) repeats, the rest (A:
    the activations' collectives) is unchanged in total. The FSDP weight
    all-gathers (FSDP on less FSDP off) are n times one slice's. A
    prefill's all-reduces (the tensor-parallel activations') are equal at
    every n; a train step's grow by its data-replicated gradients'
    all-reduce, once a microbatch."""
    split = _program(launched, "2x2", "split")

    def at(n, fsdp):
        return split[f"{arch}|{kind}|{n}|{fsdp}"]

    for fsdp in (True, False):
        for n in (1, 2, 4):
            assert at(n, fsdp)["split"][
                "microbatches" if kind == "train" else "chunks"] == n
        c = {n: at(n, fsdp)["collectives"] for n in (1, 2, 4)}
        for k in DR._COLLECTIVES:
            assert c[4][k] - c[2][k] == 2 * (c[2][k] - c[1][k]), (fsdp, k)
    fsdp_ag = {n: at(n, True)["collectives"]["all-gather"]
               - at(n, False)["collectives"]["all-gather"] for n in (1, 2, 4)}
    assert fsdp_ag[1] > 0
    assert fsdp_ag[2] == 2 * fsdp_ag[1] and fsdp_ag[4] == 4 * fsdp_ag[1]
    ar = [at(n, True)["collectives"]["all-reduce"] for n in (1, 2, 4)]
    if kind == "prefill":
        assert ar[0] == ar[1] == ar[2] > 0
    else:
        assert ar[1] - ar[0] > 0


@pytest.mark.parametrize("name,mesh,want", [
    ("train_4k", ((1, 4), ("data", "model")), {"microbatches": 32}),
    ("train_4k", ((1, 1, 4), ("pod", "data", "model")),
     {"microbatches": 32}),
    ("train_4k", ((16, 16), ("data", "model")), {"microbatches": 2}),
    ("prefill_32k", ((1, 4), ("data", "model")), {"chunks": 32}),
    ("prefill_32k", ((2, 16, 16), ("pod", "data", "model")), {"chunks": 1}),
    ("decode_32k", ((1, 4), ("data", "model")), {"chunks": 1}),
    ("long_500k", ((1, 4), ("data", "model")), {"chunks": 1}),
])
def test_split_rule(name, mesh, want):
    """The smallest power of two keeping a slice at or below 32,768 tokens
    a data rank, each slice split evenly over the data axes: train_4k is
    32 microbatches of 8 x 4,096 on the four-card host, 2 on the
    reference's 16 x 16 pod; prefill_32k 32 slices of one row; decode
    never splits."""
    shape = TC.INPUT_SHAPES[name]
    got = DR.split_rule(TC.get_config("qwen2.5-14b"), shape,
                        S.MeshShape(*mesh))
    assert {k: got[k] for k in want} == want
    if "tokens_per_data_rank" in got:
        assert got["tokens_per_data_rank"] <= DR.DRYRUN_CHUNK_TOKENS


def test_split_rule_takes_the_variants_microbatches():
    cfg = TC.get_config("qwen2.5-14b")
    shape = TC.INPUT_SHAPES["train_4k"]
    mesh = S.MeshShape((1, 4), ("data", "model"))
    got = DR.split_rule(cfg, shape, mesh, {"microbatches": 8})
    assert got == {"microbatches": 8, "by": "variant"}
    assert DR.split_rule(cfg, shape, mesh)["by"] == "rule"


@pytest.mark.parametrize("arch,mesh,want,columns", [
    # 100,352 columns on one card: 32,768 tokens hold 13.2 GB of logits
    ("stablelm-1.6b", (1, 1), 64, 100_352),
    ("stablelm-1.6b", (1, 4), 32, 100_352 // 4),
    ("qwen2.5-14b", (1, 1), 128, 153_600),
    ("qwen2.5-14b", (1, 4), 32, 153_600 // 4),
    # four codebooks of 2,048 columns a token
    ("musicgen-medium", (1, 1), 32, 4 * 2_048),
])
def test_split_rule_bounds_a_train_slices_logits(arch, mesh, want, columns):
    """A train slice also keeps its float32 logits (tokens a data rank x
    logit columns a model rank x 4 B) at or below DRYRUN_LOGITS_BYTES:
    the smallest power of two that keeps both bounds."""
    cfg = TC.get_config(arch)
    ms = S.MeshShape(mesh, ("data", "model"))
    got = DR.split_rule(cfg, TC.INPUT_SHAPES["train_4k"], ms)
    assert got["microbatches"] == want
    tokens = 256 // want * 4096
    assert got["tokens_per_data_rank"] == tokens
    assert got["logits_bytes"] == 4 * tokens * columns
    assert got["logits_bytes"] <= DR.DRYRUN_LOGITS_BYTES
    if want > 1:
        assert (8 * tokens * columns > DR.DRYRUN_LOGITS_BYTES
                or 2 * tokens > DR.DRYRUN_CHUNK_TOKENS)
    prefill = DR.split_rule(cfg, TC.INPUT_SHAPES["prefill_32k"], ms)
    assert "logits_bytes" not in prefill and prefill["chunks"] == 32


def test_run_pair_takes_the_production_mesh_at_four_ranks(launched):
    """At a world of four ``run_pair`` runs on ``make_production_mesh``:
    (1, 4) for the single mesh, (1, 1, 4) for the multi; at a world of
    one (``main``'s tests) on the host mesh (1, 1)."""
    got = _program(launched, "1x4", "run_pair")
    assert got == {"single": {"mesh": "1x4", "devices": 4, "ok": True},
                   "multi": {"mesh": "1x1x4", "devices": 4, "ok": True}}


# ---------------------------------------------------------------------------
# the fit rule
# ---------------------------------------------------------------------------

def _fit_keys():
    return [f"{a}|{k}|{f}|{d}|{mb}" for a, k, f, d in FIT_CASES
            for mb in ((1, 2) if k == "train" else (1,))]


@pytest.mark.parametrize("key", _fit_keys())
def test_state_bytes_are_the_placed_tensors_bytes(launched, key):
    """``state_bytes`` from the placements' shard shapes equals the local
    bytes of the tensors a rank of (2, 2) holds, term by term, and the
    same sum on a ``MeshShape`` (no process group)."""
    got = _program(launched, "2x2", "fit")[key]
    assert got["want"] == got["got"]
    arch, kind, fsdp, dtype, mb = key.split("|")
    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)), num_layers=2,
                              param_dtype=getattr(torch, dtype))
    seq, batch = SIZES[kind]
    host = DR.state_bytes(cfg, TC.InputShape(kind, seq, batch, kind),
                          S.MeshShape((2, 2), ("data", "model")),
                          fsdp == "True", int(mb))
    assert host == got["want"]


def test_a_pair_over_the_card_allocates_nothing(launched):
    got = _program(launched, "2x2", "fit")["skipped"]
    assert got["ok"] is False and got["calls"] == []
    assert got["probes"] == ["2"]
    assert got["skipped"]["probe"] == 2
    assert got["skipped"]["state_bytes"] > 0
    assert got["full"] == {"skipped": "probes skipped"}


def test_fit_rule_boundary():
    """A state of N bytes fits a budget of N + the reserve, not one byte
    less; the extrapolated peak, where given, is held the same way."""
    n = 10 ** 9
    assert DR._fits(n, n + DR.DRYRUN_RESERVE)
    assert not DR._fits(n, n + DR.DRYRUN_RESERVE - 1)
    assert not DR._fits(n, n + DR.DRYRUN_RESERVE, peak=n + 1)


@pytest.mark.parametrize("arch,shape,fits", [
    ("arctic-480b", "train_4k", False),   # ~27 B parameters at 2 layers
    ("qwen2.5-14b", "decode_32k", False),   # full cache ~824 GB
    ("qwen2.5-14b", "long_500k", True),   # the serve window's ring
])
def test_fit_rule_at_full_size(arch, shape, fits):
    """On the four-card host: Arctic's training probes and qwen2.5-14b's
    full-depth decode_32k cache do not fit a card; its long_500k ring
    buffer does."""
    cfg = TC.get_config(arch)
    if shape == "train_4k":
        cfg = dataclasses.replace(cfg, num_layers=2)
    need = DR.state_bytes(cfg, TC.INPUT_SHAPES[shape],
                          S.MeshShape((1, 4), ("data", "model")))
    assert DR._fits(need["total"], DR._budget()) is fits
    if arch == "qwen2.5-14b" and shape == "decode_32k":
        assert 4 * need["cache"] == pytest.approx(824e9, rel=0.01)


# ---------------------------------------------------------------------------
# records and variants against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(TC.INPUT_SHAPES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_analytic_keys_are_the_references(reference, arch, shape):
    """``model_flops``, ``param_count``, ``active_param_count`` and
    ``tokens`` of every configuration and input shape, by the reference's
    formulas (``run_pair``'s ``:197-201``)."""
    ref, ref_base = reference
    jcfg, jshape = ref_base.get_config(arch), ref_base.INPUT_SHAPES[shape]
    want = {"model_flops": ref.analytic_model_flops(jcfg, jshape),
            "param_count": jcfg.param_count(),
            "active_param_count": jcfg.active_param_count(),
            "tokens": jshape.global_batch * (
                jshape.seq_len if jshape.kind != "decode" else 1)}
    assert DR.analytic_record(TC.get_config(arch),
                              TC.INPUT_SHAPES[shape]) == want


VARIANTS = {"plain": {}, "bf16": {"param_dtype": "bf16"},
            "kv_quant": {"kv_quant": True},
            "pad_heads": {"pad_heads": 64},
            "all": {"param_dtype": "bf16", "kv_quant": True,
                    "pad_heads": 64, "microbatches": 4,
                    "fsdp_params": False}}


def _reference_variant(ref_base, arch: str, variant: dict):
    """The reference's ``run_pair`` configuration (``:151-161``)."""
    cfg = ref_base.get_config(arch)
    if variant.get("param_dtype") == "bf16":
        cfg = dataclasses.replace(cfg, param_dtype=jnp.bfloat16)
    if variant.get("kv_quant"):
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    if variant.get("pad_heads"):
        cfg = dataclasses.replace(cfg, n_heads=variant["pad_heads"],
                                  head_dim=cfg.resolved_head_dim)
    return cfg


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_variant_configs_are_the_references(reference, arch, variant):
    _, ref_base = reference
    jcfg = _reference_variant(ref_base, arch, VARIANTS[variant])
    tcfg = DR.pair_config(arch, VARIANTS[variant])
    for f in dataclasses.fields(jcfg):
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).removeprefix("torch.") == jnp.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert tcfg.param_count() == jcfg.param_count()


def test_the_module_sets_no_environment_variable():
    """The reference's module sets ``XLA_FLAGS`` at import; the port's sets
    nothing."""
    probe = ("import json, os; before = dict(os.environ); "
             "import repro_torch.launch.dryrun; "
             "print(json.dumps(dict(os.environ) == before))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert json.loads(out.stdout.strip().splitlines()[-1]) is True


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# main's test-only hook: reduced configurations and tiny shapes (one rank
# runs on the host mesh (1, 1))
TESTING = {"config": {"num_layers": 4},
           "shapes": {"decode_32k": [48, 2], "train_4k": [32, 4]}}
KEYS = ("arch", "shape", "mesh", "devices", "variant", "full", "probes",
        "extrapolated", "model_flops", "param_count", "active_param_count",
        "tokens", "ok")


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """``main`` on one gloo rank: two pairs under a tag, the same command
    again (both skipped), one pair ``--force``d, a pair that raises, and
    train_4k in 2 microbatches under another tag; the output after each
    command and the launches each made."""
    out = tmp_path_factory.mktemp("dryrun") / "dry.json"
    base = ["--mesh", "single", "--out", str(out), "--world", "1",
            "--reps", "1", "--tag", "t"]
    real, calls = ranks.run, []

    def spy(target, payload, world, **kw):
        calls.append((payload["arch"], payload["shape"],
                      set(json.loads(out.read_text())) if out.exists()
                      else set()))
        return real(target, payload, world, **kw)
    runs = {}
    ranks.run = spy
    try:
        for name, argv in (
                ("first", ["--arch", "stablelm-1.6b",
                           "--shape", "decode_32k,train_4k"]),
                ("again", ["--arch", "stablelm-1.6b",
                           "--shape", "decode_32k,train_4k"]),
                ("force", ["--arch", "stablelm-1.6b", "--shape",
                           "decode_32k", "--force"]),
                ("fails", ["--arch", "gpt-5", "--shape", "decode_32k"]),
                ("micro", ["--arch", "stablelm-1.6b", "--shape", "train_4k",
                           "--microbatches", "2", "--tag", "mb2"])):
            calls.clear()
            DR.main(base + argv, device="cpu", testing=TESTING)
            runs[name] = (json.loads(out.read_text()), list(calls))
    finally:
        ranks.run = real
    return runs


def test_main_writes_one_record_per_pair_with_the_references_keys(driven):
    results, calls = driven["first"]
    assert sorted(results) == ["stablelm-1.6b|decode_32k|single|t",
                               "stablelm-1.6b|train_4k|single|t"]
    # a flush after every pair: the second launch saw the first's record
    assert [c[2] for c in calls] == [set(),
                                     {"stablelm-1.6b|decode_32k|single|t"}]
    for rec in results.values():
        assert rec["ok"] is True
        assert set(KEYS) <= set(rec)
        assert rec["mesh"] == "1x1" and rec["devices"] == 1
        for probe in rec["probes"].values():
            assert probe["memory"]["peak_bytes"] is None     # gloo ranks
            assert len(probe["cost"]["step_ms_runs"]) == 1
            assert probe["collectives"]["total"] == 0
        assert set(rec["extrapolated"]) == {
            "step_ms", "peak_bytes", "collective_bytes",
            "collectives_by_kind"}
    train = results["stablelm-1.6b|train_4k|single|t"]
    assert train["tokens"] == 4 * 32
    cols = DR.pair_config("stablelm-1.6b", {}, TESTING).padded_vocab
    assert train["split"] == {"microbatches": 1, "by": "rule",
                              "tokens_per_data_rank": 128,
                              "logits_bytes": 4 * 128 * cols}


def test_main_skips_a_pair_already_ok(driven):
    first, _ = driven["first"]
    again, calls = driven["again"]
    assert calls == [] and again == first


def test_main_force_runs_a_pair_again(driven):
    first, _ = driven["first"]
    forced, calls = driven["force"]
    assert [c[:2] for c in calls] == [("stablelm-1.6b", "decode_32k")]
    key = "stablelm-1.6b|decode_32k|single|t"
    assert forced[key]["probes"] != first[key]["probes"]    # new timings
    other = "stablelm-1.6b|train_4k|single|t"
    assert forced[other] == first[other]


def test_main_records_a_failed_pair(driven):
    results, calls = driven["fails"]
    assert len(calls) == 1
    rec = results["gpt-5|decode_32k|single|t"]
    assert rec["ok"] is False
    assert set(rec) == {"arch", "shape", "mesh", "ok", "error"}
    assert rec["mesh"] == "single" and len(rec["error"]) <= 2000
    assert "unknown architecture" in rec["error"]
    assert len(results) == 3


def test_main_microbatches_keep_tokens_and_flops(driven):
    results, _ = driven["micro"]
    one = results["stablelm-1.6b|train_4k|single|t"]
    two = results["stablelm-1.6b|train_4k|single|mb2"]
    assert two["variant"] == {"microbatches": 2}
    assert two["split"] == {"microbatches": 2, "by": "variant"}
    for k in ("tokens", "model_flops", "param_count", "active_param_count"):
        assert two[k] == one[k]
    assert math.isfinite(two["extrapolated"]["step_ms"])
