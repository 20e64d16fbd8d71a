"""The port stands alone: it imports neither jax nor the JAX package, its
import touches no CUDA, and its default backend runs on the card or raises
— it never falls back to the CPU."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import backend as B
from repro_torch.core import simulate as S
from repro_torch.core.device_model import INFER_WORKLOADS
from repro_torch.core.powermode import PowerModeSpace

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "repro" or m.startswith("repro.")),
    "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.simulate" in got["modules"]
    assert "repro_torch.core.scheduler" in got["modules"]
    assert "repro_torch.core.fused_window" in got["modules"]
    assert "repro_torch.kernels.fulcrum.fused_window" in got["modules"]
    for name in ("pareto", "nn_model", "als", "baselines"):
        assert f"repro_torch.core.{name}" in got["modules"]
    assert got["foreign"] == []
    assert got["cuda_initialized"] is False


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+repro(\s|\.|,|$)"
    r"|from\s+repro(\s|\.))", re.M)


def test_no_source_of_the_port_names_jax_or_the_reference_in_an_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m.group(0).strip()
           for f in files for m in [_FORBIDDEN.search(f.read_text())] if m}
    assert bad == {}


def test_default_backend_needs_the_card_and_never_degrades():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        B.resolve_backend(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.simulate_batch(S.DeviceModel(), None, INFER_WORKLOADS["lstm"],
                         [PowerModeSpace().maxn()], [4],
                         [S.ArrivalTrace.uniform(20.0, 2.0)])
    assert B.resolve_backend("cpu") == "cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        B.resolve_backend("pallas")
