"""Run one function on ``world`` ranks, one fresh interpreter each.

The port's counterpart of JAX seeing every device from one process: a
DTensor program runs one process per rank. ``run(target, payload, world)``
starts ``world`` interpreters (``subprocess`` with ``sys.executable``,
never a fork of the caller), each of which joins one process group,
calls ``target(payload)`` and writes what it returns as JSON. The caller's
process makes no process group and changes none of its own state, so a
test process can launch ranks without touching its own interpreter.

 * ``target`` is ``"path/to/file.py:function"``; ``payload`` is a
   JSON-able dict, the same on every rank. The function reads its rank
   from ``torch.distributed`` and returns a JSON-able value.
 * The ranks meet through a ``file://`` store in a temporary directory: no
   port is opened for the rendezvous, so two launches at once cannot
   collide. ``device="cuda"`` (the default) takes NCCL, rank r on card
   ``r % count``; ``"cpu"`` takes gloo, one intra-op thread a rank.
 * Before it starts CUDA ranks, the caller builds every kernel
   (``kernels.build.build_all``), so no two ranks run ``nvcc`` on one
   library.
 * Every rank destroys its group and exits non-zero on any error; the
   launcher kills every rank at ``wall_s`` and raises if any rank failed,
   with the end of each failed rank's output.

Run as ``python -m repro_torch.launch.ranks --rank R ...`` it is one rank
(the launcher's own command line); importing it does nothing.
"""
from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

SRC = Path(__file__).resolve().parents[2]   # the directory holding the port
TAIL = 4000                                 # bytes of a failed rank's output


class RankError(RuntimeError):
    """A rank exited non-zero or was killed at the wall limit."""


def run(target: str, payload: dict, world: int, *, device: str = "cuda",
        wall_s: float = 600.0) -> list:
    """``target(payload)`` on ranks ``0 .. world - 1``; returns their
    results in rank order."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"ranks run on cpu or cuda, not {device!r}")
    if device == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        tmp = Path(tmp)
        (tmp / "payload.json").write_text(json.dumps(payload))
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(SRC)] + [p for p in child_env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        procs = []
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w+b")
            cmd = [sys.executable, "-m", "repro_torch.launch.ranks",
                   "--rank", str(r), "--world", str(world), "--dir", str(tmp),
                   "--target", target, "--device", device,
                   "--timeout", str(int(wall_s))]
            procs.append((subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           env=child_env), log))
        deadline = time.monotonic() + wall_s
        try:
            # wait for all, or for the first rank that fails (the others
            # would wait for it until their group's timeout)
            while time.monotonic() < deadline:
                codes = [p.poll() for p, _ in procs]
                if None not in codes or any(codes):
                    break
                time.sleep(0.05)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for r, (p, log) in enumerate(procs):
            log.seek(0)
            out = log.read().decode(errors="replace")
            log.close()
            if p.returncode != 0:
                why = ("killed" if p.returncode < 0
                       else f"exit code {p.returncode}")
                failed.append(f"rank {r}: {why}\n{out[-TAIL:]}")
        if failed:
            raise RankError(f"{len(failed)} of {world} ranks failed "
                            f"({target}):\n" + "\n".join(failed))
        return [json.loads((tmp / f"rank{r}.json").read_text())
                for r in range(world)]


def _resolve(target: str):
    path, name = target.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--timeout", type=int, default=600)
    a = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    d = Path(a.dir)
    if a.device == "cuda":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if a.device == "cuda" else "gloo",
        init_method=(d / "store").as_uri(), world_size=a.world, rank=a.rank,
        timeout=datetime.timedelta(seconds=a.timeout))
    try:
        result: Any = _resolve(a.target)(
            json.loads((d / "payload.json").read_text()))
        (d / f"rank{a.rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
