"""Time K3's bf16 kernels on the card with CUDA events, both directions.

For each shape (B, H, S, D), causal: the forward (``flash_attention_fwd``
without the logsumexp) over 20 launches, the same through the public
``flash_attention`` (its input checks and dispatch included, as the model
calls it; at small shapes the host's pace shows there) and the backward
(``flash_attention_bwd``) over 10, after a warm-up, and prints one JSON
line of mean ms per call, with the card's name and power limit.
``--root`` picks the checkout whose ``src/`` is imported (and whose
``build/kernels`` the kernels are built into), so that two versions can be
timed in turns in one call on one card. Needs a Hopper card; from the
repository root:

    python3 tools/time_attention.py --root build/parent 8,32,2048,64
    python3 tools/time_attention.py 8,32,2048,64 4,16,512,256
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def mean_ms(torch, fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="B,H,S,D")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout to time (default: this one)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_attention: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import repro_torch.kernels.flash_attention.flash_attention as K3
    from repro_torch.kernels import build
    build.build_all(("flash_attention", "flash_attention_bwd"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "card": card, "ms": {}}
    for text in args.shapes:
        shape = tuple(int(x) for x in text.split(","))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = K3.flash_attention_fwd(q, k, v)
        fwd = mean_ms(torch, lambda: K3.flash_attention_fwd(
            q, k, v, with_lse=False), 20)
        wrapped = mean_ms(torch, lambda: K3.flash_attention(q, k, v), 20)
        bwd = mean_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, o, lse, do), 10)
        out["ms"][text] = {"forward": fwd, "forward_wrapper": wrapped,
                           "backward": bwd}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
