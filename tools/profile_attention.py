"""Device time of each of K3's bf16 kernels on the card, by kernel name.

Runs the forward (``flash_attention_fwd``) and the backward
(``flash_attention_bwd``) five times under ``torch.profiler`` at the
serving shape (8, 32, 2048, 64), the training shape (4, 32, 512, 64), a
D = 128 shape (2, 16, 2048, 128), stablelm-12b's prefill at D = 160
(4, 32, 512, 160) and the dense block's prefills at phi-3-mini's head dim
96 (4, 32, 512, 96) and gemma-7b's 256 (4, 16, 512, 256), causal, and
prints the mean device ms per launch of every kernel: the forward, the
row-vector pass, the dK/dV pass (a dV and a dK launch at D = 96, 160 and
256) and the dQ pass. Needs a Hopper card; from the
repository root:

    python3 tools/profile_attention.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.kernels.flash_attention.flash_attention as K3  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SHAPES = ((8, 32, 2048, 64), (4, 32, 512, 64), (2, 16, 2048, 128),
          (4, 32, 512, 160), (4, 32, 512, 96), (4, 16, 512, 256))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_attention: needs a CUDA card", file=sys.stderr)
        return 2
    build.build_all(("flash_attention", "flash_attention_bwd"))
    print(torch.cuda.get_device_name(0))
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = K3.flash_attention_fwd(q, k, v)
        K3.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                K3.flash_attention_fwd(q, k, v)
                K3.flash_attention_bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
        print(shape)
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if us > 0:
                print("   %-50s %8.3f ms x %d"
                      % (e.key[:50], us / 1e3 / e.count, e.count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
