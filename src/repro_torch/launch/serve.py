"""Serving launcher of the port: batched prefill + greedy decode requests
against one architecture, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --requests 8 --prompt-len 32 --gen 16 [--reduced] [--backend cpu]

``--arch`` takes every configuration the port registers
(``configs.base.ARCH_IDS``). A vlm prompt of ``--prompt-len`` positions is
``n_patches`` random vision embeddings followed by text tokens, so it must
be longer than ``n_patches`` (256 at full width, 16 reduced).

Unlike the reference launcher (whose ``--reduced`` is on by default and
cannot be turned off), ``--reduced`` here is a plain flag, off by default:
without it the configuration runs at its full published width.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, make_batch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core.backend import BACKENDS
from repro_torch.runtime.serving import GenerationServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the 2-layer, narrow smoke-test variant")
    ap.add_argument("--backend", choices=BACKENDS, default=BACKENDS[0])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.arch_type == "vlm" and args.prompt_len <= cfg.n_patches:
        ap.error(f"--prompt-len {args.prompt_len}: a {cfg.name} prompt "
                 f"starts with {cfg.n_patches} vision patches, so it must "
                 f"be longer than {cfg.n_patches} to hold text")
    max_seq = args.prompt_len + args.gen
    server = GenerationServer(cfg, max_seq=max_seq, bs=args.bs,
                              backend=args.backend)
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}) on {server.backend}: bs={args.bs}, prompt "
          f"{args.prompt_len}, gen {args.gen}")
    batches = (args.requests + args.bs - 1) // args.bs
    for i in range(batches):
        gen = torch.Generator().manual_seed(i)
        prompt = make_batch(cfg, args.prompt_len, args.bs, "prefill", gen)
        t0 = time.time()
        tokens = server.generate(prompt, steps=args.gen,
                                 prompt_len=args.prompt_len)
        dt = time.time() - t0
        print(f"batch {i}: {tokens.shape[0]}x{tokens.shape[1]} tokens in "
              f"{dt*1e3:.0f} ms ({tokens.shape[0]*tokens.shape[1]/dt:.1f} tok/s) "
              f"first seq: {tokens[0][:8].tolist()}")


if __name__ == "__main__":
    main()
