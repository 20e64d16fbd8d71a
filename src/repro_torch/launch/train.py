"""Training launcher of the port, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --steps 50 [--reduced] [--backend cpu] [--batch 8 --seq 128] \\
      [--ckpt /tmp/ck.npz]

Unlike the reference launcher (whose ``--reduced`` is on by default and
cannot be turned off), ``--reduced`` here is a plain flag, off by default:
without it the configuration trains at its full published width, which
needs the card. ``--reduced --backend cpu`` runs the 2-layer, narrow
variant on the host.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core.backend import BACKENDS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the 2-layer, narrow smoke-test variant")
    ap.add_argument("--backend", choices=BACKENDS, default=BACKENDS[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    print(f"training {cfg.name} ({cfg.arch_type}), {cfg.num_layers}L "
          f"d={cfg.d_model}, batch={args.batch} seq={args.seq} on "
          f"{args.backend}")
    trainer = Trainer(cfg, args.batch, args.seq,
                      AdamWConfig(lr=args.lr, total_steps=args.steps),
                      ckpt_path=args.ckpt, backend=args.backend)
    try:
        trainer.restore()
        report = trainer.train(args.steps, log_every=10,
                               ckpt_every=args.ckpt_every)
    finally:
        trainer.close()
    print(f"done: loss {report.losses[0]:.4f} -> {report.final_loss:.4f}, "
          f"{report.mean_step_time*1e3:.0f} ms/step")


if __name__ == "__main__":
    main()
