"""Training launcher for the port; ``repro.launch.train`` with the same
flags and printed lines, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 200 --batch 8 --seq 64

It trains the config (``--reduced`` for the CPU) on the synthetic data
pipeline through ``ElasticRunner``: checkpoints every ``--ckpt-every``
steps under ``--ckpt-dir`` and resumes from the newest one there, so a
restarted run continues where it stopped. The JAX launcher builds a host
mesh over every device; the port trains on one device (the training
mesh is ROADMAP A17b). Parameters train unquantized: ``--quant`` other than none
is refused by the train step (``TypeError``), as in the JAX package.

The card is the default device. Without one the launcher exits with an
error unless ``--device cpu`` asks for the plain CPU path explicitly.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import resolve_device
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import ElasticRunner
from repro_torch.train.trainer import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--quant", default="none")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-task", default="copy", choices=["copy", "lm"])
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    tc = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        microbatches=args.microbatches, remat_policy=args.remat,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
        grad_compression=args.grad_compression)
    data = SyntheticDataset(cfg.vocab_size, args.seq, args.batch,
                            task=args.data_task, device=device)

    def init_fn():
        gen = torch.Generator(device=device)
        gen.manual_seed(tc.seed)
        params = model.init(gen, quant=args.quant)
        return params, opt.adamw_init(params)

    step_fn = make_train_step(model, tc, quant=args.quant)

    def on_step(step, metrics, dt):
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms",
                  flush=True)

    runner = ElasticRunner(tc, step_fn, init_fn, data, on_step=on_step)
    t0 = time.time()
    result = runner.run(args.steps)
    print(f"done: {result['step']} steps in {time.time()-t0:.1f}s, "
          f"final loss={float(result['metrics']['loss']):.4f}, "
          f"restarts={result['restarts']}")


if __name__ == "__main__":
    main()
