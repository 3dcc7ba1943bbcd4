"""Training launcher: a dense, MoE, SSM or hybrid LM at reduced (CPU) or
full width.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --reduced --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 3

The port of ``repro/launch/train.py``: the same flags, plus ``--device``
(default: the CUDA card). The weights are random, from seed 0 through a
``torch.Generator``; ``adamw(--lr)`` trains them on ``TokenPipeline``'s
synthetic corpus and the run checkpoints to ``--ckpt-dir``, resuming from
the latest checkpoint there.

Shapes: ``--reduced`` keeps the reference's 128 tokens × 4 sequences. At
full width the default is one card's share of the reference's
``TRAIN_4K``: sequences of 4096 tokens, as there, and a global batch of 4.
The reference's 256 sequences are spread over a 16 × 16 device mesh; one
card has neither the memory nor the time for them. ``--microbatches``
must divide the global batch (granite-moe's config asks for 8, jamba's
8). The VLM needs 3-D positions and the audio model frame embeddings in
their batches, which ``TokenPipeline`` does not make (nor does the
reference's): the launcher refuses both families.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.api import build
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized smoke)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if cfg.family in ("vlm", "audio"):
        ap.error(f"--arch {args.arch}: TokenPipeline makes no "
                 f"{'positions' if cfg.family == 'vlm' else 'frames'} for "
                 f"the {cfg.family} family")
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("train", args.seq_len or 128, args.batch or 4,
                            "train")
    else:
        shape = ShapeConfig("train", args.seq_len or 4096, args.batch or 4,
                            "train")
    bundle = build(cfg, device=device)
    pipe = TokenPipeline(cfg.vocab, shape.seq_len, shape.global_batch,
                         device=device)
    tc = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches or cfg.microbatches)
    trainer = Trainer(bundle, optim.adamw(args.lr), pipe, tc)
    trainer.run(torch.Generator(device=device).manual_seed(0))
    print(f"done: final loss {trainer.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
