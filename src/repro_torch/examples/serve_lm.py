"""Serve an LM with batched requests through the continuous-batching
engine: 7 requests on 4 slots.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch ID] [--device cpu] [--full]

The port of ``examples/serve_lm.py``. It runs ``--arch``'s reduced config
(default tinyllama-1.1b: 2 layers, d 64) unless ``--full`` asks for the
published width (tinyllama: 22 layers, d 2048, 1.1 B parameters in
bf16), on the CUDA card unless ``--device`` names another. Any of
``configs.base.ARCH_IDS`` serves: mamba2-130m decodes from its SSM state,
jamba-v0.1-52b from its KV caches and SSM states, whisper-tiny against
zero cross K/V (the engine, like the reference's, never runs the
encoder). The weights are random, from seed 0 through a
``torch.Generator`` (not the reference's ``jax.random`` numbers).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.models.api import build
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of reduced()")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    bundle = build(cfg, device=device)
    params = bundle.init(torch.Generator(device=device).manual_seed(0))
    engine = ServingEngine(bundle, params, slots=4, max_len=128)

    requests = [Request(rid=i, prompt=[10 + i, 20 + i, 30 + i], max_new=12)
                for i in range(7)]          # 7 requests > 4 slots: queueing
    print(f"serving {len(requests)} requests on {engine.slots} slots "
          f"({cfg.name}, {bundle.n_params():,} parameters, {device}) ...")
    done = engine.run(requests)
    for rid in sorted(done):
        print(f"req {rid}: {done[rid]}")
    return done


if __name__ == "__main__":
    main()
