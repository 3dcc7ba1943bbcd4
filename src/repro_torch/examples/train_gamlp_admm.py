"""End-to-end example: pdADMM-G training of the paper's GA-MLP for a few
hundred iterations, with checkpoints and restart.

    PYTHONPATH=src python -m repro_torch.examples.train_gamlp_admm [--device cpu]
    # stop it mid-run, run it again: it resumes from the latest checkpoint

The port of ``examples/train_gamlp_admm.py``, with the same flags and
``--device`` (default: the CUDA card). ν, ρ, the FISTA steps and the default
number of epochs come from the paper's configuration
(``configs.gamlp_paper.GAMLP``). The 10 x 1000 GA-MLP on the augmented
feature width is the paper's Section V-C configuration (cora: |V| = 2485,
4 x 1433 inputs, about 15M parameters); ``--hidden 4000`` gives its large
variant. The weights come from a seeded ``torch.Generator``, not the
reference's ``jax.random`` numbers.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.gamlp_paper import GAMLP
from repro_torch.core import pdadmm
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.graph.datasets import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=GAMLP.epochs)
    ap.add_argument("--hidden", type=int, default=GAMLP.hidden)
    ap.add_argument("--layers", type=int, default=GAMLP.n_layers)
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_gamlp")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = synthetic(args.dataset, scale=args.scale, device=device)
    X = ds.augmented(GAMLP.k_hops)
    dims = [X.shape[1]] + [args.hidden] * (args.layers - 1) + [ds.n_classes]
    n_params = sum(dims[i] * dims[i + 1] + dims[i + 1]
                   for i in range(len(dims) - 1))
    print(f"dataset={ds.name} |V|={X.shape[0]} input={X.shape[1]} "
          f"params={n_params / 1e6:.1f}M device={device}")

    cfg = ADMMConfig(nu=GAMLP.nu, rho=GAMLP.rho,
                     fista_iters=GAMLP.fista_iters)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    state = pdadmm.init_state(0, X, dims, cfg, device=device)
    start = 0
    if mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["step"] + 1
        print(f"resumed from step {start}")

    t0 = time.time()
    for e in range(start, args.epochs):
        state, m = pdadmm.iterate(state, X, ds.labels, ds.masks["train"],
                                  cfg)
        if e % 10 == 0:
            print(f"epoch {e:4d} objective {float(m['objective']):.3e} "
                  f"residual {float(m['residual']):.3e} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if (e + 1) % args.ckpt_every == 0:
            mgr.save(e, tuple(state))
    acc = pdadmm.forward_accuracy(state, X, ds.labels, ds.masks["test"])
    print(f"final test accuracy: {float(acc):.3f}")


if __name__ == "__main__":
    main()
