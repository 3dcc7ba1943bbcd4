"""Quickstart: train a GA-MLP on a synthetic Cora-like graph with pdADMM-G,
then with the quantized pdADMM-G-Q, and compare the wire bytes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``. It runs on the CUDA card unless
``--device`` names another; the weights come from ``--seed`` through a
``torch.Generator`` (not the reference's ``jax.random`` numbers).
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.comm.codecs import codec_for_grid
from repro_torch.comm.ledger import admm_bytes_per_iteration
from repro_torch.core import pdadmm, quantize
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.graph.datasets import synthetic


def bytes_per_iter(cfg: ADMMConfig, dims, V: int) -> int:
    """Wire bytes of one iteration under the Fig-5 model, from the ledger."""
    return admm_bytes_per_iteration(
        dims, V, codec_for_grid(cfg.grid if cfg.quantize_p else None),
        codec_for_grid(cfg.grid if cfg.quantize_q else None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--scale", type=float, default=0.5,
                    help="size of the synthetic cora graph")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = synthetic("cora", scale=args.scale, device=device)
    X = ds.augmented(k_hops=4)         # Psi = {I, A~, A~^2, A~^3}
    dims = [X.shape[1], 100, 100, 100, ds.n_classes]

    print("== pdADMM-G ==")
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    _, hist = pdadmm.train(args.seed, X, ds.labels, ds.masks, dims, cfg,
                           epochs=args.epochs, device=device)
    print(f"objective {hist['objective'][0]:.2f} -> {hist['objective'][-1]:.2f}")
    print(f"residual  {hist['residual'][-1]:.2e}")
    print(f"test acc  {hist['test_acc'][-1]:.3f}")

    print("\n== pdADMM-G-Q (8-bit p & q) ==")
    cfg_q = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                       grid=quantize.uniform_grid(8, -2.0, 6.0))
    _, hist_q = pdadmm.train(args.seed, X, ds.labels, ds.masks, dims, cfg_q,
                             epochs=args.epochs, device=device)
    print(f"objective {hist_q['objective'][0]:.2f} -> "
          f"{hist_q['objective'][-1]:.2f}")
    print(f"test acc  {hist_q['test_acc'][-1]:.3f}")

    base = bytes_per_iter(cfg, dims, X.shape[0])
    qb = bytes_per_iter(cfg_q, dims, X.shape[0])
    print(f"comm bytes/iter: {base:.3e} -> {qb:.3e} "
          f"({100 * (1 - qb / base):.0f}% saved)")


if __name__ == "__main__":
    main()
