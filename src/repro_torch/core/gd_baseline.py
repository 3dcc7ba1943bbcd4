"""Backpropagation baselines for GA-MLP (the paper's comparison methods):
full-batch GD / Adadelta / Adagrad / Adam on the same model and data.

Counterpart of ``repro.core.gd_baseline``. Gradients come from
``torch.func`` (the reference's ``jax.value_and_grad``); the MLP's products
are plain ``torch.matmul`` with TF32 off, as the reference's are plain
``@`` outside any Pallas kernel, so no port kernel runs here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pdadmm import _generator
from repro_torch.train import optim as O


def init_mlp(seed, dims: Sequence[int], *, device=None):
    """He-normal weights and zero biases, ``{"W": [...], "b": [...]}``.
    ``seed`` is an int or a CPU ``torch.Generator``; the weights are drawn
    on the CPU and moved, as ``pdadmm.init_state`` draws them (not the
    reference's ``jax.random`` numbers: tests hand those over through
    ``core.interop.mlp_params_from_numpy``)."""
    device = resolve_device(device)
    gen = _generator(seed)
    Ws = [(torch.randn((dims[i], dims[i + 1]), generator=gen,
                       dtype=torch.float32)
           * float(np.sqrt(2.0 / dims[i]))).to(device)
          for i in range(len(dims) - 1)]
    bs = [torch.zeros((dims[i + 1],), dtype=torch.float32, device=device)
          for i in range(len(dims) - 1)]
    return {"W": Ws, "b": bs}


def mlp_logits(params, X):
    h = X
    L = len(params["W"])
    for l in range(L - 1):
        h = torch.clamp(h @ params["W"][l] + params["b"][l], min=0.0)
    return h @ params["W"][L - 1] + params["b"][L - 1]


def masked_ce(params, X, labels, mask):
    logits = mlp_logits(params, X)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(params, X, labels, mask):
    pred = torch.argmax(mlp_logits(params, X), dim=-1)
    return ((pred == labels.long()) * mask).sum() / torch.clamp(mask.sum(),
                                                                min=1.0)


OPTIMIZERS = {"gd": O.gd, "adadelta": O.adadelta, "adagrad": O.adagrad,
              "adam": O.adam}


def train_gd(seed, X, labels, masks, dims, method: str, lr: float,
             epochs: int, *, device=None, params=None):
    """Full-batch training of the MLP ``dims`` on the train mask for
    ``epochs`` steps of ``method``. Starts from ``params`` when given
    (e.g. the reference's, through ``interop.mlp_params_from_numpy``), else
    from ``init_mlp(seed, dims)``. The per-epoch losses stay on the device
    and reach the host once, at the end. Returns (params, history)."""
    device = resolve_device(device)
    X, labels = X.to(device), labels.to(device)
    masks = {k: m.to(device) for k, m in masks.items()}
    if params is None:
        params = init_mlp(seed, dims, device=device)
    opt = OPTIMIZERS[method](lr)
    state = opt.init(params)
    value_and_grad = torch.func.grad_and_value(masked_ce)

    losses = []
    for _ in range(epochs):
        grads, loss = value_and_grad(params, X, labels, masks["train"])
        params, state = opt.update(grads, state, params)
        losses.append(loss)
    hist = {"loss": (torch.stack(losses).cpu().tolist() if losses else [])}
    with torch.no_grad():
        hist["val_acc"] = float(accuracy(params, X, labels, masks["val"]))
        hist["test_acc"] = float(accuracy(params, X, labels, masks["test"]))
    return params, hist
