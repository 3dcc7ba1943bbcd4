"""Greedy layerwise training (paper Section III-B / V-F, strategy of [31]).

Counterpart of ``repro.core.greedy``. Train a shallow GA-MLP, then insert
more hidden layers before the output layer and continue, warm-starting
every existing layer's (W, b) and re-initializing the split variables
(p, z, q, u) by a forward pass, so the grown state starts self-consistent
(residual 0). Each stage runs ``pdadmm.iterate`` through
``pdadmm.run_chunked``; the layer count changes between stages, and
``iterate`` takes the layer-stacked path wherever the new list allows it.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import graphs, pdadmm
from repro_torch.core.pdadmm import ADMMConfig, ADMMState, relu


def grow(old: ADMMState, X, dims_new: Sequence[int], config: ADMMConfig,
         noise: Sequence) -> ADMMState:
    """Insert fresh hidden layers before the output layer; keep the trained
    ones. ``noise`` holds one [h, h] array per inserted layer (standard
    normal; ``greedy_train`` draws it): each inserted W is
    ``eye(h) + 1e-3 · noise`` formed in f32, as the reference forms it,
    then held in the state's dtype."""
    L_old = len(old.W)
    L_new = len(dims_new) - 1
    n_insert = L_new - L_old
    if len(noise) != n_insert:
        raise ValueError(f"grow: {n_insert} layers to insert, "
                         f"{len(noise)} noise arrays")
    device, dtype = old.W[0].device, old.W[0].dtype
    W = list(old.W[:-1])
    b = list(old.b[:-1])
    h = dims_new[L_old - 1]
    for e in noise:
        # identity insert (+ tiny noise to break symmetry): inputs are
        # post-ReLU (>= 0), so ReLU(I x) = x and the grown network starts as
        # exactly the trained shallow function
        e = torch.as_tensor(e, dtype=torch.float32).to(device)
        W.append((torch.eye(h, dtype=torch.float32, device=device)
                  + 1e-3 * e).to(dtype))
        b.append(torch.zeros((h,), dtype=dtype, device=device))
    W.append(old.W[-1])
    b.append(old.b[-1])

    # forward-consistent re-init of (p, z, q, u); with quantize_p, p[l+1]
    # and q[l] are one projected tensor, as in pdadmm.init_state
    p, z, q, u = [X], [], [], []
    cur = X
    for l in range(L_new):
        zl = cur @ W[l] + b[l]
        z.append(zl)
        if l < L_new - 1:
            ql = relu(zl)
            if config.quantize_p and config.grid is not None:
                ql = config.grid.project(ql)
            q.append(ql)
            p.append(ql)
            u.append(torch.zeros_like(ql))
            cur = ql
    tau = [torch.tensor(config.tau0, dtype=torch.float32, device=device)
           for _ in range(L_new)]
    theta = [torch.tensor(config.tau0, dtype=torch.float32, device=device)
             for _ in range(L_new)]
    return ADMMState(p, W, b, z, q, u, tau, theta)


def greedy_train(seed, X, labels, masks, hidden: int, n_classes: int,
                 schedule: Sequence[int], epochs_per_stage: int,
                 config: ADMMConfig, *, device=None,
                 state: Optional[ADMMState] = None,
                 noise: Optional[Sequence] = None, callback=None,
                 jit: bool = True):
    """schedule: layer counts, e.g. (2, 5, 10). Returns (state, history).

    ``seed`` (an int or a CPU ``torch.Generator``) draws the first stage's
    ``init_state`` and then, at each growth, the inserted layers' noise,
    on the CPU. ``state`` replaces the first stage's initial state and
    ``noise`` (one list of [h, h] arrays per growth) the drawn noise, so a
    caller can hand the reference's numbers over. The metrics reach the
    host once per ``run_chunked`` chunk; ``history["stage_seconds"]`` is the
    host time of each stage's iterations, ending in that copy (a device
    sync). ``callback(stage, state)`` runs after each stage's iterations.

    ``jit`` is ``run_chunked``'s: on the card each stage captures one CUDA
    graph (the layer count changes the signature) and its
    ``stage_seconds`` include that capture; the stage's graph is freed
    once its iterations end."""
    device = resolve_device(device)
    X, labels = X.to(device), labels.to(device)
    masks = {k: m.to(device) for k, m in masks.items()}
    gen = pdadmm._generator(seed)
    hist = {"objective": [], "residual": [], "stage_layers": [],
            "val_acc": [], "test_acc": [], "stage_seconds": []}

    def step(s, *args):
        return pdadmm.iterate(s, *args, config=config)

    for si, L in enumerate(schedule):
        dims = [X.shape[1]] + [hidden] * (L - 1) + [n_classes]
        if si == 0:
            if state is None:
                state = pdadmm.init_state(gen, X, dims, config, device=device)
        else:
            n_insert = L - len(state.W)
            stage_noise = (noise[si - 1] if noise is not None else
                           [torch.randn((hidden, hidden), generator=gen,
                                        dtype=torch.float32)
                            for _ in range(n_insert)])
            state = grow(state, X, dims, config, stage_noise)
        t0 = time.perf_counter()
        state, ms = pdadmm.run_chunked(step, state,
                                       (X, labels, masks["train"]),
                                       epochs_per_stage, jit=jit)
        hist["stage_seconds"].append(time.perf_counter() - t0)
        graphs.release(step)    # the next stage has other dims
        hist["objective"] += [float(x) for x in ms.get("objective", [])]
        hist["residual"] += [float(x) for x in ms.get("residual", [])]
        hist["stage_layers"] += [L] * epochs_per_stage
        if callback is not None:
            callback(si, state)
        hist["val_acc"].append(float(pdadmm.forward_accuracy(
            state, X, labels, masks["val"])))
        hist["test_acc"].append(float(pdadmm.forward_accuracy(
            state, X, labels, masks["test"])))
    return state, hist
