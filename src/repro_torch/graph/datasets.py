"""Synthetic benchmark graphs matching the paper's Table II statistics.

Counterpart of ``repro.graph.datasets``: the same numpy generator, so the
same seed gives the same labels, masks, edges and features as the JAX
package. Only the final conversion differs (torch tensors on ``device``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.ops import (Graph, augment_features,
                                   renormalized_adjacency, row_normalize)

# name: (nodes, edges, classes, features, train, val, test)  — paper Table II
TABLE_II = {
    "cora": (2485, 10556, 7, 1433, 140, 500, 1000),
    "pubmed": (19717, 88648, 3, 500, 60, 500, 1000),
    "citeseer": (2110, 9104, 6, 3703, 120, 500, 1000),
    "amazon_computers": (13381, 491722, 10, 767, 200, 1000, 1000),
    "amazon_photo": (7487, 238162, 8, 745, 160, 1000, 1000),
    "coauthor_cs": (18333, 163788, 15, 6805, 300, 1000, 1000),
    "coauthor_physics": (34493, 495924, 5, 8415, 100, 1000, 1000),
    "flickr": (89250, 899756, 7, 500, 44625, 22312, 22312),
    "ogbn_arxiv": (169343, 1166243, 40, 128, 90941, 29799, 48603),
}


@dataclasses.dataclass
class Dataset:
    name: str
    graph: Graph
    features: torch.Tensor   # [V, d] float32
    labels: torch.Tensor     # [V] int32
    masks: Dict[str, torch.Tensor]
    n_classes: int

    def augmented(self, k_hops: int = 4) -> torch.Tensor:
        return augment_features(self.graph, self.features, k_hops)


def _finish(name, V, src, dst, feats, labels, masks, C, device) -> Dataset:
    g = renormalized_adjacency(V, src, dst, device=device)
    return Dataset(
        name, g, row_normalize(torch.from_numpy(feats).to(device)),
        torch.from_numpy(np.asarray(labels, np.int32)).to(device),
        {k: torch.from_numpy(m).to(device) for k, m in masks.items()}, C)


def synthetic(name: str, seed: int = 0, scale: float = 1.0, *,
              device=None) -> Dataset:
    """SBM graph with Table II statistics (optionally scaled down)."""
    device = resolve_device(device)
    V, E, C, D, n_tr, n_va, n_te = TABLE_II[name]
    V, E = max(int(V * scale), 8 * C), int(E * scale)
    n_tr = min(int(n_tr * scale) or C * 2, V // 2)
    n_va = min(int(n_va * scale) or C, (V - n_tr) // 2)
    n_te = min(int(n_te * scale) or C, V - n_tr - n_va)
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, C, size=V)
    # class-assortative edges: 75% intra-class, 25% random
    n_intra = int(0.75 * E)
    order = np.argsort(labels, kind="stable")
    sorted_lab = labels[order]
    starts = np.searchsorted(sorted_lab, np.arange(C))
    ends = np.searchsorted(sorted_lab, np.arange(C), side="right")
    src_i = rng.integers(0, V, size=n_intra)
    lab_i = labels[src_i]
    span = np.maximum(ends[lab_i] - starts[lab_i], 1)
    dst_i = order[starts[lab_i] + rng.integers(0, 1 << 30, size=n_intra) % span]
    src_r = rng.integers(0, V, size=E - n_intra)
    dst_r = rng.integers(0, V, size=E - n_intra)
    src = np.concatenate([src_i, src_r])
    dst = np.concatenate([dst_i, dst_r])

    # sparse class-dependent bag-of-words features
    sig = min(32, D)
    means = rng.normal(0, 1.0, size=(C, sig))
    feats = np.zeros((V, D), np.float32)
    cols = rng.integers(0, D, size=(C, sig))
    noise = rng.normal(0, 1.0, size=(V, sig)).astype(np.float32)
    for c in range(C):
        rows = np.where(labels == c)[0]
        feats[rows[:, None], cols[c][None, :]] = means[c] + 0.8 * noise[rows]

    perm = rng.permutation(V)
    masks = {}
    for key, lo, hi in (("train", 0, n_tr), ("val", n_tr, n_tr + n_va),
                        ("test", n_tr + n_va, n_tr + n_va + n_te)):
        m = np.zeros(V, np.float32)
        m[perm[lo:hi]] = 1.0
        masks[key] = m
    return _finish(name, V, src, dst, feats, labels, masks, C, device)


def tiny(seed: int = 0, V: int = 96, C: int = 4, D: int = 24, *,
         device=None) -> Dataset:
    """Small fast dataset for unit tests."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=V)
    E = V * 6
    src = rng.integers(0, V, size=E)
    same = rng.random(E) < 0.8
    # biased destinations toward same class
    dst = np.where(same,
                   np.array([rng.choice(np.where(labels == labels[s])[0])
                             for s in src]),
                   rng.integers(0, V, size=E))
    feats = (np.eye(C)[labels] @ rng.normal(0, 1, (C, D))
             + 0.5 * rng.normal(0, 1, (V, D))).astype(np.float32)
    masks = {}
    perm = rng.permutation(V)
    third = V // 3
    for i, key in enumerate(("train", "val", "test")):
        m = np.zeros(V, np.float32)
        m[perm[i * third:(i + 1) * third]] = 1.0
        masks[key] = m
    return _finish("tiny", V, src, dst, feats, labels, masks, C, device)
