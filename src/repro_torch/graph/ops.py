"""Sparse graph operations: COO adjacency, renormalization, multi-hop
feature augmentation Ψ = {I, Ã, Ã², Ã³} (the GA-MLP preprocessing step).

Counterpart of ``repro.graph.ops``. SpMM is a gather + ``index_add_`` over
edges, run ONCE per dataset. On the CPU ``index_add_`` adds in edge order,
as the reference's segment-sum does; on the card it uses atomics, so there
the result is equal only to a tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """COO, with symmetrized + self-looped renormalized weights precomputed."""
    n_nodes: int
    src: torch.Tensor       # [E] int32
    dst: torch.Tensor       # [E] int32
    weight: torch.Tensor    # [E] float32 — renormalized Ã entries

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def renormalized_adjacency(n: int, src, dst, device=None) -> Graph:
    """Ã = (D+I)^{-1/2} (A+I) (D+I)^{-1/2}  (Kipf-Welling renormalization).

    Input edges are directed pairs; we symmetrize and add self loops.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    s = np.concatenate([src, dst, np.arange(n)])
    d = np.concatenate([dst, src, np.arange(n)])
    key = s * n + d
    _, idx = np.unique(key, return_index=True)
    s, d = s[idx], d[idx]
    deg = np.bincount(s, minlength=n).astype(np.float64)  # includes self loop
    dinv = 1.0 / np.sqrt(deg)
    w = dinv[s] * dinv[d]
    return Graph(n,
                 torch.from_numpy(s.astype(np.int32)).to(device),
                 torch.from_numpy(d.astype(np.int32)).to(device),
                 torch.from_numpy(w.astype(np.float32)).to(device))


def spmm(g: Graph, h: torch.Tensor) -> torch.Tensor:
    """Ã @ h via edge gather + index_add. h: [V, d] -> [V, d]."""
    msgs = h[g.src] * g.weight[:, None]
    out = torch.zeros((g.n_nodes,) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    return out.index_add_(0, g.dst, msgs)


def augment_features(g: Graph, H: torch.Tensor, k_hops: int) -> torch.Tensor:
    """X = [H ψ_0 ; H ψ_1 ; ...] stacked on the feature axis.
    ψ_i = Ã^i, ψ_0 = I. H: [V, d] -> X: [V, k*d]."""
    feats = [H]
    cur = H
    for _ in range(k_hops - 1):
        cur = spmm(g, cur)
        feats.append(cur)
    return torch.cat(feats, dim=-1)


def row_normalize(H: torch.Tensor) -> torch.Tensor:
    s = H.abs().sum(dim=-1, keepdim=True)
    return H / torch.clamp(s, min=1e-9)
