"""Quantization grids for pdADMM-G-Q (Problem 3).

Counterpart of the grid half of ``repro.core.quantize``: the explicit
integer set Δ = {-1, 0, ..., 20} and uniform b-bit grids. ``torch.round``
rounds half to even, as ``jnp.round`` does, so projections and codes are
bitwise equal to the reference's. The affine wire codec waits for the
port's comm slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class QuantGrid:
    lo: float
    step: float
    n_levels: int

    @property
    def hi(self) -> float:
        return self.lo + self.step * (self.n_levels - 1)

    @property
    def bits(self) -> int:
        return max(1, math.ceil(math.log2(self.n_levels)))

    def index(self, x: torch.Tensor) -> torch.Tensor:
        ix = torch.round((x - self.lo) / self.step)
        return torch.clamp(ix, 0, self.n_levels - 1)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest grid point (prox of the indicator)."""
        return (self.lo + self.index(x) * self.step).to(x.dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x -> integer codes (the transmitted payload)."""
        dtype = torch.uint8 if self.bits <= 8 else torch.uint16
        return self.index(x).to(dtype)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return (self.lo + codes.to(torch.float32) * self.step).to(dtype)


def integer_grid(lo: int = -1, hi: int = 20) -> QuantGrid:
    """The paper's default Δ = {-1, 0, ..., 20}."""
    return QuantGrid(float(lo), 1.0, hi - lo + 1)


def uniform_grid(bits: int, lo: float, hi: float) -> QuantGrid:
    n = 2 ** bits
    step = (hi - lo) / (n - 1) if hi > lo else 1.0
    return QuantGrid(float(lo), float(step), n)


def calibrated_grid(bits: int, x: torch.Tensor, margin: float = 0.0) -> QuantGrid:
    lo = float(torch.min(x)) - margin
    hi = float(torch.max(x)) + margin
    return uniform_grid(bits, lo, hi)
