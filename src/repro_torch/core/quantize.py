"""Quantization for pdADMM-G-Q (Problem 3) and the affine wire helpers.

Counterpart of ``repro.core.quantize``: the explicit integer set
Δ = {-1, 0, ..., 20}, uniform b-bit grids, and ``affine_encode`` /
``affine_decode`` over the codec layer (``repro_torch.comm.codecs``).

The grid arithmetic is the jitted reference's, bit for bit, on every
device. Under ``jax.jit`` XLA turns ``(x − lo) / step`` (a division by a
constant) into a multiply by the f32 reciprocal of ``step``, and contracts
``lo + ix·step`` into one fused multiply-add. So here

    index(x)  = clip(round((x − lo) · inv_step), 0, n − 1)
    project   = fma(index(x), step, lo)          (one rounding)

with ``inv_step = 1 / step`` formed in x's dtype and ``torch.round``
rounding half to even, as ``jnp.round`` does. On a CUDA tensor ``project``,
``encode`` and ``decode`` run the hand-written grid kernels
(``kernels.ops.grid_*``); a CPU tensor takes the plain code below.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def mul_add(ix: torch.Tensor, scale, offset, dtype) -> torch.Tensor:
    """``ix · scale + offset`` rounded once to ``dtype``: the fused
    multiply-add XLA emits under jit. ``ix`` holds integer codes below
    2^16 and ``scale``/``offset`` are f32 values, so for a 32-bit or
    narrower ``dtype`` the f64 product and sum are exact and the cast back is
    the one rounding. An f64 ``dtype`` rounds twice (within an ulp of the
    fused form)."""
    if dtype == torch.float64:
        return ix.to(dtype) * scale + offset
    return (ix.to(torch.float64) * scale + offset).to(dtype)


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

    @property
    def code_dtype(self):
        """The wire container of a code: uint8 for <= 8 bits, uint16 above."""
        return torch.uint8 if self.bits <= 8 else torch.uint16

    # -- the scalars every device uses, in the tensor's dtype -----------------
    def lo_in(self, dtype) -> float:
        return float(torch.tensor(self.lo, dtype=dtype))

    def step_in(self, dtype) -> float:
        return float(torch.tensor(self.step, dtype=dtype))

    def inv_step_in(self, dtype) -> float:
        """1 / step formed in ``dtype`` (the constant XLA folds)."""
        one = torch.tensor(1.0, dtype=dtype)
        return float(one / torch.tensor(self.step, dtype=dtype))

    # -- core ops -----------------------------------------------------------
    def scaled(self, x: torch.Tensor) -> torch.Tensor:
        """(x − lo) · inv_step: x in units of the grid step."""
        return (x - self.lo) * self.inv_step_in(x.dtype)

    def index(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(self.scaled(x)), 0, self.n_levels - 1)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest grid point (prox of the indicator)."""
        from repro_torch.kernels import ops
        return ops.grid_project(x, self)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x -> integer codes (the transmitted payload): uint8 for <= 8
        bits, uint16 above."""
        from repro_torch.kernels import ops
        return ops.grid_encode(x, self)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        from repro_torch.kernels import ops
        return ops.grid_decode(codes, self, dtype)


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


# ---------------------------------------------------------------------------
# Affine codec helpers (the canonical wire implementation is
# repro_torch.comm.codecs.AffineCodec): the (codes, scale, zero) tuple API,
# per tensor or per ``axis``. Rounding is unbiased stochastic iff a
# ``generator`` is given.
# ---------------------------------------------------------------------------

def affine_encode(x, bits: int = 8, axis=None,
                  generator: Optional[torch.Generator] = None):
    """Per-tensor (or per-`axis`) affine quantization. Returns (codes, scale, zero)."""
    from repro_torch.comm.codecs import AffineCodec, _container_dtype
    codec = AffineCodec(bits)
    if axis is None:
        lo, hi = torch.min(x), torch.max(x)
    else:
        lo = torch.amin(x, dim=axis, keepdim=True)
        hi = torch.amax(x, dim=axis, keepdim=True)
    scale = codec.scale_for(lo, hi)
    codes = codec.quantize(x, lo, scale, generator=generator)
    return codes.to(_container_dtype(bits)), scale, lo


def affine_decode(codes, scale, zero, dtype=torch.float32):
    from repro_torch.comm.codecs import AffineCodec
    return AffineCodec().dequantize(codes, zero, scale, dtype)
