"""Wire codecs: one protocol for every quantized payload.

Counterpart of ``repro.comm.codecs``:

  * grid codecs — the paper's pdADMM-G-Q wire (a static calibrated
    ``QuantGrid`` shared by construction between sender and receiver),
  * affine codecs — per-payload min/max affine quantization with an 8-byte
    scale/zero header, optionally with unbiased stochastic rounding.

Every codec reports exact wire bytes for a payload of a given shape,
including headers and int4 nibble packing, so the ``CommLedger`` never
guesses. Error feedback (:func:`encode_with_error_feedback`) carries
``target − decode(encode(target))`` so compression noise never accumulates.

Stochastic rounding draws its uniforms from an explicit ``torch.Generator``
where the reference takes a ``jax.random`` key: one rule everywhere, a
generator given ⇒ stochastic, none ⇒ deterministic. Deterministic payloads
are the jitted reference's bit for bit (see ``core/quantize.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.quantize import QuantGrid, mul_add, uniform_grid


class WirePayload(NamedTuple):
    """What crosses the link: integer codes (or raw fp32 values) plus an
    optional per-payload affine header (scale, zero)."""
    codes: torch.Tensor
    scale: Optional[torch.Tensor]
    zero: Optional[torch.Tensor]


@runtime_checkable
class WireCodec(Protocol):
    """Anything that can format a tensor for the wire and account for it."""

    name: str
    bits: int

    def encode(self, x, *, generator: Optional[torch.Generator] = None
               ) -> WirePayload:
        ...

    def decode(self, payload: WirePayload, shape=None,
               dtype=torch.float32) -> torch.Tensor:
        ...

    def payload_bytes(self, shape) -> int:
        ...

    def header_bytes(self) -> int:
        ...


def _n_elements(shape) -> int:
    return int(math.prod(int(s) for s in shape))


def _container_dtype(bits: int):
    if bits > 16:
        raise ValueError(f"no integer wire container for {bits}-bit codes "
                         "(supported: <=16; use fp32 for wider)")
    return torch.uint8 if bits <= 8 else torch.uint16


def pack_codes_jnp(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Canonical packing of integer codes into their uint8 container — the
    wire layout contract, named as its reference counterpart
    (``repro.comm.codecs.pack_codes_jnp``) and equal to it byte for byte:

      * ``bits <= 4``  — pad to an even length ``n2`` and half-split: byte
        ``i`` = code ``i`` in the high nibble, code ``i + n2/2`` in the
        low nibble,
      * ``bits <= 8``  — identity (uint8 codes are the container),
      * ``bits <= 16`` — big-endian byte planes: all high bytes, then all
        low bytes.

    Output length is exactly ``_body_bytes(bits, codes.numel())``. The
    shifts run in int32 (PyTorch has no bit operations on uint16).
    """
    flat = codes.reshape(-1)
    if bits <= 4:
        flat = flat.to(torch.uint8)
        if flat.shape[0] % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        h = flat.shape[0] // 2
        return (flat[:h] << 4) | (flat[h:] & 0xF)
    if bits <= 8:
        return flat.to(torch.uint8)
    c = flat.to(torch.int32)
    return torch.cat([(c >> 8).to(torch.uint8), (c & 0xFF).to(torch.uint8)])


def unpack_codes_jnp(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_jnp`: the first ``n`` codes, in the
    container dtype (uint8 for <= 8 bits, uint16 above)."""
    if bits <= 4:
        b = packed[:(n + 1) // 2]
        return torch.cat([(b >> 4) & 0xF, b & 0xF])[:n].to(torch.uint8)
    if bits <= 8:
        return packed[:n].to(torch.uint8)
    hi = packed[:n].to(torch.int32)
    lo = packed[n:2 * n].to(torch.int32)
    return ((hi << 8) | lo).to(torch.uint16)


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """The int4 wire body of a codec payload: the ``pack_codes`` kernel on
    the card, :func:`pack_codes_jnp` on the CPU (``kernels.ops``)."""
    from repro_torch.kernels import ops
    return ops.pack_codes(codes.reshape(-1), 4)


def _unpack4(packed: torch.Tensor, shape) -> torch.Tensor:
    from repro_torch.kernels import ops
    return ops.unpack_codes(packed, 4, _n_elements(shape)) \
        .reshape(tuple(shape))


def _body_bytes(bits: int, n: int) -> int:
    """Physical payload bytes for ``n`` codes at ``bits`` (container-rounded)."""
    if bits >= 32:
        return 4 * n
    if bits <= 4:
        return (n + 1) // 2          # packed nibbles
    if bits <= 8:
        return n                     # uint8 container
    return 2 * n                     # uint16 container


def _uniform_like(q: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) of q's shape and dtype, drawn on the generator's device."""
    u = torch.rand(q.shape, generator=generator, dtype=q.dtype,
                   device=generator.device)
    return u.to(q.device)


@dataclasses.dataclass(frozen=True)
class Fp32Codec:
    """Identity wire: 4 bytes/element, no header. The savings baseline."""

    name: str = "fp32"
    bits: int = 32

    def encode(self, x, *, generator=None) -> WirePayload:
        return WirePayload(x, None, None)

    def decode(self, payload: WirePayload, shape=None, dtype=torch.float32):
        return payload.codes.to(dtype)

    def payload_bytes(self, shape) -> int:
        return 4 * _n_elements(shape)

    def header_bytes(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class GridCodec:
    """Static calibrated grid shared by construction (pdADMM-G-Q wire).

    No per-payload header: sender and receiver agreed on (lo, step, levels)
    at calibration time, as the paper fixes Δ = {-1..20} offline. int4
    payloads are nibble-packed. Deterministic codes go through the grid
    kernels on a CUDA tensor (``QuantGrid.encode``/``decode``).
    """

    grid: QuantGrid

    @property
    def name(self) -> str:
        return f"grid{self.bits}"

    @property
    def bits(self) -> int:
        return self.grid.bits

    def encode(self, x, *, generator=None) -> WirePayload:
        g = self.grid
        if generator is not None:   # generator given -> stochastic
            q = g.scaled(x)
            ix = torch.floor(q + _uniform_like(q, generator))
            codes = torch.clamp(ix, 0, g.n_levels - 1).to(torch.int32) \
                .to(_container_dtype(self.bits))
        else:
            codes = g.encode(x)
        if self.bits <= 4:
            codes = _pack4(codes)
        return WirePayload(codes, None, None)

    def decode(self, payload: WirePayload, shape=None, dtype=torch.float32):
        codes = payload.codes
        if self.bits <= 4:
            if shape is None:
                raise ValueError("int4 decode needs the original shape")
            codes = _unpack4(codes, shape)
        return self.grid.decode(codes, dtype=dtype)

    def payload_bytes(self, shape) -> int:
        return _body_bytes(self.bits, _n_elements(shape))

    def header_bytes(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class AffineCodec:
    """Per-payload affine quantization: codes + an 8-byte (scale, zero)
    header. Rounding is unbiased stochastic iff a ``generator`` is given,
    deterministic otherwise."""

    bits: int = 8

    def __post_init__(self):
        _container_dtype(self.bits)  # reject widths no container can hold

    @property
    def name(self) -> str:
        return f"int{self.bits}"

    # -- affine core ---------------------------------------------------------
    def scale_for(self, lo, hi) -> torch.Tensor:
        """max((hi − lo) / (2^bits − 1), 1e-12), the division by the
        constant taken as the jitted reference takes it: a multiply by its
        reciprocal formed in the tensor's dtype."""
        n = torch.tensor(2 ** self.bits - 1, dtype=lo.dtype)
        inv = float(torch.tensor(1.0, dtype=lo.dtype) / n)
        return torch.clamp((hi - lo) * inv, min=1e-12)

    def quantize(self, x, zero, scale, *, generator=None) -> torch.Tensor:
        """x -> clipped integer codes (as floats) against a GIVEN affine grid."""
        q = (x - zero) / scale
        if generator is not None:
            q = torch.floor(q + _uniform_like(q, generator))
        else:
            q = torch.round(q)
        return torch.clamp(q, 0, 2 ** self.bits - 1)

    def dequantize(self, codes, zero, scale, dtype=torch.float32):
        """codes·scale + zero, one rounding (the jitted reference's fused
        multiply-add), computed in scale's dtype (at least f32) and cast
        to ``dtype``."""
        ct = torch.promote_types(scale.dtype, torch.float32)
        return mul_add(codes.to(torch.int32), scale, zero, ct).to(dtype)

    def encode(self, x, *, generator=None) -> WirePayload:
        lo, hi = torch.min(x), torch.max(x)
        scale = self.scale_for(lo, hi)
        codes = self.quantize(x, lo, scale, generator=generator)
        codes = codes.to(torch.int32).to(_container_dtype(self.bits))
        if self.bits <= 4:
            codes = _pack4(codes)
        return WirePayload(codes, scale, lo)

    def decode(self, payload: WirePayload, shape=None, dtype=torch.float32):
        codes = payload.codes
        if self.bits <= 4:
            if shape is None:
                raise ValueError("int4 decode needs the original shape")
            codes = _unpack4(codes, shape)
        return self.dequantize(codes, payload.zero, payload.scale, dtype)

    def payload_bytes(self, shape) -> int:
        return _body_bytes(self.bits, _n_elements(shape)) + self.header_bytes()

    def header_bytes(self) -> int:
        return 8  # fp32 scale + fp32 zero


FP32 = Fp32Codec()


def codec_for_grid(grid: Optional[QuantGrid]) -> WireCodec:
    """The codec for a (possibly absent) pdADMM-G-Q grid."""
    return GridCodec(grid) if grid is not None else FP32


def codec_for_bits(bits: int, lo: Optional[float] = None,
                   hi: Optional[float] = None) -> WireCodec:
    """fp32 for bits>=32; a calibrated GridCodec when a range is given;
    otherwise a per-payload AffineCodec."""
    if bits >= 32:
        return FP32
    if lo is not None and hi is not None:
        return GridCodec(uniform_grid(bits, lo, hi))
    return AffineCodec(bits)


def fake_quantize(codec: WireCodec, x, *, generator=None):
    """decode(encode(x)) — the receiver's view of x after the wire (e.g. the
    u exchange of pdADMM-G-Q inside single-host math)."""
    return codec.decode(codec.encode(x, generator=generator), shape=x.shape,
                        dtype=x.dtype)


def encode_with_error_feedback(codec: WireCodec, x, err, *, generator=None
                               ) -> Tuple[WirePayload, torch.Tensor,
                                          torch.Tensor]:
    """Encode ``x + err``; return (payload, decoded-sent value, new error).

    ``new_err = target − sent`` is exact on the sender (it can decode its own
    payload), so the cumulative bias over repeated rounds stays bounded by a
    single round's quantization error.
    """
    target = x + err
    payload = codec.encode(target, generator=generator)
    sent = codec.decode(payload, shape=target.shape, dtype=target.dtype)
    return payload, sent, target - sent
