"""Transport: every collective whose payload crosses a link.

Counterpart of ``repro.comm.transport``. ``parallel/stage_parallel.py``
(the stage ring's neighbour shifts) and ``parallel/collectives.py`` (the
quantized all-reduce) call these instead of formatting payloads
themselves. Where the reference names a ``shard_map`` axis, these take a
ring (``parallel.ring.LocalRing`` or ``ProcessGroupRing``) and an axis name;
tensors lead with the ring's ``[data, model]`` shard axes, and each shard's
payload is formatted on its own, exactly as each device of the reference
formats its own. Byte accounting stays on the host: ``wire_bytes`` /
:func:`psum_wire_bytes` feed a :class:`~repro_torch.comm.ledger.CommLedger`
from the same shapes the step saw.

Shared-scale all-reduce: a scalar min/max handshake fixes ONE affine grid
across shards (a static grid needs none), the integer codes are summed
exactly in int32, and the only lossy step is each shard's rounding
(unbiased under stochastic rounding). Two physical collectives realise it:

  * ``code_psum`` — an all-reduce of the int32 codes (4 B/element on the
    wire whatever the codec);
  * ``gather`` — each shard packs its codes to their physical width
    (``kernels.ops.pack_codes``), the packed payloads are all-gathered, and
    each shard unpacks and sums the codes locally.

Integer addition is exact and the final decode is the same expression, so
the two are bit-identical in value. :func:`psum_mode` picks ``gather`` iff
``world * bits < 64`` (the ring-schedule byte break-even).

Padded wire (:class:`PaddedWire` / :class:`ContainerExchange`): every
boundary slab ships as a uint8 container sized for the widest allowed
codec, so the physical message never changes with the schedule; each
stage's active width is an index into the static width table. The
reference branches with ``lax.switch`` on a traced index; here the table
is an int32 tensor on the ring's device and every width of the wire is
one row-predicated launch of each kernel (``kernels.ops.*_sel``) in which
each stage's rows run at its own width, so the launches of a step do not
depend on the table and one captured CUDA graph replays any schedule.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.codecs import (FP32, AffineCodec, Fp32Codec, GridCodec,
                                     WireCodec, WirePayload, _body_bytes,
                                     _container_dtype, _n_elements,
                                     _uniform_like)
from repro_torch.core.quantize import mul_add
from repro_torch.kernels import ops


def _shard_rows(x) -> int:
    """Shards in a tensor that leads with the ring's [data, model] axes."""
    return x.shape[0] * x.shape[1]


def _shard_dims(x) -> tuple:
    """The per-shard axes of a tensor that leads with [data, model]."""
    return tuple(range(2, x.dim()))


def _pack_shards(codes, bits: int):
    """Pack each shard's codes on its own: [D, S, ...] -> [D, S, body]."""
    rows = codes.reshape(_shard_rows(codes), -1)
    return ops.pack_codes(rows, bits).reshape(*codes.shape[:2], -1)


def _unpack_shards(packed, bits: int, shape):
    """Inverse of :func:`_pack_shards` for slabs of ``shape`` [D, S, ...]."""
    n = _n_elements(shape[2:])
    rows = packed.reshape(_shard_rows(packed), packed.shape[-1])
    return ops.unpack_codes(rows, bits, n).reshape(tuple(shape))


def encode_slab(codec: WireCodec, x) -> WirePayload:
    """Format each shard's slab of ``x`` [D, S, ...] by ``codec``, as each
    device of the reference encodes its own (an affine codec takes each
    shard's own min/max; int4 packs each shard's codes on their own)."""
    if isinstance(codec, Fp32Codec):
        return WirePayload(x, None, None)
    x = x.contiguous()        # a boundary slab of a deeper stack is strided
    if isinstance(codec, GridCodec):
        codes = codec.grid.encode(x)
        if codec.bits <= 4:
            codes = _pack_shards(codes, 4)
        return WirePayload(codes, None, None)
    if isinstance(codec, AffineCodec):
        lo = x.amin(dim=_shard_dims(x), keepdim=True)
        scale = codec.scale_for(lo, x.amax(dim=_shard_dims(x), keepdim=True))
        codes = codec.quantize(x, lo, scale).to(torch.int32) \
            .to(_container_dtype(codec.bits))
        if codec.bits <= 4:
            codes = _pack_shards(codes, 4)
        return WirePayload(codes, scale, lo)
    raise TypeError(f"no ring wire format for codec {codec!r}")


def decode_slab(codec: WireCodec, payload: WirePayload, shape,
                dtype=torch.float32):
    """Inverse of :func:`encode_slab` for slabs of ``shape`` [D, S, ...]."""
    if isinstance(codec, Fp32Codec):
        return payload.codes.to(dtype)
    codes = payload.codes
    if codec.bits <= 4:
        codes = _unpack_shards(codes, 4, shape)
    if isinstance(codec, GridCodec):
        return codec.grid.decode(codes, dtype=dtype)
    return codec.dequantize(codes, payload.zero, payload.scale, dtype)


# ---------------------------------------------------------------------------
# Neighbour exchange (the stage ring)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeighborExchange:
    """Codec-formatted boundary exchange along a ring axis.

    The payload is the boundary slab only (one layer of each stage's local
    stack, axis 2 of a ``[D, S, m, ...]`` tensor); interior layers move by
    a local roll. Every shift comes in two halves so the runtime can hide
    the message behind independent compute:

      * ``start_shift_*``  — encode the boundary slab and start the ring
        shift; returns the in-flight handle (carryable across iterations),
      * ``finish_shift_*`` — take the arrived payload, decode it and splice
        it beside the locally rolled layers.

    ``shift_from_prev`` / ``shift_from_next`` are ``finish(start(x), x)``,
    so split and fused call sites give the same bits. ``tag`` tells apart
    exchanges in flight together between the same two processes.
    """

    ring: object
    axis_name: str = "model"
    codec: WireCodec = FP32
    tag: int = 0

    def _start(self, boundary, delta: int):
        payload = encode_slab(self.codec, boundary)
        parts = [t for t in payload if t is not None]
        handle = self.ring.shift(parts, delta, self.axis_name, self.tag)
        return handle, len(parts)

    def _arrived(self, inflight) -> WirePayload:
        handle, n_parts = inflight
        parts = list(self.ring.finish(handle))
        return WirePayload(*(parts + [None] * (3 - n_parts)))

    # -- forward shift (out[i] = x[i-1]) ------------------------------------
    def start_shift_from_prev(self, x_loc):
        """Encode x_loc[:, :, -1:] and start the forward shift."""
        return self._start(x_loc[:, :, -1:], +1)

    def finish_shift_from_prev(self, inflight, x_loc):
        """out[:, :, i] = x[:, :, i-1]; out[:, :, 0] from the previous stage
        (garbage into global layer 0 — masked by the caller)."""
        boundary = decode_slab(self.codec, self._arrived(inflight),
                               x_loc[:, :, -1:].shape, x_loc.dtype)
        return torch.cat([boundary, x_loc[:, :, :-1]], dim=2)

    def shift_from_prev(self, x_loc):
        return self.finish_shift_from_prev(self.start_shift_from_prev(x_loc),
                                           x_loc)

    # -- backward shift (out[i] = x[i+1]) -----------------------------------
    def start_shift_from_next(self, x_loc):
        """Encode x_loc[:, :, :1] and start the backward shift."""
        return self._start(x_loc[:, :, :1], -1)

    def finish_shift_from_next(self, inflight, x_loc):
        """out[:, :, i] = x[:, :, i+1]; the last from the next stage
        (garbage into global layer L-1 — masked by the caller)."""
        boundary = decode_slab(self.codec, self._arrived(inflight),
                               x_loc[:, :, :1].shape, x_loc.dtype)
        return torch.cat([x_loc[:, :, 1:], boundary], dim=2)

    def shift_from_next(self, x_loc):
        return self.finish_shift_from_next(self.start_shift_from_next(x_loc),
                                           x_loc)


# ---------------------------------------------------------------------------
# Quantized all-reduce
# ---------------------------------------------------------------------------

def _shared_affine(x, ring, axis: str, codec: AffineCodec):
    """Scalar min/max handshake -> one affine grid for every shard:
    (lo, scale), each broadcastable against ``x``."""
    lo = ring.pmin(x.amin(dim=_shard_dims(x), keepdim=True), axis)
    hi = ring.pmax(x.amax(dim=_shard_dims(x), keepdim=True), axis)
    return lo, codec.scale_for(lo, hi)


def _grid_codes(grid, x, generator):
    """Integer codes (as floats) on a static grid; stochastic rounding iff
    a generator is given."""
    q = grid.scaled(x)
    if generator is not None:
        q = torch.floor(q + _uniform_like(q, generator))
    else:
        q = torch.round(q)
    return torch.clamp(q, 0, grid.n_levels - 1)


def _shared_codes(x, ring, axis, codec, generator):
    """Integer codes against the grid every shard shares: (codes, zero,
    scale). Static for GridCodec; min/max handshake for AffineCodec."""
    if isinstance(codec, GridCodec):
        g = codec.grid
        return _grid_codes(g, x, generator), g.lo, g.step
    lo, scale = _shared_affine(x, ring, axis, codec)
    return codec.quantize(x, lo, scale, generator=generator), lo, scale


def _decode_sum(code_sum, zero, scale, world: int):
    """``code_sum · scale + world · zero`` in f32, the product and sum
    rounded once as the jitted reference's fused multiply-add."""
    f32 = torch.float32
    if isinstance(scale, torch.Tensor):
        return mul_add(code_sum, scale.to(f32), (world * zero).to(f32), f32)
    # a static grid: Python scalars, the offset formed in f64 and rounded
    return mul_add(code_sum, float(np.float32(scale)),
                   float(np.float32(world * zero)), f32)


def _code_psum(codes, zero, scale, ring, axis: str):
    """Exact int32 code-sum; decode is ``scale * code_sum + n * zero``."""
    code_sum = ring.psum(codes.to(torch.int32), axis)
    return _decode_sum(code_sum, zero, scale,
                       ring.axis_size(axis)).expand(codes.shape)


GATHER_BREAK_EVEN = 64   # gather wins iff world_size * codec.bits < this

PSUM_MODES = ("psum", "gather", "code_psum")


def _check_mode(mode: Optional[str]) -> Optional[str]:
    if mode is not None and mode not in PSUM_MODES:
        raise ValueError(f"unknown psum mode {mode!r}; expected one of "
                         f"{PSUM_MODES} or None (cost-model selection)")
    return mode


def psum_mode(codec: WireCodec, world_size: int) -> str:
    """The physical collective for a compressed psum: ``"psum"`` (plain
    fp32), ``"gather"`` (packed all-gather + local decode-sum) or
    ``"code_psum"`` (int32 code psum). Gather fabric bytes
    ``w*(w-1)*n*bits/8`` against the code psum's ``8*n*(w-1)``: gather
    wins iff ``w * bits < 64``."""
    if isinstance(codec, Fp32Codec) or codec.bits >= 32:
        return "psum"
    w = int(world_size)
    return "gather" if w * codec.bits < GATHER_BREAK_EVEN else "code_psum"


def _packed_code_sum(codes, ring, axis: str, bits: int):
    """Pack each shard's codes to their physical width, all-gather the uint8
    containers, unpack and sum in int32 locally. Exact, like the code
    psum. Returns the sum in ``codes``' shape."""
    icodes = codes.to(torch.int32).to(_container_dtype(bits))
    D, S = codes.shape[:2]
    n = _n_elements(codes.shape[2:])
    packed = _pack_shards(icodes, bits)                  # [D, S, body]
    arrived = ring.all_gather(packed, axis)              # [D, S, w, body]
    w = arrived.shape[2]
    peers = ops.unpack_codes(arrived.reshape(D * S * w, packed.shape[-1]),
                             bits, n)                    # one launch
    return peers.reshape(D, S, w, n).to(torch.int32) \
        .sum(dim=2, dtype=torch.int32).reshape(codes.shape)


def _gather_psum(codes, zero, scale, ring, axis: str, bits: int):
    code_sum = _packed_code_sum(codes, ring, axis, bits)
    return _decode_sum(code_sum, zero, scale, ring.axis_size(axis))


def quantized_psum(x, ring, axis: str, codec: WireCodec = AffineCodec(8), *,
                   generator: Optional[torch.Generator] = None,
                   mode: Optional[str] = None):
    """psum of ``x`` ([D, S, ...] on the ring) over ``axis`` with the payload
    formatted by ``codec``; every shard gets the sum (the result has x's
    shape).

    ``mode="gather"`` (packed all-gather, the narrow-codec path that ships
    ``codec.bits`` per element) and ``mode="code_psum"`` (int32 code psum)
    return bit-identical values; ``mode=None`` lets :func:`psum_mode`
    choose; ``mode="psum"`` (or an fp32 codec) is the plain psum. Rounding
    is unbiased stochastic iff a ``generator`` is given.
    """
    if _check_mode(mode) == "psum" or isinstance(codec, Fp32Codec):
        return ring.psum(x, axis).expand(x.shape)
    if mode is None:
        mode = psum_mode(codec, ring.axis_size(axis))
    codes, zero, scale = _shared_codes(x, ring, axis, codec, generator)
    if mode == "gather":
        return _gather_psum(codes, zero, scale, ring, axis, codec.bits)
    return _code_psum(codes, zero, scale, ring, axis)


def psum_with_error_feedback(x, err, ring, axis: str,
                             codec: WireCodec = AffineCodec(8), *,
                             generator: Optional[torch.Generator] = None,
                             mode: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed psum of (x + carried error); returns (summed, new_error).

    new_error = target − what this shard actually transmitted (exact: the
    grid is shared). On the gather path the residual is taken against the
    decoded PACKED codes, the values receivers rebuild from the container.
    """
    target = x + err
    if _check_mode(mode) == "psum" or isinstance(codec, Fp32Codec):
        return ring.psum(target, axis).expand(target.shape), \
            torch.zeros_like(target)
    if mode is None:
        mode = psum_mode(codec, ring.axis_size(axis))
    codes, zero, scale = _shared_codes(target, ring, axis, codec, generator)
    if mode == "gather":
        icodes = codes.to(torch.int32).to(_container_dtype(codec.bits))
        own = _unpack_shards(_pack_shards(icodes, codec.bits), codec.bits,
                             icodes.shape)
        sent = _decode_sum(own, zero, scale, 1)
        summed = _gather_psum(codes, zero, scale, ring, axis, codec.bits)
        return summed, target - sent
    sent = _decode_sum(codes, zero, scale, 1)
    return _code_psum(codes, zero, scale, ring, axis), target - sent


@dataclasses.dataclass(frozen=True)
class PsumWireCost:
    """Exact per-shard accounting of one compressed psum: the physical bytes
    of the message this shard injects (`wire_bytes`), the codec's logical
    body bytes (`logical_bytes`, no header) and the scalar min/max
    handshake (`handshake_bytes`, affine codecs only)."""
    mode: str
    wire_bytes: int
    logical_bytes: int
    handshake_bytes: int


def psum_wire_bytes(codec: WireCodec, shape, world_size: int,
                    mode: Optional[str] = None) -> PsumWireCost:
    """Physical + logical bytes one shard contributes to one compressed psum
    of ``shape`` at ``world_size``, for the selected collective (or an
    explicit ``mode``). The code psum ships the int32 container
    (4 B/element); the gather ships the packed container."""
    n = _n_elements(shape)
    if _check_mode(mode) is None:
        mode = psum_mode(codec, world_size)
    if mode == "psum":
        return PsumWireCost("psum", 4 * n, 4 * n, 0)
    logical = codec.payload_bytes(shape) - codec.header_bytes()
    handshake = 8 if isinstance(codec, AffineCodec) else 0
    wire = _body_bytes(codec.bits, n) if mode == "gather" else 4 * n
    return PsumWireCost(mode, wire, logical, handshake)


@dataclasses.dataclass(frozen=True)
class PsumProgramPlan:
    """What one :func:`quantized_psum` call commits to for one (codec,
    world) point, computed next to the mode rule it follows
    (:func:`psum_mode`).

      * ``collective``    — the ring collective carrying the payload
        (``all_gather`` on the gather path, ``psum`` otherwise),
      * ``operand_dtype`` — that collective's payload dtype (packed uint8
        container, int32 code sum, or raw fp32),
      * ``operand_bytes`` — the payload bytes one shard injects, by
        construction ``psum_wire_bytes(...).wire_bytes``,
      * ``handshake``     — True iff the affine min/max agreement
        (``pmin``/``pmax``) runs (a static grid needs none).
    """
    mode: str
    collective: str
    operand_dtype: str
    operand_bytes: int
    handshake: bool


def psum_program_plan(codec: WireCodec, shape, world_size: int,
                      mode: Optional[str] = None) -> PsumProgramPlan:
    """The program :func:`quantized_psum` runs for this (codec, shape,
    world) point. Byte accounting defers to :func:`psum_wire_bytes`, so
    plan and ledger cannot disagree."""
    cost = psum_wire_bytes(codec, shape, world_size, mode)
    n = _n_elements(shape)
    if cost.mode == "psum":
        return PsumProgramPlan("psum", "psum", "float32", cost.wire_bytes,
                               False)
    handshake = isinstance(codec, AffineCodec)
    if cost.mode == "gather":
        # the packed container is byte planes whatever the width
        return PsumProgramPlan("gather", "all_gather", "uint8",
                               cost.wire_bytes, handshake)
    assert cost.mode == "code_psum" and cost.wire_bytes == 4 * n
    return PsumProgramPlan("code_psum", "psum", "int32", cost.wire_bytes,
                           handshake)


def record_psum(ledger, iteration: int, edge: str, codec: WireCodec, shape,
                world_size: int, mode: Optional[str] = None) -> PsumWireCost:
    """Put one shard's compressed-psum traffic on the ledger: the payload
    record with the selected collective's physical/logical split, plus the
    handshake record when the grid needs agreeing."""
    cost = psum_wire_bytes(codec, shape, world_size, mode)
    ledger.record(iteration, edge, "psum", _n_elements(shape), codec.bits,
                  payload_bytes=cost.logical_bytes,
                  wire_bytes=cost.wire_bytes)
    if cost.handshake_bytes:
        ledger.record_handshake(iteration, edge)
    return cost


# ---------------------------------------------------------------------------
# Padded wire containers (per-boundary mixed bit-widths in one step)
# ---------------------------------------------------------------------------

def to_device(a: np.ndarray, device, out=None) -> torch.Tensor:
    """A host array on ``device`` with no stream sync (pinned, async on
    CUDA), into ``out`` when given (a buffer whose address a captured
    graph reads)."""
    device = torch.device(device)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if device.type == "cuda":
        t = t.pin_memory()
    if out is None:
        return t.to(device, non_blocking=True)
    return out.copy_(t, non_blocking=True)


def sel_table(widths, device) -> torch.Tensor:
    """Width indices (a container step's [2, n_stages] widths table, or one
    index per stage) as the contiguous int32 tensor on ``device`` the
    kernels read: a tensor is taken as it is (cast if it must be), host
    integers go over once (:func:`to_device`)."""
    if isinstance(widths, torch.Tensor):
        return widths.to(device=device, dtype=torch.int32).contiguous()
    return to_device(np.asarray(widths, np.int32), device)


def stage_entries(row, stages: List[int], n: int, delta: int = 0):
    """``row[(s - delta) % n]`` along dim 0 for each local stage s of a
    ring of ``n`` holding ``stages`` (all of them, or one): ``delta=0`` the
    stage's own entry, ``delta=±1`` its source's. A view or a roll on the
    device; no host index."""
    if len(stages) == 1:
        i = (stages[0] - delta) % n
        return row[i:i + 1]
    if stages != list(range(n)):
        raise ValueError(f"a ring holding stages {stages} of {n}: expected "
                         "all or one")
    return torch.roll(row, shifts=delta, dims=0) if delta else row


@dataclasses.dataclass(frozen=True)
class PaddedWire:
    """Fixed-size uint8 wire container over a static table of grid codecs.

    Each shard's slab ships as :meth:`capacity` bytes, sized for the widest
    width in ``widths``, whatever width it is formatted at. A stage's active
    width is ``sel``, an index into ``widths`` (int32 on the device, one
    per local stage; host integers are taken too): encode packs that
    grid's codes into the head of the container and leaves the tail zero;
    decode reads the active packed length back out. Every width of the
    wire runs as one predicated launch of each kernel over all the shards
    (8-bit codes are their own container: encoded straight into it).
    """

    widths: Tuple[int, ...]              # ascending, e.g. (4, 8, 16)
    grids: Tuple[object, ...]            # QuantGrid per width

    def __post_init__(self):
        if tuple(sorted(self.widths)) != tuple(self.widths):
            raise ValueError(f"widths must ascend: {self.widths}")
        if len(self.widths) != len(self.grids):
            raise ValueError("one grid per width")

    @classmethod
    def from_grids(cls, grids_by_bits) -> "PaddedWire":
        items = sorted((int(b), g) for b, g in grids_by_bits.items())
        return cls(tuple(b for b, _ in items), tuple(g for _, g in items))

    @property
    def widest(self) -> int:
        return self.widths[-1]

    def capacity(self, shape) -> int:
        """Physical container bytes for one shard's slab of ``shape``."""
        return _body_bytes(self.widest, _n_elements(shape))

    def payload_bytes(self, shape, bits: int) -> int:
        """Logical bytes the ACTIVE codec occupies inside the container."""
        return _body_bytes(int(bits), _n_elements(shape))

    def sel_of_bits(self, bits_seq: Sequence[int]) -> List[int]:
        """Schedule bits -> indices into ``widths`` (host integers)."""
        return [self.widths.index(int(b)) for b in bits_seq]

    def widths_table(self, q_bits: Sequence[int], p_bits: Sequence[int],
                     device=None, *, out=None) -> torch.Tensor:
        """The step's widths table of a schedule: int32 [2, n_stages] (q
        widths, then p) on ``device``, copied without a sync; into ``out``
        (a table the step's graph reads) when given."""
        host = np.asarray([self.sel_of_bits(q_bits),
                           self.sel_of_bits(p_bits)], np.int32)
        return to_device(host, out.device if out is not None else device,
                         out)

    def encode(self, x, sel):
        """Slabs ``x`` [D, S, ...] -> containers uint8 [D, S, capacity];
        ``sel[s]`` is the width index stage ``s`` formats at."""
        D, S = x.shape[:2]
        n = _n_elements(x.shape[2:])
        sel = sel_table(sel, x.device)
        rows = x.reshape(D * S, n)          # a view where the slab allows
        out = torch.zeros((D, S, self.capacity(x.shape[2:])),
                          dtype=torch.uint8, device=x.device)
        flat = out.view(D * S, -1)
        for k, (bits, grid) in enumerate(zip(self.widths, self.grids)):
            if 4 < bits <= 8:               # the codes are the container
                ops.grid_encode_sel(rows, grid, flat, sel, k)
                continue
            codes = torch.empty((D * S, n), dtype=grid.code_dtype,
                                device=x.device)
            ops.grid_encode_sel(rows, grid, codes, sel, k)
            ops.pack_codes_sel(codes, bits, flat, sel, k)
        return out

    def decode(self, container, sel, shape, dtype=torch.float32):
        """Containers [D, S, capacity] -> slabs of ``shape`` [D, S, ...];
        ``sel[s]`` is the width index the container of stage ``s`` was
        formatted at (its sender's)."""
        D, S = container.shape[:2]
        n = _n_elements(shape[2:])
        sel = sel_table(sel, container.device)
        rows = container.reshape(D * S, container.shape[-1])
        out = torch.empty((D * S, n), dtype=torch.float32,
                          device=container.device)
        for k, (bits, grid) in enumerate(zip(self.widths, self.grids)):
            if 4 < bits <= 8:
                ops.grid_decode_sel(rows, grid, out, sel, k)
                continue
            codes = torch.empty((D * S, n), dtype=grid.code_dtype,
                                device=container.device)
            ops.unpack_codes_sel(rows, bits, codes, sel, k)
            ops.grid_decode_sel(codes, grid, out, sel, k)
        out = out.reshape(tuple(shape))
        return out if dtype == torch.float32 else out.to(dtype)


@dataclasses.dataclass(frozen=True)
class ContainerExchange:
    """:class:`NeighborExchange` over a :class:`PaddedWire`: each boundary
    slab ships in the fixed-size container at its stage's own width.

    ``start_shift_*`` encodes with the SENDING stages' ``sel``;
    ``finish_shift_*`` decodes with ``sel_src``, the width each receiving
    stage's sender used (read from the same widths table). The halves
    compose to the fused shifts as in :class:`NeighborExchange`.
    """

    ring: object
    axis_name: str
    wire: PaddedWire
    tag: int = 0

    # -- forward shift (out[i] = x[i-1]) ------------------------------------
    def start_shift_from_prev(self, x_loc, sel):
        c = self.wire.encode(x_loc[:, :, -1:], sel)
        return self.ring.shift([c], +1, self.axis_name, self.tag)

    def finish_shift_from_prev(self, inflight, x_loc, sel_src):
        (c,) = self.ring.finish(inflight)
        boundary = self.wire.decode(c, sel_src, x_loc[:, :, -1:].shape,
                                    x_loc.dtype)
        return torch.cat([boundary, x_loc[:, :, :-1]], dim=2)

    def shift_from_prev(self, x_loc, sel_self, sel_src):
        return self.finish_shift_from_prev(
            self.start_shift_from_prev(x_loc, sel_self), x_loc, sel_src)

    # -- backward shift (out[i] = x[i+1]) -----------------------------------
    def start_shift_from_next(self, x_loc, sel):
        c = self.wire.encode(x_loc[:, :, :1], sel)
        return self.ring.shift([c], -1, self.axis_name, self.tag)

    def finish_shift_from_next(self, inflight, x_loc, sel_src):
        (c,) = self.ring.finish(inflight)
        boundary = self.wire.decode(c, sel_src, x_loc[:, :, :1].shape,
                                    x_loc.dtype)
        return torch.cat([x_loc[:, :, 1:], boundary], dim=2)

    def shift_from_next(self, x_loc, sel_self, sel_src):
        return self.finish_shift_from_next(
            self.start_shift_from_next(x_loc, sel_self), x_loc, sel_src)
