"""Deterministic wire fault injection and integrity sentinels for the stage
ring: the fault-tolerance layer of the distributed ADMM runtime.

Counterpart of ``repro.comm.faults``. pdADMM-G tolerates inexact updates:
a stale or dropped boundary slab is one more source of inexactness the
iteration absorbs. So a slab that fails its check is replaced by the last
verified one (one iteration of staleness on one boundary), and only an
UNDETECTED corruption that poisons the state (a non-finite value, an
objective blow-up) needs a checkpoint rollback.

A :class:`FaultPlan` is a pure function of ``(seed, tick)`` evaluated on the
host (``np.random.default_rng((seed, tick))``, as the reference draws it),
so its controls, events and traces equal the reference's bit for bit. The
step takes the tick's :class:`FaultControls` as tensors on the ring's
device and never branches on them on the host: masks are applied with
``torch.where`` and multiplied by their ``active`` flags, so the step holds
no host sync.

Wire integrity header: every checked slab flies with two int32 words next
to its payload, through the same ring shift:

    ``header[0]`` the checksum: the wraparound int32 sum of the payload's
    raw container words (uint8 and uint16 containers widened to int32,
    float32 bit-cast), as the reference's int32 ``jnp.sum`` gives it. Only
    the code body is ever corrupted by the injector.
    ``header[1]`` the seqno: the sender's plan tick, checked against the
    tick the receiver expects (this tick when the exchange is fused, the
    previous one for a carried slab), which catches stale deliveries.

8 physical bytes per slab per link (:data:`SENTINEL_HEADER_BYTES`), charged
to the ledger as wire bytes of kind ``"header"`` with no logical payload.

Bit positions are the port's own. The reference draws the positions a flip
event XORs with ``jax.random.randint`` inside its step, which PyTorch cannot
reproduce. The port draws them on the host with numpy, as a pure function of
``(ctl.key, edge, stage, send|recv, i)`` (:func:`flip_draws`), ships them
in ``FaultControls.draws`` and reduces each modulo the payload's bit count
on the device. So the CPU and the card flip the same bits, while a fault
run's trajectory differs from the reference's wherever a corruption goes
undetected; the two are held to each other by effect: plans, traces,
headers, verdict counts, the ledger's fault counts, and rollbacks that
happen and converge.

Fault timing: ``drop`` and ``flip`` strike at receive time (injection tick
== detection tick in both orderings); ``sneaky`` corrupts the sender's
buffer before the checksum, so it passes the wire check and shows only
through the finite/spike sentinels; ``delay`` (overlap only) makes the
receiver's carry keep the previous in-flight slab, caught one tick later by
its stale seqno. Per (edge, src, tick) the classes exclude each other at
draw time (drop > flip > sneaky, all shadowed by the previous tick's
delay), so every consumed detectable event fails exactly one verdict. A
rollback never rewinds the plan tick.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm.codecs import WirePayload
from repro_torch.comm.transport import (decode_slab, encode_slab,
                                       stage_entries, to_device)

# edge order of every per-edge mask and counter in this module
EDGES = ("q_fwd", "u_fwd", "p_bwd")

# physical bytes of the integrity header (2 x int32) per slab per link
SENTINEL_HEADER_BYTES = 8

# objective_spike fires when obj > prev + SPIKE_TOL * (1 + |prev|)
SPIKE_TOL = 10.0

# flip draws lie in [0, DRAW_RANGE); a position is draw mod the bit count
DRAW_RANGE = 2 ** 62


class FaultControls(NamedTuple):
    """The per-tick control block a sentinel step takes (one trailing
    argument), as tensors on the ring's device. Built on the host by
    :meth:`FaultPlan.controls` or :func:`null_controls`."""
    seqno: torch.Tensor     # int32 [] — the plan tick, stamped into headers
    prev_obj: torch.Tensor  # f32 []   — last accepted objective (+inf first)
    flip: torch.Tensor      # int32 [3, n_stages] — detectable corruption
    sneaky: torch.Tensor    # int32 [3, n_stages] — pre-checksum flips
    drop: torch.Tensor      # bool [3, n_stages]  — lost slabs, (edge, src)
    delay: torch.Tensor     # bool [n_stages]     — stale overlap carry
    key: torch.Tensor       # int64 [2] — the reference's uint32 flip key
    draws: torch.Tensor     # int64 [3, n_stages, 2, n_flips] — the port's
                            # flip positions by (edge, src, send|recv, i)


class GoodSlabs(NamedTuple):
    """The last VERIFIED decoded boundary slab per ring edge: what a failed
    verdict substitutes (each ``[D, S, 1, V_loc, h]`` on a ring)."""
    q: torch.Tensor
    u: torch.Tensor
    p: torch.Tensor


def null_controls(n_stages: int, seqno=0, prev_obj: float = float("inf"),
                  *, device=None, into: Optional[FaultControls] = None
                  ) -> FaultControls:
    """All-clear controls: what a ``health=True, faults=None`` step runs on
    every tick. ``seqno`` is an int or an int32 tensor on ``device``.
    Built by fills on the device, so no host copy and no sync. ``into``
    (all-clear controls made before, whose addresses a captured graph
    reads) gets the tick's seqno and objective written in and is
    returned."""
    if into is not None:
        if isinstance(seqno, torch.Tensor):
            into.seqno.copy_(seqno)
        else:
            into.seqno.fill_(int(seqno))
        into.prev_obj.fill_(float(prev_obj))
        return into
    device = resolve_device(device)
    z = torch.zeros((3, n_stages), dtype=torch.int32, device=device)
    seq = (seqno.to(torch.int32) if isinstance(seqno, torch.Tensor)
           else torch.full((), int(seqno), dtype=torch.int32, device=device))
    return FaultControls(
        seqno=seq,
        prev_obj=torch.full((), float(prev_obj), dtype=torch.float32,
                            device=device),
        flip=z, sneaky=z,
        drop=torch.zeros((3, n_stages), dtype=torch.bool, device=device),
        delay=torch.zeros((n_stages,), dtype=torch.bool, device=device),
        key=torch.zeros((2,), dtype=torch.int64, device=device),
        draws=torch.zeros((3, n_stages, 2, 0), dtype=torch.int64,
                          device=device))


def flip_draws(key: np.ndarray, n_flips: int, send: np.ndarray,
               recv: np.ndarray) -> np.ndarray:
    """The port's flip positions for one tick: int64 [3, n_stages, 2,
    n_flips], entry ``[e, s, side, i]`` the i-th draw of
    ``np.random.default_rng((key[0], key[1], e, s, side))`` in
    [0, DRAW_RANGE). Drawn only where ``send`` (side 0, sneaky at the
    sender s) or ``recv`` (side 1, link flip from the source s) is set,
    zero elsewhere (an inactive flip XORs nothing)."""
    n_stages = send.shape[1]
    out = np.zeros((3, n_stages, 2, int(n_flips)), np.int64)
    k0, k1 = int(key[0]), int(key[1])
    for side, act in ((0, send), (1, recv)):
        for e, s in zip(*np.nonzero(act)):
            rng = np.random.default_rng((k0, k1, int(e), int(s), side))
            out[e, s, side] = rng.integers(0, DRAW_RANGE, size=int(n_flips),
                                           dtype=np.int64)
    return out


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded deterministic chaos schedule. Every draw is a pure function of
    ``(seed, tick)`` (``np.random.default_rng((seed, tick))``), so the host
    can re-enumerate the exact injected events (:meth:`events`) for
    accounting, and two runs with the same seed suffer the same faults.

    Rates are per (edge, source stage, tick) Bernoulli probabilities.
    ``blackouts`` silences every outgoing slab of a stage for a tick
    window: ``(stage, start_tick, n_ticks)``."""
    seed: int = 0
    flip_rate: float = 0.0        # detectable: flips AFTER the checksum
    flips_per_event: int = 1      # bit positions XORed per flip event
    sneaky_rate: float = 0.0      # undetectable: flips BEFORE the checksum
    drop_rate: float = 0.0        # slab lost on the link
    delay_rate: float = 0.0       # overlap carry not refreshed (per stage)
    blackouts: Tuple[Tuple[int, int, int], ...] = ()

    def _draw(self, tick: int, n_stages: int):
        """One tick's raw Bernoulli fields and flip key, with the class
        exclusion of the module docstring applied."""
        rng = np.random.default_rng((int(self.seed), int(tick)))
        drops = rng.random((3, n_stages)) < self.drop_rate
        flips = rng.random((3, n_stages)) < self.flip_rate
        sneaky = rng.random((3, n_stages)) < self.sneaky_rate
        delays = rng.random(n_stages) < self.delay_rate
        key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
        for (stage, start, n) in self.blackouts:
            if start <= tick < start + n:
                drops[:, stage] = True
        # drop > flip > sneaky per (edge, src); a delayed carry shadows the
        # next tick's q/u faults from the same source. The delay exclusion
        # reads the PRISTINE drops, so `_draw_delays` is an exact one-tick
        # recursion.
        delays &= ~drops[0] & ~drops[1]
        flips &= ~drops
        sneaky &= ~drops & ~flips
        if tick > 0:
            prev = self._draw_delays(tick - 1, n_stages)
            for fld in (drops, flips, sneaky):
                fld[:2, prev] = False
        return drops, flips, sneaky, delays, key

    def _draw_delays(self, tick: int, n_stages: int) -> np.ndarray:
        rng = np.random.default_rng((int(self.seed), int(tick)))
        rng.random((3, n_stages))          # drops
        rng.random((3, n_stages))          # flips
        rng.random((3, n_stages))          # sneaky
        raw = rng.random(n_stages) < self.delay_rate
        drops = self._draw_drops_only(tick, n_stages)
        return raw & ~drops[0] & ~drops[1]

    def _draw_drops_only(self, tick: int, n_stages: int) -> np.ndarray:
        rng = np.random.default_rng((int(self.seed), int(tick)))
        drops = rng.random((3, n_stages)) < self.drop_rate
        for (stage, start, n) in self.blackouts:
            if start <= tick < start + n:
                drops[:, stage] = True
        return drops

    @property
    def active(self) -> bool:
        """Whether this plan can ever inject anything (a zero-rate plan still
        runs the injection machinery, as the identity)."""
        return (self.flip_rate > 0 or self.sneaky_rate > 0
                or self.drop_rate > 0 or self.delay_rate > 0
                or bool(self.blackouts))

    def controls(self, tick: int, n_stages: int, *,
                 prev_obj: float = float("inf"), device=None,
                 into: Optional[FaultControls] = None) -> FaultControls:
        """The control block for one tick, on ``device`` (default: the
        card), each field copied from pinned host memory without a sync;
        into the tensors of ``into`` (an earlier tick's block, whose
        addresses a captured graph reads) when given."""
        drops, flips, sneaky, delays, key = self._draw(tick, n_stages)
        draws = flip_draws(key, self.flips_per_event, sneaky, flips)
        host = FaultControls(
            seqno=np.asarray(tick, np.int32),
            prev_obj=np.asarray(prev_obj, np.float32),
            flip=flips.astype(np.int32), sneaky=sneaky.astype(np.int32),
            drop=drops, delay=delays, key=key.astype(np.int64),
            draws=draws)
        if into is not None:
            return FaultControls(*(to_device(a, b.device, b)
                                   for a, b in zip(host, into)))
        device = resolve_device(device)
        return FaultControls(*(to_device(a, device) for a in host))

    def events(self, tick: int, n_stages: int):
        """Host-side list of the events injected at ``tick``:
        ``(edge_name, src_stage, kind)``, kind in {"drop", "flip",
        "sneaky", "delay"} (a blackout surfaces as drops on every edge)."""
        drops, flips, sneaky, delays, _ = self._draw(tick, n_stages)
        ev = []
        for kind, fld in (("drop", drops), ("flip", flips),
                          ("sneaky", sneaky)):
            for e in range(3):
                for s in range(n_stages):
                    if fld[e, s]:
                        ev.append((EDGES[e], s, kind))
        for s in range(n_stages):
            if delays[s]:
                # a stale carry fails BOTH forward slabs' seqno checks
                ev.append((EDGES[0], s, "delay"))
                ev.append((EDGES[1], s, "delay"))
        return ev

    def trace(self, n_ticks: int, n_stages: int):
        """events() over ticks [0, n_ticks) as ``(tick, edge, src, kind)``."""
        return [(t, e, s, k) for t in range(int(n_ticks))
                for (e, s, k) in self.events(t, n_stages)]


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Rollback policy of the fault-tolerant training loops."""
    cooldown: int = 4        # control steps forced to the widest width
    max_rollbacks: int = 8   # raise after this many (divergence, not chaos)


# ---------------------------------------------------------------------------
# Checksum and bit flips
# ---------------------------------------------------------------------------

_SIGNED_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _leaves(payload) -> List[torch.Tensor]:
    if isinstance(payload, torch.Tensor):
        return [payload]
    return [t for t in payload if t is not None]


def _word_sum(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Wraparound int32 sum of the payload's raw container words (uint8 /
    uint16 zero-extended, float32 bit-cast) over all but the leading
    ``batch_dims`` axes. ``sum(dtype=torch.int32)`` is exact modulo 2**32
    on the CPU and on the card (integer addition in any order), which is
    the reference's int32 ``jnp.sum``; it reads the payload once."""
    if x.dtype == torch.uint8 or x.dtype == torch.int32:
        w = x
    elif x.element_size() == 2 and not x.is_floating_point():
        w = x.view(torch.int16)         # uint16 has few operations
    elif x.element_size() == 4:
        w = x.view(torch.int32)
    else:
        raise TypeError(f"no checksum word view for dtype {x.dtype}")
    w = w.reshape(*w.shape[:batch_dims], -1)
    total = w.sum(dim=-1, dtype=torch.int32)
    if w.dtype == torch.int16:          # zero-extend: +2**16 per negative
        total = total + (w < 0).sum(dim=-1, dtype=torch.int32) * 2 ** 16
    return total


def payload_checksum(payload, batch_dims: int = 0) -> torch.Tensor:
    """Wraparound int32 sum over every word of every payload leaf; the
    leading ``batch_dims`` axes index separate payloads (a ring's
    ``[data, model]`` shards). Any single-bit XOR changes it; it is not
    cryptographic, and colliding multi-word corruptions fall through to
    the finite/spike sentinels."""
    total = None
    for leaf in _leaves(payload):
        s = _word_sum(leaf, batch_dims)
        total = s if total is None else total + s
    return total


def checksum_header(payload, seqno, batch_dims: int = 0) -> torch.Tensor:
    """``[checksum, seqno]`` int32 ``[..., 2]``, the wire integrity header."""
    cs = payload_checksum(payload, batch_dims)
    seq = torch.as_tensor(seqno, dtype=torch.int32, device=cs.device)
    return torch.stack([cs, seq.expand_as(cs)], dim=-1)


def verify_header(payload, header, expected_seqno,
                  batch_dims: int = 0) -> torch.Tensor:
    """Link verdict: the checksum matches AND the slab is the expected
    tick's."""
    exp = torch.as_tensor(expected_seqno, dtype=torch.int32,
                          device=header.device)
    return ((payload_checksum(payload, batch_dims) == header[..., 0])
            & (header[..., 1] == exp))


def flip_bits(x: torch.Tensor, draws: torch.Tensor, active,
              batch_dims: int = 0) -> torch.Tensor:
    """XOR one bit of ``x``'s raw container per draw, at position
    ``draw mod (bits of the payload)``, where ``active`` is nonzero; the
    same bits otherwise. The leading ``batch_dims`` axes index separate
    payloads, and ``draws`` (``[..., n_flips]``) and ``active`` broadcast
    against them. Draws apply in order, so two at one position cancel."""
    width = 8 * x.element_size()
    raw = x.view(_SIGNED_OF_WIDTH[x.element_size()])
    batch = raw.shape[:batch_dims]
    flat = raw.reshape(*batch, -1).clone()
    nbits = flat.shape[-1] * width
    n_flips = draws.shape[-1]
    if nbits == 0 or n_flips == 0:
        return x
    draws = draws.expand(*batch, n_flips)
    pos = torch.remainder(draws, nbits)
    idx = torch.div(pos, width, rounding_mode="floor")
    mask = torch.bitwise_left_shift(torch.ones_like(pos),
                                    torch.remainder(pos, width))
    on = torch.as_tensor(active, device=x.device)
    mask = mask * (on > 0).to(torch.int64).expand(batch).unsqueeze(-1)
    if width > 8:                       # two's complement of the top bit
        mask = torch.where(mask >= 2 ** (width - 1), mask - 2 ** width, mask)
    mask = mask.to(flat.dtype)
    for i in range(n_flips):
        at = idx[..., i:i + 1]
        flat.scatter_(-1, at, flat.gather(-1, at) ^ mask[..., i:i + 1])
    return flat.reshape(raw.shape).view(x.dtype)


def flip_payload(payload, draws, active, batch_dims: int = 0):
    """Corrupt the CODE BODY of a wire payload (the codes of a
    :class:`WirePayload`, or a container tensor); codec headers (scale,
    offset) fly untouched."""
    if isinstance(payload, WirePayload):
        return payload._replace(codes=flip_bits(payload.codes, draws, active,
                                                batch_dims))
    return flip_bits(payload, draws, active, batch_dims)


# ---------------------------------------------------------------------------
# Sentinel-wrapped boundary exchange
# ---------------------------------------------------------------------------

class SentinelFly(NamedTuple):
    """An in-flight sentinel slab: the ring's shift handle for the payload
    parts and the header, and, for a delayed delivery, the previous raw
    arrival to keep where ``late`` is set."""
    handle: object
    n_parts: int
    held: Optional[tuple] = None        # (late [S_loc] bool, raw parts)


class SentinelExchange:
    """A ring boundary exchange with the integrity header and the fault
    injector around it, over a codec wire (``codec=``) or a padded
    container (``wire=``, :class:`~repro_torch.comm.transport.PaddedWire`).
    ``edge`` indexes :data:`EDGES` and selects this exchange's row of every
    control mask.

    ``start`` encodes a boundary slab (``[D, S, 1, V_loc, h]`` on the
    ring), applies send-time faults, stamps the header and starts the
    shift; ``finish`` applies receive-time faults, verifies, decodes and
    substitutes ``good`` on a failed verdict. With ``plan=None`` the header
    machinery runs (health sentinels without chaos) and no injection does.
    The controls are read on the device only, indexed by slices and rolls
    (the ring holds every stage, or one)."""

    def __init__(self, ring, axis_name: str, edge: int, *, codec=None,
                 wire=None, plan: Optional[FaultPlan] = None, tag: int = 0):
        self.ring, self.axis_name, self.edge = ring, axis_name, edge
        self.codec, self.wire, self.plan, self.tag = codec, wire, plan, tag
        self.n = ring.axis_size(axis_name)
        self.stages = ring.axis_index(axis_name)
        if self.stages != list(range(self.n)) and len(self.stages) != 1:
            raise ValueError(f"a ring holding stages {self.stages} of "
                             f"{self.n}: expected all or one")

    def pick(self, row: torch.Tensor, delta: int = 0) -> torch.Tensor:
        """``row[(s - delta) % n]`` along dim 0 for each local stage s:
        ``delta=0`` the stage's own entry, ``delta=±1`` its source's."""
        return stage_entries(row, self.stages, self.n, delta)

    @staticmethod
    def _per_stage(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """[S_loc] -> broadcastable against ``like`` [D, S_loc, ...]."""
        return v.reshape(1, -1, *([1] * (like.dim() - 2)))

    def _encode(self, slab, sel):
        if self.wire is not None:
            return self.wire.encode(slab, sel)
        return encode_slab(self.codec, slab)

    def _decode(self, payload, shape, dtype, sel_src):
        if self.wire is not None:
            return self.wire.decode(payload, sel_src, shape, dtype)
        return decode_slab(self.codec, payload, shape, dtype)

    def _payload(self, parts):
        if self.wire is not None:
            return parts[0]
        return WirePayload(*(list(parts) + [None] * (3 - len(parts))))

    def start(self, slab, ctl: FaultControls, delta: int,
              sel=None) -> SentinelFly:
        """Encode, apply sneaky (pre-checksum) flips, stamp the header and
        start the shift; ``delta`` is the direction (+1 from the previous
        stage, -1 from the next)."""
        payload = self._encode(slab, sel)
        if self.plan is not None:
            payload = flip_payload(
                payload, self.pick(ctl.draws[self.edge, :, 0])[None],
                self.pick(ctl.sneaky[self.edge])[None], batch_dims=2)
        header = checksum_header(payload, ctl.seqno, batch_dims=2)
        parts = _leaves(payload)
        handle = self.ring.shift(parts + [header], delta, self.axis_name,
                                 self.tag)
        return SentinelFly(handle, len(parts))

    def finish(self, fly: SentinelFly, ctl: FaultControls, expected_seqno,
               shape, dtype, good, delta: int, sel_src=None):
        """Receive-time faults (link flip and drop, by SOURCE stage),
        verdict, decode, and ``good`` where the verdict fails. Returns
        ``(boundary, ok [D, S_loc], raw)``, ``raw`` the arrived tensors
        before any receive-time fault (what a delayed carry keeps)."""
        raw = list(self.ring.finish(fly.handle))
        if fly.held is not None:
            late, old = fly.held
            raw = [torch.where(self._per_stage(late, a), o, a)
                   for o, a in zip(old, raw)]
        payload, header = self._payload(raw[:fly.n_parts]), raw[fly.n_parts]
        if self.plan is not None:
            payload = flip_payload(
                payload, self.pick(ctl.draws[self.edge, :, 1], delta)[None],
                self.pick(ctl.flip[self.edge], delta)[None], batch_dims=2)
        ok = verify_header(payload, header, expected_seqno, batch_dims=2)
        if self.plan is not None:
            ok = ok & ~self.pick(ctl.drop[self.edge], delta)[None]
        boundary = self._decode(payload, shape, dtype, sel_src)
        ok_b = ok.reshape(*ok.shape, *([1] * (boundary.dim() - 2)))
        return torch.where(ok_b, boundary, good), ok, raw
