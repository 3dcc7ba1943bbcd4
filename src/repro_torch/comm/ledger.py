"""CommLedger — the single source of truth for bytes on the wire.

Counterpart of ``repro.comm.ledger`` (pure Python; the port keeps its own
copy). Every payload that crosses a link is recorded with exact byte
counts from its codec (``payload_bytes`` includes headers and int4
packing), so examples, benchmarks and budgets read totals from one place.

Every record carries a physical-vs-logical split:

  * ``payload_bytes`` (logical) — what the codec's math implies the payload
    occupies (packed body + header): the compression story.
  * ``wire_bytes`` (physical) — what the message occupies on the link (a
    wider container, a padded wire); defaults to ``payload_bytes``.

Fault events are kept apart from the byte records (``FaultRecord``), so a
corrupted payload never skews the wire totals.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class WireRecord:
    iteration: int
    edge: str            # e.g. "q_fwd/l3", "grad_psum/W0"
    kind: str            # "ppermute" | "psum" | "handshake" | "header"
    elements: int
    bits: int
    payload_bytes: int   # logical: codec body (packed/container) + header
    wire_bytes: int = -1   # physical bytes on the link (-1 -> == payload)

    def __post_init__(self):
        if self.wire_bytes < 0:
            object.__setattr__(self, "wire_bytes", self.payload_bytes)


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One fault-accounting event: ``kind`` is the lifecycle stage —
    ``injected``, ``detected``, ``recovered`` or ``rolled_back``;
    ``iteration`` is the fault-plan tick, ``edge`` a ring edge name or
    ``"step"`` for a rollback."""
    iteration: int
    edge: str
    kind: str
    count: int = 1
    detail: str = ""


class CommLedger:
    """Append-only wire-byte ledger with per-iteration / per-edge rollups
    (plus a separate fault-event ledger, see :class:`FaultRecord`)."""

    def __init__(self):
        self.records: List[WireRecord] = []
        self.faults: List[FaultRecord] = []

    # -- recording ---------------------------------------------------------
    def record(self, iteration: int, edge: str, kind: str, elements: int,
               bits: int, payload_bytes: Optional[int] = None,
               wire_bytes: Optional[int] = None) -> WireRecord:
        if payload_bytes is None:  # logical size, no header
            payload_bytes = math.ceil(elements * bits / 8)
        rec = WireRecord(iteration, edge, kind, int(elements), int(bits),
                         int(payload_bytes),
                         -1 if wire_bytes is None else int(wire_bytes))
        self.records.append(rec)
        return rec

    def record_payload(self, iteration: int, edge: str, kind: str, codec,
                       shape: Sequence[int]) -> WireRecord:
        """Record one codec-formatted payload of a given shape."""
        n = int(math.prod(int(s) for s in shape))
        return self.record(iteration, edge, kind, n, codec.bits,
                           codec.payload_bytes(shape))

    def record_handshake(self, iteration: int, edge: str,
                         n_scalars: int = 2) -> WireRecord:
        """Scalar fp32 exchange (e.g. shared min/max for a psum grid)."""
        return self.record(iteration, edge, "handshake", n_scalars, 32,
                           4 * n_scalars)

    def record_fault(self, iteration: int, edge: str, kind: str,
                     count: int = 1, detail: str = "") -> FaultRecord:
        """Append one fault lifecycle event, apart from the byte records."""
        rec = FaultRecord(int(iteration), edge, kind, int(count), detail)
        self.faults.append(rec)
        return rec

    def record_span(self, start_iteration: int, n_iterations: int, edge: str,
                    kind: str, elements: int, bits: int,
                    payload_bytes: Optional[int] = None,
                    wire_bytes: Optional[int] = None) -> List[WireRecord]:
        """Record the same per-iteration payload once for each iteration in
        [start, start + n): what n individual ``record`` calls give."""
        return [self.record(start_iteration + i, edge, kind, elements, bits,
                            payload_bytes, wire_bytes)
                for i in range(int(n_iterations))]

    # -- rollups -----------------------------------------------------------
    def total_bytes(self) -> int:
        """Logical (codec-accounted) bytes — the compression story."""
        return sum(r.payload_bytes for r in self.records)

    def total_wire_bytes(self) -> int:
        """Physical bytes on the links."""
        return sum(r.wire_bytes for r in self.records)

    def per_edge_wire(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            out[r.edge] += r.wire_bytes
        return dict(out)

    def iteration_bytes(self, iteration: int) -> int:
        return sum(r.payload_bytes for r in self.records
                   if r.iteration == iteration)

    def per_iteration(self) -> Dict[int, int]:
        out: Dict[int, int] = defaultdict(int)
        for r in self.records:
            out[r.iteration] += r.payload_bytes
        return dict(out)

    def per_edge(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            out[r.edge] += r.payload_bytes
        return dict(out)

    def per_edge_iteration_wire(self, iteration: int) -> Dict[str, int]:
        """Physical wire bytes per edge for one iteration."""
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            if r.iteration == iteration:
                out[r.edge] += r.wire_bytes
        return dict(out)

    def fault_counts(self) -> Dict[str, Dict[str, int]]:
        """``{edge: {kind: count}}`` rollup of the fault ledger."""
        out: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for f in self.faults:
            out[f.edge][f.kind] += f.count
        return {e: dict(k) for e, k in out.items()}

    def baseline_fp32_bytes(self) -> int:
        """What the same traffic would cost uncompressed (handshakes and
        integrity headers count 0 in the baseline)."""
        return sum(4 * r.elements for r in self.records
                   if r.kind not in ("handshake", "header"))

    def savings_vs_fp32(self) -> float:
        base = self.baseline_fp32_bytes()
        return 1.0 - self.total_bytes() / base if base else 0.0

    def summary(self) -> Dict:
        its = self.per_iteration()
        out = {
            "total_bytes": self.total_bytes(),
            "wire_bytes": self.total_wire_bytes(),
            "payload_bytes_physical": self.total_wire_bytes(),
            "baseline_fp32_bytes": self.baseline_fp32_bytes(),
            "savings_vs_fp32": self.savings_vs_fp32(),
            "iterations": len(its),
            "bytes_per_iteration": (self.total_bytes() / len(its)) if its
            else 0.0,
            "by_edge": self.per_edge(),
        }
        if self.faults:   # only runs with fault events grow this key
            out["faults"] = self.fault_counts()
        return out

    def merge(self, other: "CommLedger") -> "CommLedger":
        self.records.extend(other.records)
        self.faults.extend(other.faults)
        return self


def record_admm_iteration(ledger: CommLedger, iteration: int, dims, V: int,
                          p_codecs, q_codecs, u_codec=None) -> None:
    """Record one pdADMM-G iteration of layer-client traffic (Fig-5 wire
    model): per boundary l<->l+1, q_l forward, u_l forward, p_{l+1} backward.

    ``p_codecs``/``q_codecs``/``u_codec`` are either one codec for every
    boundary or a sequence with one codec per boundary.
    """
    from repro_torch.comm.codecs import FP32
    u_codec = FP32 if u_codec is None else u_codec
    n_bound = len(dims) - 2

    def per(c, l):
        return c[l] if isinstance(c, (list, tuple)) else c

    for l in range(n_bound):
        shape = (V, dims[l + 1])
        ledger.record_payload(iteration, f"q_fwd/l{l}", "ppermute",
                              per(q_codecs, l), shape)
        ledger.record_payload(iteration, f"u_fwd/l{l}", "ppermute",
                              per(u_codec, l), shape)
        ledger.record_payload(iteration, f"p_bwd/l{l}", "ppermute",
                              per(p_codecs, l), shape)


def admm_bytes_per_iteration(dims, V: int, p_codecs, q_codecs,
                             u_codec=None) -> int:
    """Exact wire bytes of ONE pdADMM-G iteration under the Fig-5 model —
    ``record_admm_iteration`` on a scratch ledger."""
    led = CommLedger()
    record_admm_iteration(led, 0, dims, V, p_codecs, q_codecs, u_codec)
    return led.total_bytes()
