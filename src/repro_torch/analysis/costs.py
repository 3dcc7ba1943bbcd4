"""Measured per-op wall-time costs and the parametric link model: the cost
half of the replay cost model (:mod:`repro_torch.analysis.replay`).

Counterpart of ``repro.analysis.costs``. A :class:`CostTable` is a flat
``{key: seconds-or-rate}`` mapping, measured by timed micro-runs (warm-up,
then the median of repeated batches, so one scheduler hiccup never
poisons an entry) and saved as JSON in the reference's format, so either
package reads the other's table. The replay DAG attaches costs through
these keys:

  * ``rate:dot_flops``        — dense-contraction throughput (flop/s);
    a matmul costs ``flops / rate``.
  * ``rate:eltwise_bytes``    — streaming elementwise throughput (byte/s);
    any other op costs ``out_bytes / rate``.
  * ``rate:op_overhead``      — fixed cost per recorded op or kernel
    launch (s), in the DAG's units (see ``replay.calibrate``).
  * ``collective:<prim>``     — critical-path toll of one BLOCKING
    collective (``ppermute``/``psum``/``all_gather``), measured as the
    increment of a chain of collectives over the same chain without them.
  * ``collective:<prim>:issue`` — cost of ISSUING the same collective
    whose consumer is an iteration away (an overlapped start).
  * ``step:dispatch``         — fixed per-step host dispatch overhead (s).
  * ``link:latency`` / ``link:bandwidth`` — the :class:`LinkModel`
    parameters (s, byte/s).

Missing keys fall back to :data:`DEFAULT_ENTRIES` (the reference's rough
numbers), so a replay without calibration still gives a finite, ordered
prediction; calibrate before trusting magnitudes.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """``time = latency + wire_bytes / bandwidth`` for one message on one
    link, fed by the same ``wire_bytes`` the :class:`CommLedger` charges."""
    latency_s: float = 50e-6
    bandwidth_Bps: float = 4e9

    def transfer_time(self, wire_bytes: float) -> float:
        return self.latency_s + float(wire_bytes) / self.bandwidth_Bps


DEFAULT_ENTRIES: Dict[str, float] = {
    "rate:dot_flops": 5e9,
    "rate:eltwise_bytes": 2e9,
    "rate:op_overhead": 2e-7,
    "collective:ppermute": 500e-6,
    "collective:psum": 500e-6,
    "collective:all_gather": 500e-6,
    "collective:ppermute:issue": 20e-6,
    "collective:psum:issue": 20e-6,
    "collective:all_gather:issue": 20e-6,
    "step:dispatch": 200e-6,
    "link:latency": 50e-6,
    "link:bandwidth": 4e9,
}


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2,
          reps: int = 3, device=None) -> float:
    """Mean seconds per call of ``fn(*args)``: ``warmup`` untimed calls,
    then ``reps`` timed batches of ``iters`` calls; the MEDIAN batch is
    returned. On CUDA each batch is clocked by CUDA events and ends in
    ``torch.cuda.synchronize()``; on the CPU (only when ``device="cpu"``
    is asked for) by ``time.perf_counter``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    for _ in range(max(1, warmup)):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(max(1, reps)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            stop.record()
            torch.cuda.synchronize(dev)
            samples.append(start.elapsed_time(stop) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            samples.append((time.perf_counter() - t0) / iters)
    samples.sort()
    return samples[len(samples) // 2]


class CostTable:
    """Measured per-op costs, JSON-persistable. Missing keys fall back to
    :data:`DEFAULT_ENTRIES` (and to :meth:`get`'s ``default`` for keys
    that have none)."""

    def __init__(self, entries: Optional[Dict[str, float]] = None,
                 meta: Optional[Dict] = None):
        self.entries: Dict[str, float] = dict(entries or {})
        self.meta: Dict = dict(meta or {})

    def get(self, key: str, default: Optional[float] = None) -> float:
        if key in self.entries:
            return float(self.entries[key])
        if key in DEFAULT_ENTRIES:
            return float(DEFAULT_ENTRIES[key])
        if default is None:
            raise KeyError(f"no cost entry {key!r} and no default")
        return float(default)

    def set(self, key: str, seconds: float) -> None:
        self.entries[key] = float(seconds)

    def measure(self, key: str, fn: Callable, *args, iters: int = 10,
                warmup: int = 2, reps: int = 3, device=None) -> float:
        """Time ``fn(*args)`` (see :func:`timed`) and store it under
        ``key``; returns the measured seconds per call."""
        t = timed(fn, *args, iters=iters, warmup=warmup, reps=reps,
                  device=device)
        self.set(key, t)
        return t

    @property
    def link(self) -> LinkModel:
        return LinkModel(self.get("link:latency"), self.get("link:bandwidth"))

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        Path(path).write_text(json.dumps(
            {"entries": self.entries, "meta": self.meta}, indent=2,
            sort_keys=True) + "\n")

    @classmethod
    def load(cls, path) -> "CostTable":
        data = json.loads(Path(path).read_text())
        return cls(data.get("entries", {}), data.get("meta", {}))
