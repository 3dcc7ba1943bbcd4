"""Per-device statistics of one recorded step: flops, bytes and collective
payloads.

Counterpart of ``repro.analysis.hlo`` (``analyze``, ``HloStats``,
``coll_summary``, ``analyze_collectives``). The reference parses the
compiled HLO module text of a jitted step, with loop-trip multipliers
because XLA's cost analysis counts a ``while`` body once. A step of the
port is eager, so this module reads a recorded step instead of HLO text:
a :class:`~repro_torch.analysis.torch_trace.StepProgram`, where every op
that ran is one record and no loop needs a multiplier.

Per device means per shard: the recorder sums a ``LocalRing``'s tensors
over every shard it holds, and each total here is divided by the shard
count (``StepProgram.n_shards``), as HLO's per-device module is.

  * ``flops`` — matmul flops (``2·M·N·K``) of the matmul records and of
    the matmuls inside each kernel's scope. On the CPU a kernel's scope
    runs its plain version, whose matmuls count; on the card a kernel is
    one opaque launch, so a step recorded there counts only the matmuls
    left to PyTorch.
  * ``dot_bytes`` — operand and result bytes of those matmuls (HLO's
    ``dot_bytes``, a lower bound on the step's traffic).
  * ``bytes_written`` — output bytes of every other op and kernel scope
    (the recorder's ``bytes``); HLO's ``hbm_bytes`` counts operands too.
  * ``collectives`` — one :class:`Collective` per tensor a collective
    moved, under HLO's kind names (:data:`HLO_KINDS`), with its payload
    bytes per device (the result's, as HLO reports: an all-gather's is
    the gathered tensor, a reduce-scatter's the scattered piece) and its
    group size: the ring's collectives and the ``_c10d_functional`` ones
    DTensor issues on a mesh.

:func:`memory_analysis` gives a recorded step the reference's
``compiled.memory_analysis()`` keys from the recorder's live-bytes
high-water mark (``StepRecorder(memory=True)``). That mark counts the
storages PyTorch objects hold, in bytes as asked: it leaves out the
caching allocator's rounding and reserve, the communicator's own buffers,
and any kernel's workspace (cuBLAS, the flash kernel's scratch).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List

HLO_KINDS = {"ppermute": "collective-permute", "psum": "all-reduce",
             "pmin": "all-reduce", "pmax": "all-reduce",
             "all_gather": "all-gather",
             # DTensor's (torch.ops._c10d_functional)
             "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_reduce_coalesced": "all-reduce",
             "all_reduce_coalesced_": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_out": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class Collective:
    kind: str                # HLO kind name
    computation: str         # the CommLedger edge of a shift, else the prim
    payload_bytes: int       # per device, the result's
    group_size: int

    @property
    def moved_bytes(self) -> float:
        """Bytes a ring schedule puts on the fabric per device (hlo.py's
        model, term for term; a recorded step needs no loop-trip
        multiplier)."""
        n, b = self.group_size, self.payload_bytes
        if n <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n * b
        if self.kind == "all-gather":
            return (n - 1) / n * b
        if self.kind == "reduce-scatter":
            return float(n - 1) * b
        if self.kind == "all-to-all":
            return (n - 1) / n * b
        return float(b)


@dataclasses.dataclass
class ProgramStats:
    flops: float = 0.0
    dot_bytes: float = 0.0
    bytes_written: float = 0.0
    collectives: List[Collective] = dataclasses.field(default_factory=list)

    def coll_summary(self) -> dict:
        """Per-kind and total ``count`` / ``payload_bytes`` /
        ``moved_bytes``: ``HloStats.coll_summary``'s layout."""
        by_kind = defaultdict(lambda: {"count": 0, "payload_bytes": 0,
                                       "moved_bytes": 0.0})
        for c in self.collectives:
            d = by_kind[c.kind]
            d["count"] += 1
            d["payload_bytes"] += c.payload_bytes
            d["moved_bytes"] += c.moved_bytes
        total = {k: sum(d[k] for d in by_kind.values())
                 for k in ("count", "payload_bytes", "moved_bytes")}
        return {"by_kind": {k: dict(v) for k, v in by_kind.items()},
                "total": total}


def analyze(program) -> ProgramStats:
    """The per-device statistics of a recorded step."""
    n = max(int(program.n_shards), 1)
    stats = ProgramStats()
    for r in program.records:
        stats.flops += r.flops / n
        stats.dot_bytes += r.dot_bytes / n
        stats.bytes_written += r.bytes / n
        if r.kind != "collective":
            continue
        for _, nbytes in r.moves:
            result = nbytes * r.group if r.prim == "all_gather" else nbytes
            stats.collectives.append(Collective(
                HLO_KINDS[r.prim], r.edge or r.prim, int(result), r.group))
    return stats


def analyze_collectives(program):
    """``(collectives, coll_summary)`` of a recorded step."""
    st = analyze(program)
    return st.collectives, st.coll_summary()


def memory_analysis(program, output_bytes: int, made_output_bytes: int,
                    alias_bytes: int) -> dict:
    """The reference's memory keys for one recorded step (``program`` from
    a ``StepRecorder(memory=True)`` that held the step's arguments).

    ``argument_bytes`` are the arguments' storages, ``output_bytes`` the
    outputs', of which ``made_output_bytes`` were made by the step (an
    output written in place into an argument was not). ``temp_bytes`` is
    the high-water mark of what the step made, less the outputs it made;
    ``alias_bytes`` (outputs in donated or written-in-place arguments) is
    the caller's; ``peak_live_bytes`` is the reference's
    argument + output + temp − alias."""
    mem = program.memory
    made_peak = mem["peak_bytes"] - mem["arg_bytes"]
    temp = max(made_peak - made_output_bytes, 0)
    return {"argument_bytes": mem["arg_bytes"], "output_bytes": output_bytes,
            "alias_bytes": alias_bytes, "temp_bytes": temp,
            "peak_live_bytes": (mem["arg_bytes"] + output_bytes + temp
                                - alias_bytes)}
