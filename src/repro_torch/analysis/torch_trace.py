"""Step recorder: what one call of an eager step does, in order — the
port's counterpart of walking a jitted step's jaxpr
(``repro.analysis.jaxpr_tools``).

A step of the port is eager Python, so its "program" is the sequence of
operations one call runs. :class:`StepRecorder` records it three ways at
once:

  * every aten op, through a ``TorchDispatchMode``: matmul-family ops
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot`` — what
    ``matmul`` decomposes to) with their flops ``2·M·N·K`` from the
    shapes, every other op with its output bytes (as the reference's
    ``_out_bytes`` charges each eqn);
  * every kernel call, through ``kernels.ops.scope``: one
    :class:`Record` of kind ``"kernel"`` per launch the card would make,
    which takes the flops and bytes of the ops its plain version runs
    (so a trace on the CPU counts the card's launches — the reference's
    ``n_pallas``);
  * every collective, through :class:`RecordingRing`, a proxy around the
    step's ring: one record per ``shift`` (prim ``ppermute``), ``psum``,
    ``pmin``, ``pmax`` and ``all_gather``, with the wire dtype, the bytes
    it moves over all the shards this process holds, and for a shift the
    CommLedger edge name its tag stands for. The ring's own work inside a
    collective (a ``LocalRing`` shift is a ``torch.roll``) is the
    collective, not compute, and is not recorded again.

Consumption. The recorder keeps the storages of each collective's outputs
(``untyped_storage()`` identity, so a view is the same storage; the
outputs of a shift are what ``finish`` returns). The first later record
that reads one of them is the event's consumer; ``work_to_consumer``
counts the matmul and kernel records between issue and consumer, and an
event whose outputs are never read within the step is ``carried`` — the
classification of ``jaxpr_tools.collective_profile``. A ``finish`` of a
handle the recorder did not issue (an overlapped carry started in the
previous step) records nothing, as the reference's entry decode of its
carry is no collective.

Trace under :func:`fake_mode` (a ``FakeTensorMode``) and nothing computes: a
full-size step traces on the CPU in a moment, through the plain versions
of the kernels, which count the same launches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops

MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv")
WORK_KINDS = ("matmul", "kernel")

# ring-shift tags of the stage step -> the CommLedger's edge names
STAGE_EDGES = {0: "q_fwd", 1: "u_fwd", 2: "p_bwd"}


@dataclasses.dataclass
class Record:
    """One entry of a recorded step, in program order.

    ``kind``: ``"matmul"`` / ``"op"`` (an aten op outside any kernel),
    ``"kernel"`` (one launch; ``flops``/``bytes`` are those of the ops
    inside its scope) or ``"collective"``. Collectives carry ``prim``,
    ``dtype``, ``wire_bytes`` (over every shard held here), ``edge``,
    ``delta`` (a shift's ring step), and after the trace ``consumer``
    (index of the first reading record, ``None`` if carried) and
    ``work_to_consumer``."""
    kind: str
    name: str
    flops: float = 0.0
    bytes: float = 0.0
    prim: Optional[str] = None
    dtype: Optional[str] = None
    wire_bytes: int = 0
    edge: Optional[str] = None
    delta: int = 0
    consumer: Optional[int] = None
    work_to_consumer: int = 0

    @property
    def carried(self) -> bool:
        return self.kind == "collective" and self.consumer is None


@dataclasses.dataclass
class StepProgram:
    """The recorded step: its records and the shards the ring holds (the
    unit ``replay.extract_step_dag`` divides flops and bytes by)."""
    records: List[Record]
    n_shards: int = 1

    def launch_counts(self) -> Dict[str, int]:
        """Kernel name -> launches one call of the step makes."""
        out: Dict[str, int] = {}
        for r in self.records:
            if r.kind == "kernel":
                out[r.name] = out.get(r.name, 0) + 1
        return out

    def collectives(self, prim: Optional[str] = None) -> List[Record]:
        return [r for r in self.records if r.kind == "collective"
                and (prim is None or r.prim == prim)]

    def collective_profile(self, prim: str = "ppermute") -> List[dict]:
        """``jaxpr_tools.collective_profile``'s rows for ``prim``."""
        return [{"dtype": r.dtype, "carried": r.carried,
                 "work_to_consumer": r.work_to_consumer}
                for r in self.collectives(prim)]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _matmul_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]                  # (bias, a, b)
    a, b = args[0], args[1]
    if name == "dot":
        return 2.0 * a.shape[0]
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _out_bytes(out) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(out)))


class _Handle:
    """A shift issued under the recorder: the ring's own handle and the
    index of its record."""
    __slots__ = ("inner", "index")

    def __init__(self, inner, index: int):
        self.inner, self.index = inner, index


class StepRecorder(TorchDispatchMode):
    """Record one step (see the module docstring). Use as a context
    manager around the call; :attr:`program` holds the result."""

    def __init__(self, n_shards: int = 1, edges: Optional[dict] = None):
        super().__init__()
        self.records: List[Record] = []
        self.n_shards = int(n_shards)
        self.edges = STAGE_EDGES if edges is None else dict(edges)
        self._pending: Dict[int, List[int]] = {}   # storage -> record indices
        self._keep: List[torch.Tensor] = []        # pin tracked storages
        self._kernel: Optional[int] = None         # the open kernel record
        self._depth = 0                            # nested kernel scopes
        self._quiet = 0                            # inside a collective

    # -- lifetime ------------------------------------------------------------
    def __enter__(self):
        ops._recorders.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops._recorders.remove(self)

    @property
    def program(self) -> StepProgram:
        work = [0]
        for r in self.records:
            work.append(work[-1] + (r.kind in WORK_KINDS))
        for i, r in enumerate(self.records):
            if r.kind == "collective" and r.consumer is not None:
                # work strictly between issue i and consumer c
                r.work_to_consumer = work[r.consumer] - work[i + 1]
        return StepProgram(self.records, self.n_shards)

    # -- reads and writes ----------------------------------------------------
    def _read(self, tensors, at: int) -> None:
        """Mark the events whose outputs ``tensors`` share storage with as
        consumed at record ``at`` (the first such read only)."""
        if not self._pending:
            return
        for t in tensors:
            for i in self._pending.pop(_storage_key(t), ()):
                if self.records[i].consumer is None:
                    self.records[i].consumer = at

    def _produced(self, index: int, tensors) -> None:
        for t in tensors:
            self._pending.setdefault(_storage_key(t), []).append(index)
            self._keep.append(t)

    # -- kernel scopes (kernels.ops.scope) -----------------------------------
    def enter_kernel(self, name: str, inputs, launches: bool) -> None:
        self._depth += 1
        if self._depth > 1 or self._quiet:
            return                      # inside another kernel: one launch
        if launches:                    # else the ops inside read them
            self._kernel = len(self.records)
            self.records.append(Record("kernel", name))
            self._read([t for t in inputs if isinstance(t, torch.Tensor)],
                       self._kernel)

    def exit_kernel(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._kernel = None

    # -- aten ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        is_mm = name in MATMUL_OPS
        flops = _matmul_flops(name, args) if is_mm else 0.0
        nbytes = 0.0 if is_mm else _out_bytes(out)
        if self._kernel is not None:
            rec = self.records[self._kernel]
            rec.flops += flops
            rec.bytes += nbytes
            self._read(_tensors((args, kwargs)), self._kernel)
            return out
        if self._depth:                 # a scope that makes no launch
            self._read(_tensors((args, kwargs)), len(self.records))
            self.records.append(Record("op", name, bytes=nbytes))
            return out
        self._read(_tensors((args, kwargs)), len(self.records))
        self.records.append(Record("matmul" if is_mm else "op", name,
                                   flops=flops, bytes=nbytes))
        return out

    # -- collectives (RecordingRing) ---------------------------------------------
    def collective(self, prim: str, inputs, dtype, wire_bytes: int,
                   edge: Optional[str] = None, delta: int = 0) -> int:
        index = len(self.records)
        self._read(inputs, index)
        self.records.append(Record(
            "collective", prim, prim=prim, dtype=_dtype_name(dtype),
            wire_bytes=int(wire_bytes), edge=edge, delta=delta))
        return index


class RecordingRing:
    """The step's ring, with every collective recorded on ``recorder``;
    everything else is the wrapped ring's."""

    def __init__(self, ring, recorder: StepRecorder):
        self._ring = ring
        self._rec = recorder

    def __getattr__(self, name):
        return getattr(self._ring, name)

    def _quietly(self, fn, *args):
        self._rec._quiet += 1
        try:
            return fn(*args)
        finally:
            self._rec._quiet -= 1

    def shift(self, tensors, delta: int, axis: str = "model", tag: int = 0):
        tensors = list(tensors)
        index = self._rec.collective(
            "ppermute", tensors, tensors[0].dtype,
            sum(t.numel() * t.element_size() for t in tensors),
            edge=self._rec.edges.get(tag), delta=delta)
        return _Handle(self._quietly(self._ring.shift, tensors, delta, axis,
                                     tag), index)

    def finish(self, handle):
        if not isinstance(handle, _Handle):
            return self._ring.finish(handle)
        out = self._quietly(self._ring.finish, handle.inner)
        self._rec._produced(handle.index, out)
        return out

    def _reduce(self, prim: str, x, axes):
        index = self._rec.collective(prim, [x], x.dtype,
                                     x.numel() * x.element_size())
        out = self._quietly(getattr(self._ring, prim), x, axes)
        self._rec._produced(index, [out])
        return out

    def psum(self, x, axes):
        return self._reduce("psum", x, axes)

    def pmin(self, x, axes):
        return self._reduce("pmin", x, axes)

    def pmax(self, x, axes):
        return self._reduce("pmax", x, axes)

    def all_gather(self, x, axis: str):
        n = self._ring.axis_size(axis)
        index = self._rec.collective("all_gather", [x], x.dtype,
                                     n * x.numel() * x.element_size())
        out = self._quietly(self._ring.all_gather, x, axis)
        self._rec._produced(index, [out])
        return out


def record(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepRecorder` (one
    shard, no ring); returns ``(StepProgram, fn's result)``."""
    with StepRecorder() as rec:
        out = fn(*args, **kwargs)
    return rec.program, out


def fake_mode():
    """A ``FakeTensorMode`` for tracing: tensors made inside it carry
    shapes and dtypes but no data, and real constants mix in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)
