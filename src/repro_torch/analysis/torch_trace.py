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
    it moves over all the shards this process holds, for a shift the
    CommLedger edge name its tag stands for, and its ``moves``: one
    ``(dtype, bytes per shard)`` per tensor it carries. A jaxpr has one
    ``ppermute`` per leaf, so a sentinel shift (payload and header in one
    call) is two events of the reference's trace; the walkers below count
    moves, not calls. The ring's own work inside a collective (a
    ``LocalRing`` shift is a ``torch.roll``) is the collective, not
    compute, and is not recorded again.

Each op record also keeps the dtypes it reads and writes (``dtypes``, for
the no-float64 contract) and, for a ``copy_``, the storage it writes
(``dest``, for the donation contracts). A kernel record keeps the dtypes
of its scope's inputs only: what its plain version computes in between is
not the kernel's program (``core.quantize.mul_add`` widens to float64 on
the CPU where the kernel rounds one fused f32 multiply-add).

Consumption. The recorder keeps the storages of each collective's outputs
(``untyped_storage()`` identity, so a view is the same storage; the
outputs of a shift are what ``finish`` returns). The first later record
that reads a move's output is that move's consumer; its work counts the
matmul and kernel records between issue and consumer, and a move whose
output is never read within the step is ``carried`` — the classification
of ``jaxpr_tools.collective_profile``, which :func:`collective_profile`
reads per move. A call's ``consumer`` and ``work_to_consumer`` are its
earliest move's (what ``replay.extract_step_dag`` reads). A ``finish`` of a
handle the recorder did not issue (an overlapped carry started in the
previous step) records nothing, as the reference's entry decode of its
carry is no collective.

Trace under :func:`fake_mode` (a ``FakeTensorMode``) and nothing computes: a
full-size step traces on the CPU in a moment, through the plain versions
of the kernels, which count the same launches.

DTensors. A step on a ``DeviceMesh`` runs on DTensors, and the recorder
sees what one rank runs: an op whose arguments are DTensors is handed to
DTensor first (the mode returns ``NotImplemented``), which redistributes
its inputs and runs the op on the local shards, and those local ops and
``_c10d_functional`` collectives come back here as plain tensors. So
matmul flops are counted on local shards, and each collective DTensor
issues (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and their coalesced and
in-place forms) is one record with its group size and, per tensor, the
bytes of its result on this rank (an all-reduce's operand, an
all-gather's gathered tensor, a reduce-scatter's scattered piece). The
ops DTensor runs on global shapes to infer an output's shape are not the
rank's work and are skipped: from the first DTensor it sees, the recorder
runs DTensor's sharding propagation inside
:func:`sharding_propagation_apart`, which counts the propagations in
flight. A recorder that sees no DTensor (the stage ring's) leaves DTensor
as it is.

Memory. With ``memory=True`` the recorder keeps a live-bytes high-water
mark: every storage an op makes (and every storage :meth:`StepRecorder.
hold` is given: the step's arguments) counts from its first sight until a
weakref finalizer sees it freed. The recorder then pins no collective
output (it would keep each alive to the end); a freed output that nothing
read is carried. :attr:`StepProgram.memory` holds
``arg_bytes`` and ``peak_bytes`` (arguments included). An argument that
no op but a view or a ``prim`` reads counts in neither, as ``jax.jit``
drops unused arguments before XLA counts them.

The walkers :func:`count_primitive`, :func:`count_primitives`,
:func:`collective_profile` and :func:`ppermute_moves` are the
counterparts of ``jaxpr_tools``' over a :class:`StepProgram`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops

MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv")
WORK_KINDS = ("matmul", "kernel")
# DTensor's collectives (torch.ops._c10d_functional), by overload packet
C10D_COLLECTIVES = ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                    "all_reduce_coalesced_", "all_gather_into_tensor",
                    "all_gather_into_tensor_out",
                    "all_gather_into_tensor_coalesced",
                    "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                    "all_to_all_single")

# ring-shift tags of the stage step -> the CommLedger's edge names
STAGE_EDGES = {0: "q_fwd", 1: "u_fwd", 2: "p_bwd"}


@dataclasses.dataclass
class Record:
    """One entry of a recorded step, in program order.

    ``kind``: ``"matmul"`` / ``"op"`` (an aten op outside any kernel),
    ``"kernel"`` (one launch; ``flops``/``bytes`` are those of the ops
    inside its scope) or ``"collective"``. Collectives carry ``prim``,
    ``wire_bytes`` (over every shard held here), ``edge``, ``delta`` (a
    shift's ring step), ``moves`` (one ``(dtype, bytes per shard)`` per
    tensor), ``group`` (the shards it spans), and after the trace, per
    move, ``move_consumers`` (index of the first reading record, ``None``
    if carried) and ``move_work``. The call's ``dtype``, ``consumer`` and
    ``work_to_consumer`` derive from its moves."""
    kind: str
    name: str
    flops: float = 0.0
    bytes: float = 0.0
    prim: Optional[str] = None
    wire_bytes: int = 0
    edge: Optional[str] = None
    delta: int = 0
    moves: Tuple[Tuple[str, int], ...] = ()   # (dtype, bytes per shard)
    move_consumers: List[Optional[int]] = dataclasses.field(
        default_factory=list)
    move_work: List[int] = dataclasses.field(default_factory=list)
    group: int = 1                  # shards a collective spans
    dot_bytes: float = 0.0          # matmul operands and results
    dtypes: Tuple[str, ...] = ()    # dtypes read and written
    dest: Optional[int] = None      # storage a copy_ writes

    @property
    def dtype(self) -> Optional[str]:
        """The wire dtype of the first tensor moved."""
        return self.moves[0][0] if self.moves else None

    @property
    def consumer(self) -> Optional[int]:
        """The first record that reads any move's output, ``None`` if
        none does."""
        read = [c for c in self.move_consumers if c is not None]
        return min(read) if read else None

    @property
    def work_to_consumer(self) -> int:
        """The matmul and kernel records between issue and
        :attr:`consumer` (0 if carried)."""
        return min((w for c, w in zip(self.move_consumers, self.move_work)
                    if c is not None), default=0)

    @property
    def carried(self) -> bool:
        return self.kind == "collective" and self.consumer is None


@dataclasses.dataclass
class StepProgram:
    """The recorded step: its records and the shards the ring holds (the
    unit ``replay.extract_step_dag`` divides flops and bytes by); with a
    memory-tracking recorder, ``memory`` (``arg_bytes``, ``peak_bytes``)."""
    records: List[Record]
    n_shards: int = 1
    memory: Optional[dict] = None

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
        """``jaxpr_tools.collective_profile``'s rows for ``prim``: one per
        tensor moved (:func:`collective_profile`)."""
        return collective_profile(self, prim)


def count_primitive(program: StepProgram, name: str) -> int:
    """Records named ``name``: an aten op (``"bitwise_xor"``), a kernel
    launch (``"fused_linear"``) or a collective (``"pmin"``)."""
    return sum(1 for r in program.records if r.name == name)


def count_primitives(program: StepProgram, names) -> int:
    """:func:`count_primitive` over a set of names."""
    return sum(count_primitive(program, n) for n in names)


def collective_profile(program: StepProgram,
                       prim: str = "ppermute") -> List[dict]:
    """``jaxpr_tools.collective_profile``'s rows: one per tensor a ``prim``
    collective moved, in issue order, with its wire ``dtype``, whether no
    later record reads it within the step (``carried``) and the matmul
    and kernel records between issue and its first reader
    (``work_to_consumer``)."""
    return [{"dtype": dt, "carried": c is None, "work_to_consumer": w}
            for r in program.collectives(prim)
            for (dt, _), c, w in zip(r.moves, r.move_consumers, r.move_work)]


def ppermute_moves(program: StepProgram) -> List[Tuple[str, int]]:
    """Every shift's moved tensors in issue order: ``(dtype, bytes per
    shard)``, the reference's ``_ppermute_moves`` (per device)."""
    return [m for r in program.collectives("ppermute") for m in r.moves]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_names(tensors) -> Tuple[str, ...]:
    return tuple(sorted({_dtype_name(t.dtype) for t in tensors}))


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


_DTENSOR = []      # the DTensor class, imported at first use


def _has_dtensor(types) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return any(issubclass(t, _DTENSOR[0]) for t in types)


_PROPAGATION = {"depth": 0, "users": 0, "saved": None}


def propagating() -> bool:
    """Whether DTensor's sharding propagation is running (inside
    :func:`sharding_propagation_apart`)."""
    return _PROPAGATION["depth"] > 0


@contextlib.contextmanager
def sharding_propagation_apart():
    """DTensor's sharding propagation run with any fake mode set aside and
    counted in :func:`propagating`; re-entrant.

    Its strategy costs compute with real tensors: under a
    ``FakeTensorMode`` a strided shard's size is data it cannot read. Both
    of the propagator's entries are wrapped, each around itself: the
    cached one and the uncached one, which DTensor takes for every op
    whose cache key its C++ fast path cannot compute (most of a step's:
    with only the cached entry wrapped, the mini dry-run cells count 2.7
    to 3.6 times the flops). The entries are restored after the last
    user leaves."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    st = _PROPAGATION

    def apart(entry):
        def propagate(schema):
            st["depth"] += 1
            try:
                with unset_fake_temporarily():
                    return entry(schema)
            finally:
                st["depth"] -= 1
        return propagate

    if st["users"] == 0:
        st["saved"] = (prop.propagate_op_sharding,
                       prop.propagate_op_sharding_non_cached)
        prop.propagate_op_sharding = apart(st["saved"][0])
        prop.propagate_op_sharding_non_cached = apart(st["saved"][1])
    st["users"] += 1
    try:
        yield
    finally:
        st["users"] -= 1
        if st["users"] == 0:
            (prop.propagate_op_sharding,
             prop.propagate_op_sharding_non_cached) = st["saved"]


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

    def __init__(self, n_shards: int = 1, edges: Optional[dict] = None,
                 memory: bool = False):
        super().__init__()
        self._memory = memory
        self._held: Dict[int, int] = {}            # argument storage -> bytes
        self._read_keys: set = set()
        self._live: Dict[int, int] = {}            # storage -> bytes
        self.arg_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.records: List[Record] = []
        self.n_shards = int(n_shards)
        self.edges = STAGE_EDGES if edges is None else dict(edges)
        # storage -> (record index, move) of the collective outputs in it
        self._pending: Dict[int, List[Tuple[int, int]]] = {}
        self._keep: List[torch.Tensor] = []        # pin tracked storages
        self._kernel: Optional[int] = None         # the open kernel record
        self._depth = 0                            # nested kernel scopes
        self._quiet = 0                            # inside a collective

    # -- lifetime ------------------------------------------------------------
    def __enter__(self):
        self._apart = None          # entered at the first DTensor seen
        ops._recorders.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops._recorders.remove(self)
            if self._apart is not None:
                self._apart.__exit__(None, None, None)

    # -- memory ----------------------------------------------------------------
    def _track(self, tensors) -> int:
        """Count the storages of ``tensors`` not yet live (a DTensor's
        local shard); returns the bytes added."""
        added = 0
        for t in tensors:
            t = getattr(t, "_local_tensor", t)
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            added += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.live_bytes += added
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._pending.pop(key, None)    # never read: carried

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (the step's arguments)
        as live from now on, as ``arg_bytes``."""
        tensors = _tensors(tree)
        self.arg_bytes += self._track(tensors)
        for t in tensors:
            st = getattr(t, "_local_tensor", t).untyped_storage()
            self._held[st._cdata] = st.nbytes()

    @property
    def program(self) -> StepProgram:
        work = [0]
        for r in self.records:
            work.append(work[-1] + (r.kind in WORK_KINDS))
        for i, r in enumerate(self.records):
            if r.kind != "collective":
                continue
            # work strictly between issue i and consumer c
            r.move_work = [0 if c is None else work[c] - work[i + 1]
                           for c in r.move_consumers]
        unused = sum(b for k, b in self._held.items()
                     if k not in self._read_keys)
        memory = ({"arg_bytes": self.arg_bytes - unused,
                   "peak_bytes": self.peak_bytes - unused}
                  if self._memory else None)
        return StepProgram(self.records, self.n_shards, memory)

    # -- reads and writes ----------------------------------------------------
    def _read(self, tensors, at: int) -> None:
        """Mark the events whose outputs ``tensors`` share storage with as
        consumed at record ``at`` (the first such read only)."""
        if not self._pending:
            return
        for t in tensors:
            for i, k in self._pending.pop(_storage_key(t), ()):
                r = self.records[i]
                if r.move_consumers[k] is None:
                    r.move_consumers[k] = at

    def _produced(self, index: int, tensors) -> None:
        """Output ``k`` of collective ``index`` is ``tensors[k]`` (one per
        move; a reduction's one output is its one move)."""
        for k, t in enumerate(tensors):
            self._pending.setdefault(_storage_key(t), []).append((index, k))
            if not self._memory:      # else a freed storage drops its entry
                self._keep.append(t)

    # -- kernel scopes (kernels.ops.scope) -----------------------------------
    def enter_kernel(self, name: str, inputs, launches: bool) -> None:
        self._depth += 1
        if self._depth > 1 or self._quiet:
            return                      # inside another kernel: one launch
        if launches:                    # else the ops inside read them
            self._kernel = len(self.records)
            tensors = [t for t in inputs if isinstance(t, torch.Tensor)]
            self.records.append(Record("kernel", name,
                                       dtypes=_dtype_names(tensors)))
            self._read(tensors, self._kernel)

    def exit_kernel(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._kernel = None

    # -- aten ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            if self._apart is None:
                self._apart = sharding_propagation_apart()
                self._apart.__enter__()
            return NotImplemented     # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if self._memory and not (func.is_view or propagating()
                                 or func.namespace == "prim"):
            self._read_keys.update(_storage_key(t)
                                   for t in _tensors((args, kwargs)))
        if self._quiet or func.namespace == "prim" or propagating():
            return out                # prim: metadata (.device), no work
        if self._memory:
            self._track(_tensors(out))
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in C10D_COLLECTIVES:
                self._c10d(name, args, out)
            return out
        is_mm = name in MATMUL_OPS
        ins = _tensors((args, kwargs))
        flops = _matmul_flops(name, args) if is_mm else 0.0
        nbytes = 0.0 if is_mm else _out_bytes(out)
        dot = _out_bytes(ins) + _out_bytes(out) if is_mm else 0.0
        if self._kernel is not None:
            rec = self.records[self._kernel]
            rec.flops += flops
            rec.bytes += nbytes
            rec.dot_bytes += dot
            self._read(ins, self._kernel)
            return out
        self._read(ins, len(self.records))
        kind = "matmul" if is_mm and not self._depth else "op"
        dest = (_storage_key(args[0]) if name == "copy_"
                and isinstance(args[0], torch.Tensor) else None)
        # a scope that makes no launch records its ops as plain ops
        self.records.append(Record(
            kind, name, flops=flops if kind == "matmul" else 0.0,
            bytes=nbytes, dot_bytes=dot if kind == "matmul" else 0.0,
            dtypes=_dtype_names(ins + _tensors(out)), dest=dest))
        return out

    def _c10d(self, name: str, args, out) -> None:
        """One DTensor collective: its group from the op's group name, one
        move per result tensor (an all-reduce's result is its operand)."""
        import torch.distributed.distributed_c10d as c10d
        group = c10d._resolve_process_group(args[-1]).size()
        outs = _tensors(out)
        index = len(self.records)
        self._read(_tensors(args), index)
        moves = tuple((_dtype_name(t.dtype), t.numel() * t.element_size())
                      for t in outs)
        self.records.append(Record(
            "collective", name, prim=name,
            wire_bytes=sum(b for _, b in moves), moves=moves,
            move_consumers=[None] * len(moves), group=int(group),
            dtypes=_dtype_names(outs)))
        self._produced(index, outs)

    # -- collectives (RecordingRing) ---------------------------------------------
    def collective(self, prim: str, inputs, wire_bytes: int,
                   edge: Optional[str] = None, delta: int = 0,
                   group: int = 1) -> int:
        """Record one collective over ``inputs`` (one move each)."""
        index = len(self.records)
        self._read(inputs, index)
        moves = tuple((_dtype_name(t.dtype),
                       t.numel() * t.element_size() // self.n_shards)
                      for t in inputs)
        self.records.append(Record(
            "collective", prim, prim=prim, wire_bytes=int(wire_bytes), edge=edge, delta=delta, moves=moves,
            move_consumers=[None] * len(moves), group=int(group)))
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

    def _group(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self._ring.axis_size(a)
        return n

    def shift(self, tensors, delta: int, axis: str = "model", tag: int = 0):
        tensors = list(tensors)
        index = self._rec.collective(
            "ppermute", tensors,
            sum(t.numel() * t.element_size() for t in tensors),
            edge=self._rec.edges.get(tag), delta=delta,
            group=self._group(axis))
        return _Handle(self._quietly(self._ring.shift, tensors, delta, axis,
                                     tag), index)

    def finish(self, handle):
        if not isinstance(handle, _Handle):
            return self._ring.finish(handle)
        out = self._quietly(self._ring.finish, handle.inner)
        self._rec._produced(handle.index, out)
        return out

    def _reduce(self, prim: str, x, axes):
        index = self._rec.collective(prim, [x], x.numel() * x.element_size(),
                                     group=self._group(axes))
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
        index = self._rec.collective("all_gather", [x],
                                     n * x.numel() * x.element_size(),
                                     group=n)
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
