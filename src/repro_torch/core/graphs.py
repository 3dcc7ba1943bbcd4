"""The compiled ADMM driver: one iteration captured as a CUDA graph, replayed.

Counterpart of the reference's ``jax.jit`` over ``lax.scan``
(``repro.core.pdadmm._scan_chunk``). ``pdadmm.run_chunked(..., jit=True)``
runs its iterations on a CUDA device through a :class:`ChunkProgram`:

* The state lives in :class:`StateBuffers`: one buffer per state leaf,
  each of its own storage (``init_state`` hands p[l+1] and q[l] the same
  tensor; a copy back into aliased buffers would write one over the
  other). Every program over a state of one signature reads and writes
  the same buffers, so ``train_adaptive`` switching between its
  schedules' steps copies nothing and holds one state, however many
  schedules it visits.
* A program's body reads the state from the buffers, runs ``step_fn``
  on them and the ``args`` (whose addresses the graph reads), copies
  every new leaf into its buffer (a leaf that is its own buffer, such as
  p[0] = X or a donated field, is not copied) and writes the metrics (any
  tree of tensors) into row k of the program's device history, k a
  device counter that the body advances. The history is one byte tensor
  ``[capacity, row bytes]`` holding every metric leaf of a row, so it
  reaches the host in one copy: once per chunk (:meth:`ChunkProgram.run`)
  or once per iteration (:meth:`ChunkProgram.iterate`, for the loops
  that read each iteration's metrics on the host: the controller's
  residuals, the sentinel verdict). An argument the host rewrites between
  iterations (a widths table, a tick's fault controls) is a tensor the
  caller keeps and writes into in place, so the graph reads its address.
* On a CUDA device the body runs twice on a side stream (first-use work:
  the kernel library, shared-memory opt-ins, the FISTA momentum buffer;
  then once more under ``torch.cuda.set_sync_debug_mode("error")``, so a
  hidden host sync raises), the buffers being put back as they were
  after it, and is captured once into a ``torch.cuda.CUDAGraph``; each
  iteration is one replay. A failed warm-up or capture raises, naming the
  call that broke it: nothing falls back to the eager loop.
* Every capture on a device runs on one side stream and allocates from
  the memory pool of the device's live graphs (a new pool when none is
  alive): a graph's temporaries are dead between its replays, since it
  reads only the buffers and its args and writes only the buffers and its
  history, all outside the pool, so graphs may share it. The allocator's
  cache is emptied and Python's garbage collected before each capture,
  and the collector is off while one runs: no block may be freed, and no
  graph destroyed, inside a capture. A call that invalidates a capture
  without raising is named as the one that broke it (the driver's
  capture status is read after each torch call of the capture).

Programs are cached per ``step_fn`` (held weakly, as the reference's jit
is keyed by the static ``step_fn``) and per signature: the tree of the
state, each state leaf's shape, dtype and device, and each ``args``
tensor's shape, dtype, device and address. ``train_adaptive`` re-enters
with its cached step per schedule and hits the cache. The buffers live as
long as a program over them.

A replay runs no Python, so the launch counters of the kernel wrappers
(``kernels.ops.launch_counts``) and each ``LocalRing``'s ``shifted_bytes``
do not move by themselves. The counts that one captured iteration added
are recorded at capture and added again on every replay; the warm-up
(whose result is thrown away) and the capture (which launches nothing)
leave every counter where it was, and the warm-up's launches are kept
apart in ``warmup_launches``. So the counters read as the eager loop
leaves them. With ``debug`` set, each graph keeps its cudaGraph_t, whose
kernel nodes (what every replay launches) ``chip_smoke.py``'s graph
phase reads from the CUDA driver.
"""
from __future__ import annotations

import gc
import weakref
from typing import Dict, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

# step_fn -> {signature: ChunkProgram}; a program lives as long as its step
_PROGRAMS = weakref.WeakKeyDictionary()
# state signature -> the StateBuffers its programs share (while one lives)
_BUFFERS = weakref.WeakValueDictionary()
replays = 0     # CUDA graph replays in this process (callers may reset it)
# kernel name -> launches of the warm-up bodies (two per capture), which
# the counters leave out (callers may reset it)
warmup_launches: Dict[str, int] = {}
# with ``debug`` set, a capture keeps its cudaGraph_t
# (``graph.raw_cuda_graph()``, the nodes every replay launches) and its
# program is appended to ``debug_programs`` (callers clear it)
debug = False
debug_programs: List["ChunkProgram"] = []
# device -> the side stream of every warm-up and capture there (each new
# stream would get a cuBLAS workspace of its own)
_SIDE = {}
_IS_CAPTURING = None    # the driver's cuStreamIsCapturing, once loaded


# ---------------------------------------------------------------------------
# The host counters a replay must advance
# ---------------------------------------------------------------------------

def counter_snapshot() -> tuple:
    """(kernel name -> launches, {LocalRing: shifted_bytes}) now."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.ring import live_local_rings
    return (ops.launch_counts(),
            {ring: ring.shifted_bytes for ring in live_local_rings()})


def counter_delta(before: tuple, after: tuple) -> tuple:
    """What moved between two snapshots, in the snapshot's form (rings
    held weakly, so a delta keeps no ring alive)."""
    kb, rb = before
    ka, ra = after
    kernels = {k: ka[k] - kb.get(k, 0) for k in ka if ka[k] != kb.get(k, 0)}
    rings = [(weakref.ref(r), n - rb.get(r, 0)) for r, n in ra.items()
             if n != rb.get(r, 0)]
    return kernels, rings


def add_counts(delta: tuple, times: int = 1) -> None:
    """Advance every counter by ``times`` × ``delta`` (negative undoes)."""
    from repro_torch.kernels import ops
    kernels, rings = delta
    ops.add_launch_counts(kernels, times)
    for ref, n in rings:
        ring = ref()
        if ring is not None:
            ring.shifted_bytes += n * times


def _undo(before: tuple) -> None:
    add_counts(counter_delta(counter_snapshot(), before))


# ---------------------------------------------------------------------------
# Buffers
# ---------------------------------------------------------------------------

def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _same_view(x, buf) -> bool:
    return (x.data_ptr() == buf.data_ptr() and x.dtype == buf.dtype
            and x.shape == buf.shape and x.stride() == buf.stride())


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def copy_into(bufs: List, values: List) -> int:
    """``bufs[i] <- values[i]`` for every tensor pair, skipping a value that
    is its own buffer. A value that shares storage with any buffer is
    cloned first, so no copy reads a buffer an earlier copy wrote. Returns
    the number of copies made."""
    held = {_storage(b) for b in bufs if _is_tensor(b)}
    staged = []
    for b, v in zip(bufs, values):
        if not _is_tensor(b) or _same_view(v, b):
            staged.append(None)
            continue
        if v.shape != b.shape or v.dtype != b.dtype:
            raise ValueError(f"a state leaf changed from {tuple(b.shape)} "
                             f"{b.dtype} to {tuple(v.shape)} {v.dtype}")
        staged.append(v.clone() if _storage(v) in held else v)
    for b, v in zip(bufs, staged):
        if v is not None:
            b.copy_(v)
    return sum(v is not None for v in staged)


def _sig(x, address: bool) -> tuple:
    if _is_tensor(x):
        return (tuple(x.shape), x.dtype, str(x.device)) + (
            (x.data_ptr(),) if address else ())
    return ("static", repr(x))


def _state_signature(spec, leaves) -> tuple:
    return (str(spec), tuple(_sig(x, False) for x in leaves))


def _args_signature(args) -> tuple:
    return tuple(_sig(x, True) for x in pytree.tree_leaves(args))


def on_cuda(state) -> bool:
    """Whether the state's first tensor leaf lies on a CUDA device."""
    return next((x.is_cuda for x in pytree.tree_leaves(state)
                 if _is_tensor(x)), False)


def _capture_invalidated(stream) -> bool:
    """Whether the capture on ``stream`` was invalidated: a call the
    capture may not make (a synchronising or allocating one in a library)
    ends it without raising, and only a later call fails. Asks the CUDA
    driver (``cuStreamIsCapturing``; status 2 is
    CU_STREAM_CAPTURE_STATUS_INVALIDATED)."""
    import ctypes
    global _IS_CAPTURING
    if _IS_CAPTURING is None:
        _IS_CAPTURING = ctypes.CDLL("libcuda.so.1").cuStreamIsCapturing
    status = ctypes.c_int()
    rc = _IS_CAPTURING(ctypes.c_void_p(stream.cuda_stream),
                       ctypes.byref(status))
    return rc == 0 and status.value == 2


class _LastCall(TorchFunctionMode):
    """Remembers the first torch call that raised (the op that broke a
    warm-up or a capture) or, with ``stream`` (a capture's), the first
    after which the capture on it was invalidated."""

    def __init__(self):
        super().__init__()
        self.failed = None
        self.stream = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        try:
            out = func(*args, **(kwargs or {}))
        except Exception:
            if self.failed is None:
                self.failed = func
            raise
        if self.failed is None and self.stream is not None and \
                _capture_invalidated(self.stream):
            self.failed = func
        return out


def _name(fn) -> str:
    fn = getattr(fn, "func", fn)          # functools.partial
    return getattr(fn, "__qualname__", None) or repr(fn)


class StateBuffers:
    """One buffer per leaf of a state, each of its own storage, shared by
    every program over a state of this signature (see the module
    docstring). Non-tensor leaves are static. With ``adopt`` the buffers
    are the caller's own tensors (a leaf whose storage an earlier leaf
    holds is cloned), as if lent to the caller: no clone of a large state
    (a KV cache), and the caller's state is never overwritten by another
    state while the caller holds it."""

    def __init__(self, leaves, spec, adopt: bool = False):
        self.spec = spec
        self._lent = []             # weak refs to the leaves last returned
        if not adopt:
            self.bufs = [x.clone() if _is_tensor(x) else x for x in leaves]
        else:
            self.bufs, seen = [], set()
            for x in leaves:
                own = _is_tensor(x) and _storage(x) not in seen
                if own:
                    seen.add(_storage(x))
                self.bufs.append(x.detach() if own else
                                 x.clone() if _is_tensor(x) else x)
                self._lent.append(weakref.ref(x) if own else None)
        self.device = next((x.device for x in self.bufs if _is_tensor(x)),
                           torch.device("cpu"))

    def lent_alive(self, leaves) -> bool:
        """Whether a state these buffers lent is still held by someone and
        a call now brings other values for it (the buffers may then not
        be overwritten)."""
        for ref, x, b in zip(self._lent, leaves, self.bufs):
            if ref is not None and ref() is not None and not (
                    _is_tensor(x) and _same_view(x, b)):
                return True
        return False

    def load(self, state) -> int:
        """Copy the caller's state into the buffers (leaves that are the
        buffers already are skipped). Returns the copies made."""
        leaves, spec = pytree.tree_flatten(state)
        if str(spec) != str(self.spec):
            raise ValueError(f"state tree {spec} is not {self.spec}")
        return copy_into(self.bufs, leaves)

    def state(self):
        """The state the buffers hold, as new tensor objects over the
        buffers' storage (watched weakly: see :meth:`lent_alive`)."""
        out = [b.detach() if _is_tensor(b) else b for b in self.bufs]
        self._lent = [weakref.ref(x) if _is_tensor(x) else None for x in out]
        return pytree.tree_unflatten(out, self.spec)


class ChunkProgram:
    """One iteration of ``step_fn`` over ``buffers`` (see the module
    docstring). ``capacity`` rows of metrics reach the host at a time."""

    def __init__(self, step_fn, buffers: StateBuffers, args, capacity: int):
        self.buffers = buffers
        self.args = args
        self.capacity = int(capacity)
        self.device = buffers.device
        self.row = torch.zeros((1,), dtype=torch.int64, device=self.device)
        # uint8 [capacity, row bytes]; each metric leaf a view of its bytes
        self.history = None
        self._views: List[torch.Tensor] = []
        self._spans: List[tuple] = []        # (offset, bytes, dtype, shape)
        self._metrics_spec = None
        self.graph = None
        self.delta = ({}, [])       # counters one replay advances
        self.replays = 0            # graph replays (CUDA) or body runs (CPU)
        if self.device.type == "cuda":
            self._capture(step_fn)

    # -- the body ------------------------------------------------------------
    def _body(self, step_fn) -> None:
        bufs, spec = self.buffers.bufs, self.buffers.spec
        new, metrics = step_fn(pytree.tree_unflatten(bufs, spec), *self.args)
        out, new_spec = pytree.tree_flatten(new)
        if str(new_spec) != str(spec) or any(
                not _is_tensor(b) and o != b for o, b in zip(out, bufs)):
            raise ValueError(f"{_name(step_fn)} changed the state's "
                             f"structure: {new_spec} after {spec}")
        copy_into(bufs, out)
        leaves, mspec = pytree.tree_flatten(metrics)
        if self.history is None:
            self._layout(leaves, mspec)
        for view, m in zip(self._views, leaves):
            view.index_copy_(0, self.row, m.unsqueeze(0))
        self.row.add_(1)

    def _layout(self, leaves, spec) -> None:
        """The byte history: each leaf's bytes at an 8-byte aligned offset
        of a row, viewed back as its dtype and shape."""
        offsets, width = [], 0
        for m in leaves:
            offsets.append(width)
            width += -(-m.numel() * m.element_size() // 8) * 8
        self.history = torch.empty((self.capacity, max(width, 8)),
                                   dtype=torch.uint8, device=self.device)
        self._metrics_spec = spec
        self._spans = [(o, m.numel() * m.element_size(), m.dtype,
                        tuple(m.shape)) for o, m in zip(offsets, leaves)]
        self._views = [self.history[:, o:o + nb].view(dtype)
                       .view((self.capacity,) + shape)
                       for o, nb, dtype, shape in self._spans]

    def _read(self, c: int):
        """The first ``c`` rows of the history on the host (one copy): the
        metrics tree with numpy leaves, each stacked over the rows."""
        host = self.history[:c].to("cpu", copy=True)
        leaves = [host[:, o:o + nb].view(dtype).view((c,) + shape).numpy()
                  for o, nb, dtype, shape in self._spans]
        return pytree.tree_unflatten(leaves, self._metrics_spec)

    def _capture(self, step_fn) -> None:
        dev = self.device
        before = counter_snapshot()
        main = torch.cuda.current_stream(dev)
        side = _SIDE.setdefault(dev, torch.cuda.Stream(dev))
        side.wait_stream(main)
        tracker = _LastCall()
        err = None
        bufs = self.buffers.bufs
        with torch.cuda.stream(side):
            # the warm-up writes into the buffers other programs share
            kept = [b.clone() if _is_tensor(b) else None for b in bufs]
            self._body(step_fn)                 # first-use work
            self.row.zero_()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with tracker:
                    self._body(step_fn)         # no hidden host sync
            except Exception as e:              # noqa: BLE001 - re-raised
                err = ("warm-up", e)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            for b, k in zip(bufs, kept):
                if k is not None:
                    b.copy_(k)
        main.wait_stream(side)
        del kept
        for k, n in counter_delta(before, counter_snapshot())[0].items():
            warmup_launches[k] = warmup_launches.get(k, 0) + n
        _undo(before)
        if err is None:
            self.row.zero_()
            # as torch.cuda.graph does: no cached block may be freed while
            # a capture runs, so free them before; and no garbage either
            # (an unreachable CUDA graph's destructor, run by the cyclic
            # collector inside a capture, invalidates it), so collect it
            # before and keep the collector off while the capture runs
            torch.cuda.synchronize(dev)
            gc.collect()
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph(keep_graph=debug)
            # the pool of a graph alive on this device, if there is one
            pool = next((p.graph.pool() for p in programs()
                         if p.graph is not None and p.device == dev), None)
            before = counter_snapshot()
            tracker.stream = side
            collecting = gc.isenabled()
            gc.disable()
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    with tracker:
                        self._body(step_fn)
                except Exception as e:          # noqa: BLE001 - re-raised
                    err = ("capture", e)
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError as e:
                        if err is None:
                            err = ("capture", e)
                    if collecting:
                        gc.enable()
            main.wait_stream(side)
            self.delta = counter_delta(before, counter_snapshot())
            _undo(before)
            self.graph = graph
            if debug and err is None:
                graph.instantiate()
                debug_programs.append(self)
        if err is not None:
            where, e = err
            op = (_name(tracker.failed) if tracker.failed is not None
                  else "a call outside torch (its message follows)")
            raise RuntimeError(
                f"CUDA graph {where} of {_name(step_fn)} failed at {op}: "
                f"{type(e).__name__}: {e}") from e

    # -- running -------------------------------------------------------------
    def step(self, step_fn, eager: bool = False) -> None:
        """One iteration: a replay, or the body run eagerly where there is
        no graph (counted as a replay). With ``eager`` the body runs
        eagerly all the same, uncounted: what a replay launches, one
        launch at a time."""
        global replays
        if eager:
            self._body(step_fn)
            return
        if self.graph is None:
            self._body(step_fn)
        else:
            self.graph.replay()
            add_counts(self.delta)
            replays += 1
        self.replays += 1

    def run(self, step_fn, n_iters: int):
        """``n_iters`` iterations; the metrics move to the host once per
        ``capacity`` rows. Returns the metrics tree with numpy leaves
        stacked over iterations."""
        pieces, done = [], 0
        while done < n_iters:
            c = min(self.capacity, n_iters - done)
            self.row.zero_()
            for _ in range(c):
                self.step(step_fn)
            pieces.append(self._read(c))
            done += c
        return pytree.tree_map(lambda *xs: np.concatenate(xs), *pieces)

    def iterate(self, step_fn):
        """One iteration, and its metrics on the host in one copy: the
        tree the step returns, with numpy leaves."""
        self.row.zero_()
        self.step(step_fn)
        return pytree.tree_map(lambda x: x[0], self._read(1))


def state_signature(state) -> tuple:
    """The tree of ``state`` and each leaf's shape, dtype and device: the
    key of the buffers its programs share."""
    leaves, spec = pytree.tree_flatten(state)
    return _state_signature(spec, leaves)


def program_for(step_fn, state, args, capacity: int,
                adopt: bool = False) -> ChunkProgram:
    """The cached program of ``step_fn`` at this state's and args'
    signature over the buffers of the state's signature, built (and
    captured, on CUDA) on a miss. Buffers whose last returned state is
    still held, while this call brings another state, are replaced by new
    ones, and the programs over them go: the held state keeps the old
    storage. New buffers clone the state, or with ``adopt`` take its
    tensors as they are (``StateBuffers``)."""
    leaves, spec = pytree.tree_flatten(state)
    ssig = _state_signature(spec, leaves)
    bufs = _BUFFERS.get(ssig)
    if bufs is not None and bufs.lent_alive(leaves):
        for table in list(_PROGRAMS.values()):
            for k in [k for k, p in table.items() if p.buffers is bufs]:
                del table[k]
        bufs = None
    if bufs is None:
        bufs = _BUFFERS[ssig] = StateBuffers(leaves, spec, adopt)
    sig = (ssig, _args_signature(args))
    table = _PROGRAMS.setdefault(step_fn, {})
    prog = table.get(sig)
    if prog is None or prog.buffers is not bufs:
        table.pop(sig, None)            # its graph goes first
        del prog
        prog = table[sig] = ChunkProgram(step_fn, bufs, args, capacity)
    return prog


def programs(step_fn=None) -> list:
    """The cached programs of ``step_fn`` (one per signature), or of every
    step still alive."""
    if step_fn is None:
        return [p for table in _PROGRAMS.values() for p in table.values()]
    return list(_PROGRAMS.get(step_fn, {}).values())


def release(step_fn=None) -> None:
    """Drop the cached programs of ``step_fn`` (every program with None):
    their graphs are freed (the shared pool's memory once no graph holds
    it), and buffers no program is left over; a state they returned keeps
    its storage."""
    if step_fn is None:
        _PROGRAMS.clear()
    else:
        _PROGRAMS.pop(step_fn, None)


def run(step_fn, state, args, n_iters: int, chunk: int):
    """``pdadmm.run_chunked``'s compiled form: ``(state, metrics)``. On
    the CPU (where ``run_chunked`` takes its eager loop instead) the same
    body runs eagerly each iteration, with no graph."""
    prog = program_for(step_fn, state, args, chunk)
    prog.buffers.load(state)
    metrics = prog.run(step_fn, n_iters)
    return prog.buffers.state(), metrics
