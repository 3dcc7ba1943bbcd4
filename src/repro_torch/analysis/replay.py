"""Trace-driven replay cost model: predict a stage-parallel step's wall time
offline, find its critical path, and search schedules against *time*
instead of bytes.

Counterpart of ``repro.analysis.replay`` (lineage: byteprofile-analysis /
dPRO replay a profiled training DAG over per-device queues; AdaQP frames
message quantization as a wall-time problem). Three layers:

  1. **DAG** (:func:`extract_step_dag` → :class:`StepDag`): one recorded
     step (:mod:`repro_torch.analysis.torch_trace`, the port's stand-in for
     the reference's jaxpr) cut into alternating :class:`Segment` compute
     tasks (matmul flops, streamed output bytes, kernel launches, op
     counts) and :class:`CommEvent` s (one per collective, in issue
     order) carrying the per-link wire bytes of the payload the ring
     moved — for a codec-formatted shift that IS the container the
     CommLedger charges. Each event is ``carried`` (its outputs leave the
     step unread: consumed at the next iteration's entry), hidden
     (consumed with matmul or kernel work between issue and use) or
     blocking (consumed at once: on the critical path). Ppermute events
     carry the CommLedger edge names (``q_fwd``/``u_fwd``/``p_bwd``), so
     ledger byte counts splice in via :meth:`StepDag.with_wire_bytes`.
     A ``LocalRing`` holds every shard in one tensor, so one recorded op
     covers all of them: flops and bytes are divided by the shard count,
     launch and op counts are not (``calibrate`` prices them in these
     units, so the miscount cancels, as in the reference).

  2. **Costs**: a :class:`~repro_torch.analysis.costs.CostTable` prices
     compute segments, blocking-collective tolls, issue tolls and the link.

  3. **Replay** (:func:`replay`): a deterministic discrete-event simulation
     over per-device queues — ``n_rows × n_stages`` logical devices, each
     running the DAG's tasks in program order, compute contending for
     ``n_workers`` executor slots (one for a ``LocalRing``: one process
     drives every shard on one stream), psums as global barriers,
     ppermutes as neighbour messages arriving ``link.transfer_time(wire
     bytes)`` after their issue. It returns the steady-state step time,
     per-stage busy and idle time, and the critical path. No clock
     anywhere: same inputs, same prediction — and the same bits as the
     reference's replay of the same DAG and table (the arithmetic is the
     reference's, in its order).

Searches on top: :func:`choose_psum_mode` (replay-priced gather vs
code-psum vs fp32 psum; without a cost table the ring-byte rule of
:func:`repro_torch.comm.transport.psum_mode`), :func:`choose_overlap`
(replay both step variants, keep the faster; hand default overlap on) and
:class:`ScheduleCostModel` (per-boundary bit-width schedule → predicted
step seconds, the ``objective="walltime"`` hook of
:class:`repro_torch.comm.controller.BitWidthController`).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.costs import CostTable, LinkModel


# ---------------------------------------------------------------------------
# DAG nodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Segment:
    """A run of compute between two collectives (one replay task per
    device). Costs are aggregated: dense-contraction flops, streamed output
    bytes of everything else, kernel launches (``n_pallas``, the
    reference's name) and the op count (per-op overhead)."""
    index: int
    flops: float = 0.0
    bytes: float = 0.0
    n_pallas: int = 0
    n_eqns: int = 0

    def seconds(self, costs: CostTable) -> float:
        return (self.flops / costs.get("rate:dot_flops")
                + self.bytes / costs.get("rate:eltwise_bytes")
                + self.n_pallas * costs.get("op:pallas_call", 0.0)
                + self.n_eqns * costs.get("rate:op_overhead"))


@dataclasses.dataclass
class CommEvent:
    """One collective of the step, in program order."""
    index: int
    prim: str                    # "ppermute" | "psum" | ...
    dtype: str
    wire_bytes: int              # per-shard physical bytes on one link
    carried: bool                # consumed only by the NEXT iteration
    work_to_consumer: int
    consumer_index: Optional[int]   # DAG index of the consuming Segment
    edge: Optional[str] = None      # CommLedger edge name, when known
    ring_delta: int = 1             # ppermute: receiver d gets from d-delta

    @property
    def blocking(self) -> bool:
        """Consumed in-body with no solver work between issue and use: the
        rendezvous sits on the critical path."""
        return (not self.carried) and self.work_to_consumer == 0


Item = Union[Segment, CommEvent]


@dataclasses.dataclass
class StepDag:
    """Program-ordered task template of ONE step, per device."""
    items: List[Item]
    n_stages: int
    n_rows: int = 1              # data-parallel replicas of the stage ring

    @property
    def comm_events(self) -> List[CommEvent]:
        return [x for x in self.items if isinstance(x, CommEvent)]

    @property
    def segments(self) -> List[Segment]:
        return [x for x in self.items if isinstance(x, Segment)]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.comm_events:
            out[e.prim] = out.get(e.prim, 0) + 1
        return out

    def with_wire_bytes(self, by_edge: Dict[str, int]) -> "StepDag":
        """New DAG with named ppermute edges re-priced from ledger-shaped
        per-shard byte counts (``WireRecord.wire_bytes`` divided down to one
        link) — the splice point between the CommLedger and the replay."""
        items: List[Item] = []
        for x in self.items:
            if isinstance(x, CommEvent) and x.edge in by_edge:
                x = dataclasses.replace(x, wire_bytes=int(by_edge[x.edge]))
            items.append(x)
        return StepDag(items, self.n_stages, self.n_rows)


def extract_step_dag(program, n_stages: int, *, n_rows: int = 1,
                     edge_names: Optional[Sequence[str]] = None) -> StepDag:
    """Cut a recorded step (:class:`~repro_torch.analysis.torch_trace.
    StepProgram`) into the alternating Segment/CommEvent task list.

    Per-shard costs: flops, bytes and wire bytes are divided by the
    program's shard count; launch and op counts are kept as recorded.
    ``edge_names`` relabels the ppermute events, in issue order (by
    default each keeps the edge name its ring tag stands for)."""
    n = max(int(program.n_shards), 1)
    items: List[Item] = []
    item_of: List[int] = []          # record index -> item index
    seg: Optional[Segment] = None
    n_pp = 0
    for r in program.records:
        if r.kind != "collective":
            if seg is None:
                seg = Segment(len(items))
                items.append(seg)
            seg.flops += r.flops / n
            seg.bytes += r.bytes / n
            seg.n_pallas += r.kind == "kernel"
            seg.n_eqns += 1
            item_of.append(seg.index)
            continue
        seg = None
        edge = None
        if r.prim == "ppermute":
            edge = r.edge
            if edge_names is not None and n_pp < len(edge_names):
                edge = edge_names[n_pp]
            n_pp += 1
        item_of.append(len(items))
        items.append(CommEvent(
            index=len(items), prim=r.prim, dtype=r.dtype,
            wire_bytes=int(r.wire_bytes // n), carried=r.carried,
            work_to_consumer=r.work_to_consumer, consumer_index=None,
            edge=edge,
            ring_delta=(r.delta % n_stages or 1) if r.prim == "ppermute"
            else 0))
    for r, i in zip(program.records, item_of):
        if r.kind == "collective" and r.consumer is not None:
            items[i].consumer_index = item_of[r.consumer]
    return StepDag(items, n_stages, n_rows)


# ---------------------------------------------------------------------------
# Deterministic discrete-event replay over per-device queues
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    step_time_s: float
    total_time_s: float
    n_iterations: int
    per_stage_busy_s: List[float]     # compute seconds per stage, one step
    per_stage_idle_s: List[float]     # step_time - busy, per stage
    critical_path: List[Tuple[str, float]]   # (task label, duration)

    @property
    def step_time_ms(self) -> float:
        return self.step_time_s * 1e3

    def critical_comm(self) -> List[Tuple[str, float]]:
        """Comm tasks on the critical path, slowest first."""
        comm = [(lbl, d) for lbl, d in self.critical_path
                if not lbl.startswith("seg")]
        return sorted(comm, key=lambda t: -t[1])


def default_n_workers(n_devices: int) -> int:
    """Executor slots: real cores, capped at the device count (the CPU
    device simulator time-slices many logical devices onto few cores; on
    real accelerators every device computes concurrently)."""
    return max(1, min(os.cpu_count() or 1, n_devices))


def replay(dag: StepDag, costs: Optional[CostTable] = None, *,
           n_iterations: int = 4, n_workers: Optional[int] = None,
           link: Optional[LinkModel] = None) -> ReplayResult:
    """Deterministic DES of `n_iterations` steps of the DAG.

    Devices are the ``n_rows * n_stages`` mesh shards, each running the
    item list in program order. Compute segments contend for `n_workers`
    executor slots (priority: earliest-ready, then device id — fully
    deterministic). Blocking psums/all_gathers are global barriers of
    duration ``collective:<prim> + transfer``; blocking ppermutes are
    per-device neighbor syncs; carried/hidden collectives cost an issue
    toll at their program position and their transfer overlaps whatever
    compute follows, constraining only their consumer segment (next
    iteration's entry for carried events).
    """
    costs = costs or CostTable()
    link = link or costs.link
    D = dag.n_rows * dag.n_stages
    W = n_workers if n_workers is not None else default_n_workers(D)

    def stage_of(d):
        return d % dag.n_stages

    def ring(d, delta):
        row = d // dag.n_stages
        return row * dag.n_stages + (stage_of(d) - delta) % dag.n_stages

    seg_secs = {x.index: x.seconds(costs) for x in dag.segments}
    dispatch = costs.get("step:dispatch")

    # ---- build tasks -----------------------------------------------------
    # key: (iter, item_index, device) for per-device tasks;
    #      (iter, item_index, -1) for global barriers.
    tasks: Dict[Tuple[int, int, int], dict] = {}

    def add(key, label, duration, uses_slot, deps, device):
        tasks[key] = {"label": label, "dur": float(duration),
                      "slot": uses_slot, "deps": list(deps),
                      "device": device}

    first_item = dag.items[0].index if dag.items else 0
    for it in range(n_iterations):
        prev_of = {}        # device -> previous task key this iteration
        if it > 0:
            for d in range(D):
                prev_of[d] = last_of[d]                       # noqa: F821
        for x in dag.items:
            if isinstance(x, Segment):
                dur = seg_secs[x.index] + (dispatch if x.index == first_item
                                           else 0.0)
                for d in range(D):
                    deps = [(prev_of[d], 0.0)] if d in prev_of else []
                    add((it, x.index, d), f"seg{x.index}", dur, True, deps, d)
                    prev_of[d] = (it, x.index, d)
                continue
            lbl = x.edge or f"{x.prim}{x.index}"
            xfer = link.transfer_time(x.wire_bytes)
            if x.blocking and x.prim != "ppermute":
                # global barrier: everyone arrives, rendezvous toll + wire
                toll = costs.get(f"collective:{x.prim}")
                deps = [(prev_of[d], 0.0) for d in range(D) if d in prev_of]
                add((it, x.index, -1), lbl, toll + xfer, False, deps, -1)
                for d in range(D):
                    prev_of[d] = (it, x.index, -1)
                continue
            if x.blocking:
                # blocking ppermute: neighbor sync per device
                toll = costs.get("collective:ppermute")
                for d in range(D):
                    deps = [(prev_of[d], 0.0)] if d in prev_of else []
                    s = ring(d, x.ring_delta)
                    if s in prev_of:
                        deps.append((prev_of[s], 0.0))
                    add((it, x.index, d), lbl, toll + xfer, False, deps, d)
                for d in range(D):
                    prev_of[d] = (it, x.index, d)
                continue
            # hidden or carried: async issue at this point in the queue
            toll = costs.get(f"collective:{x.prim}:issue")
            for d in range(D):
                deps = [(prev_of[d], 0.0)] if d in prev_of else []
                add((it, x.index, d), f"{lbl}:issue", toll, False, deps, d)
                prev_of[d] = (it, x.index, d)
        last_of = dict(prev_of)

    # arrival constraints: the consumer segment waits for the message (for
    # carried events that is the NEXT iteration's entry task, so this runs
    # after every iteration's tasks exist)
    for it in range(n_iterations):
        for x in dag.items:
            if not isinstance(x, CommEvent) or x.blocking:
                continue
            cons_iter, cons_idx = it, x.consumer_index
            if x.carried:
                cons_iter, cons_idx = it + 1, first_item
            if cons_iter >= n_iterations or cons_idx is None:
                continue
            for d in range(D):
                src = ring(d, x.ring_delta) if x.prim == "ppermute" else None
                senders = range(D) if src is None else (src,)
                xfer = link.transfer_time(x.wire_bytes)
                key = (cons_iter, cons_idx, d)
                if key not in tasks:     # consumer is a barrier
                    key = (cons_iter, cons_idx, -1)
                for s in senders:
                    tasks[key]["deps"].append(((it, x.index, s), xfer))

    # ---- simulate --------------------------------------------------------
    n_deps = {k: len(t["deps"]) for k, t in tasks.items()}
    dependents: Dict[Tuple, List[Tuple]] = {k: [] for k in tasks}
    for k, t in tasks.items():
        for dep, _lag in t["deps"]:
            dependents[dep].append(k)
    end: Dict[Tuple, float] = {}
    det: Dict[Tuple, Optional[Tuple]] = {}
    ready_heap: List[Tuple[float, Tuple]] = []

    def ready_time(k):
        best, best_dep = 0.0, None
        for dep, lag in tasks[k]["deps"]:
            t = end[dep] + lag
            if t > best:
                best, best_dep = t, dep
        return best, best_dep

    for k, n in n_deps.items():
        if n == 0:
            heapq.heappush(ready_heap, (0.0, k))
            det[k] = None
    workers = [(0.0, None)] * W      # (free_time, last task) per slot
    heapq.heapify(workers)
    done = 0
    while ready_heap:
        rt, k = heapq.heappop(ready_heap)
        t = tasks[k]
        if t["slot"]:
            free, last = heapq.heappop(workers)
            start = max(rt, free)
            if free > rt and last is not None:
                det[k] = last            # waited for the executor, not deps
            heapq.heappush(workers, (start + t["dur"], k))
        else:
            start = rt
        end[k] = start + t["dur"]
        done += 1
        for dep_k in dependents[k]:
            n_deps[dep_k] -= 1
            if n_deps[dep_k] == 0:
                r, d = ready_time(dep_k)
                det.setdefault(dep_k, d)
                heapq.heappush(ready_heap, (r, dep_k))
    assert done == len(tasks), "replay deadlock: cyclic deps in the DAG"

    # steady-state step time: width of the LAST iteration window
    def iter_end(it):
        return max(v for k, v in end.items() if k[0] == it)
    total = iter_end(n_iterations - 1)
    step = (total - iter_end(n_iterations - 2)) if n_iterations > 1 else total

    busy = [0.0] * dag.n_stages
    last_it = n_iterations - 1
    for k, t in tasks.items():
        if k[0] == last_it and t["slot"] and t["device"] >= 0:
            busy[stage_of(t["device"])] += t["dur"] / max(dag.n_rows, 1)
    idle = [max(step - b, 0.0) for b in busy]

    # critical path: walk determining predecessors back from the last task
    tail = max((k for k in end), key=lambda k: end[k])
    path = []
    k = tail
    seen = set()
    while k is not None and k not in seen:
        seen.add(k)
        path.append((tasks[k]["label"], tasks[k]["dur"]))
        k = det.get(k)
    path.reverse()
    return ReplayResult(step_time_s=step, total_time_s=total,
                        n_iterations=n_iterations,
                        per_stage_busy_s=busy, per_stage_idle_s=idle,
                        critical_path=path)


# ---------------------------------------------------------------------------
# Calibration: measured micro-runs on the ring
# ---------------------------------------------------------------------------

def _recorded_segment(fn, *args) -> Segment:
    """``fn``'s recorded compute, totalled into one Segment (one shard):
    traced on shape-only CPU copies of ``args``, so nothing computes."""
    from repro_torch.analysis import torch_trace as tt
    import torch
    with tt.fake_mode():
        fake = [torch.empty(a.shape, dtype=a.dtype, device="cpu")
                if isinstance(a, torch.Tensor) else a for a in args]
        program, _ = tt.record(fn, *fake)
    seg = Segment(-1)
    for r in program.records:
        seg.flops += r.flops
        seg.bytes += r.bytes
        seg.n_pallas += r.kind == "kernel"
        seg.n_eqns += 1
    return seg


BURN_ROUNDS = 8     # rounds of 4 small elementwise ops between collectives


def calibrate(ring, *, V: int = 128, h: int = 32, n_classes: int = 4,
              fista_iters: int = 15, iters: int = 20, reps: int = 3,
              chain: int = 4, costs: Optional[CostTable] = None,
              grid=None) -> CostTable:
    """Fill a :class:`CostTable` from micro-runs on ``ring`` (a
    ``LocalRing``; on its device, CUDA events on the card): warm-up, then
    the median of ``reps`` batches of ``iters`` calls. The step under test
    is never timed.

    Tolls are DIFFERENTIAL, as in the reference: an empty step (one small
    op) prices ``step:dispatch``; chains of ``chain`` ring shifts, and of
    ``chain`` psums, each after the same burn of small elementwise ops,
    price ``collective:<prim>`` as the increment over the burns alone; a
    shift whose result is only returned prices the issue toll (clamped to
    the blocking toll). The per-op overhead is the burn's time per op.

    Rates are calibrated IN THE DAG'S UNITS: each probe is recorded with
    the same recorder the step is, and the rate is (recorded flops or
    bytes) / (measured seconds less the recorded ops' overhead). The probes
    run the port's kernels: ``rate:dot_flops`` eight chained
    ``fused_linear`` calls on [V/data, h] @ [h, h]; ``rate:eltwise_bytes``
    the reference's solver-shaped probe (two stacked layers through
    ``core.subproblems`` with ``use_kernels=True``: ``fused_linear``,
    ``admm_pgrad``, ``relu_zupdate``, ``fista_zlast``, and with ``grid``
    ``backtrack_resnorm`` and ``grid_project``).

    One op of a ``LocalRing`` step covers every shard, while the DAG
    replays ``world`` devices on one executor slot: the per-op overhead
    and the link (a shift is a ``torch.roll`` on the device, priced at its
    measured copy rate) are stored per device, i.e. divided by ``world``,
    so the replay of ``world`` devices adds back up to the measured time.
    """
    import torch
    from repro_torch.analysis.costs import timed
    from repro_torch.core import subproblems as sp

    costs = costs or CostTable()
    dev = ring.device
    mesh = ring.mesh
    world = mesh.data * mesh.model
    rows = max(V // mesh.data, 1)

    def t(fn, *args):
        return timed(fn, *args, iters=iters, reps=reps, device=dev)

    x = torch.ones((mesh.data, mesh.model, 4, h), device=dev)
    t_empty = t(lambda v: v + 1.0, x)
    costs.set("step:dispatch", t_empty)

    # a compute burn BETWEEN consecutive collectives, as the real step's
    # collectives sit between solver phases. Shorter than the reference's
    # 30 rounds: one stream has no scheduling skew to absorb, and a toll of
    # one op must stand out of the burn's noise
    def burn(v):
        for _ in range(BURN_ROUNDS):
            v = torch.clamp_min(v * 1.0001 + 0.01, 0.0) - 0.005
        return v

    def burn_chain(v):
        for _ in range(chain):
            v = burn(v)
        return v

    def pp_chain(v):
        for _ in range(chain):
            (v,) = ring.finish(ring.shift([burn(v)], +1, "model"))
        return v

    def ps_chain(v):
        for _ in range(chain):
            v = burn(v)
            s = ring.psum(v.sum(dim=(2, 3)), ("data", "model"))
            v = v + s[..., None, None] * 1e-9
        return v

    t_burn = t(burn_chain, x)
    t_pp = t(pp_chain, x)
    t_ps = t(ps_chain, x)
    per_op = t_burn / _recorded_segment(burn_chain, x).n_eqns
    costs.set("rate:op_overhead", per_op / world)
    toll_pp = max((t_pp - t_burn) / chain, 1e-9)
    toll_ps = max((t_ps - t_burn) / chain, 1e-9)
    costs.set("collective:ppermute", toll_pp)
    costs.set("collective:psum", toll_ps)
    costs.set("collective:all_gather", toll_ps)

    # async issue: the shift's result is only returned, not consumed
    t_iss = t(lambda v: (v + 1.0, ring.shift([v], +1, "model")), x)
    # an async start never costs more than the full blocking rendezvous
    toll_iss = min(max(t_iss - t_empty, 1e-10), toll_pp)
    costs.set("collective:ppermute:issue", toll_iss)
    costs.set("collective:psum:issue", min(toll_iss, toll_ps))
    costs.set("collective:all_gather:issue", min(toll_iss, toll_ps))

    # compute rates in the DAG's units (one device: the probes run off-ring)
    def rest(t_total, seg):
        return max(t_total - seg.n_eqns * per_op, 0.05 * t_total)

    a = torch.ones((rows, h), device=dev)
    w = torch.ones((h, h), device=dev) / h

    def dots(p, W):
        for _ in range(8):
            p = sp._matmul(p, W, True)
        return p

    seg = _recorded_segment(dots, a, w)
    costs.set("rate:dot_flops", max(seg.flops / rest(t(dots, a, w), seg),
                                    1.0))

    def layer_fam(p, W, b, z, q, u):
        r = sp._residual(p, W, b, z, True)
        pn, _, rn = sp.update_p(p, W, b, z, q, u, 1.0, 1.0, 1.0, grid=grid,
                                r0=r, use_kernels=True)
        Wn, _, rw = sp.update_W(pn, W, b, z, q, u, 1.0, 1.0, 1.0,
                                first=False, r0=rn, use_kernels=True)
        a2 = z - rw
        zn = sp._zupdate(a2, q, z, 1.0, True)
        qn = sp.update_q(pn, u, torch.relu(zn), 1.0, 1.0, None)
        return pn, Wn, a2, zn, qn, u + (pn - qn)

    def solver_probe(p, W, b, z, q, u, labels, mask):
        pn, Wn, a2, zn, qn, un = layer_fam(p, W, b, z, q, u)
        m = a2.shape[0]
        zl = sp.update_z_last(a2.reshape(-1, h), z.reshape(-1, h),
                              labels.repeat(m), mask.repeat(m), 1.0,
                              fista_iters, n_classes=n_classes,
                              use_kernels=True)
        return pn, Wn, zn, zl, qn, un

    m_loc = 2
    pa = torch.full((m_loc, rows, h), 0.1, device=dev)
    probe_args = (pa, torch.stack([w] * m_loc),
                  torch.zeros((m_loc, h), device=dev), pa, pa, pa,
                  torch.zeros((rows,), dtype=torch.int32, device=dev),
                  torch.ones((rows,), device=dev))
    seg = _recorded_segment(solver_probe, *probe_args)
    t_probe = t(solver_probe, *probe_args)
    t_res = max(t_probe - seg.n_eqns * per_op
                - seg.flops / costs.get("rate:dot_flops"), 0.05 * t_probe)
    costs.set("rate:eltwise_bytes", max(seg.bytes / t_res, 1.0))

    # link: a LocalRing shift is a copy on the device; price its bandwidth
    # at the measured copy rate of one step's boundary slab, per device
    slab = torch.ones((mesh.data, mesh.model, 1, rows, h), device=dev)
    t_copy = max(t(lambda v: ring.shift([v], +1, "model"), slab) - per_op,
                 1e-9)
    costs.set("link:latency", toll_iss / 4.0)
    costs.set("link:bandwidth", slab.nbytes / t_copy / world)
    costs.meta.update({
        "mesh": dict(mesh.shape), "V": V, "h": h, "world": world,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")})
    return costs


# ---------------------------------------------------------------------------
# Replay-searched schedule choices (hand rules kept as documented fallbacks)
# ---------------------------------------------------------------------------

def choose_psum_mode(codec, shape, world_size: int,
                     costs: Optional[CostTable] = None) -> str:
    """The psum collective the REPLAY model picks: price all three physical
    realizations with the link model and return the cheapest.

      * ``psum`` (plain fp32): ring reduce-scatter + all-gather, ``2*(w-1)``
        rounds each moving ``4n/w`` bytes,
      * ``code_psum``: same rounds over the int32 code container, plus the
        shared-grid encode pass,
      * ``gather``: ``w-1`` all-gather rounds over the PACKED container
        (``bits/8`` bytes per element) plus the ``w``-way local decode-sum.

    With no `costs`, falls back to the hand-derived ring byte rule
    :func:`repro_torch.comm.transport.psum_mode` (``gather`` iff
    ``world*bits < 64``). In the bandwidth-
    dominated limit (latency → 0, compute → 0) the replay prices reduce to
    exactly that rule; a latency-dominated link shifts the break-even
    toward ``gather`` (half the rounds).
    """
    from repro_torch.comm.codecs import Fp32Codec
    from repro_torch.comm.transport import psum_mode
    if costs is None:
        return psum_mode(codec, world_size)
    if isinstance(codec, Fp32Codec) or codec.bits >= 32:
        return "psum"
    link = costs.link
    w = int(world_size)
    n = int(math.prod(int(s) for s in shape))
    elt = costs.get("rate:eltwise_bytes")
    quant = 2 * 4 * n / elt                      # encode: read x, write codes
    t_psum = 2 * (w - 1) * link.transfer_time(4 * n / w)
    t_code = 2 * (w - 1) * link.transfer_time(4 * n / w) + quant
    body = math.ceil(n * codec.bits / 8)
    decode = w * 2 * n / elt                     # unpack+sum each arrival
    t_gather = (w - 1) * link.transfer_time(body) + quant + decode
    prices = {"psum": t_psum, "code_psum": t_code, "gather": t_gather}
    return min(prices, key=lambda m: (prices[m], m))


def choose_overlap(dag_baseline: StepDag, dag_overlap: StepDag,
                   costs: Optional[CostTable] = None, *,
                   n_workers: Optional[int] = None) -> bool:
    """Replay both step variants and return True iff the double-buffered
    schedule is predicted no slower. With no `costs` the hand default
    (overlap on) is returned."""
    if costs is None:
        return True
    base = replay(dag_baseline, costs, n_workers=n_workers)
    over = replay(dag_overlap, costs, n_workers=n_workers)
    return over.step_time_s <= base.step_time_s


class ScheduleCostModel:
    """Per-boundary bit-width schedule → predicted step seconds: the
    ``objective="walltime"`` hook of
    :class:`repro_torch.comm.controller.BitWidthController`.

    `edge_bytes_fn(schedule)` maps a controller schedule (one bits entry
    per managed edge) to per-link physical wire bytes keyed by the DAG's
    ppermute edge names — for a :class:`~repro_torch.comm.transport.PaddedWire`
    container step that is the (schedule-independent) container capacity;
    for a codec-formatted wire it is the packed payload at the scheduled
    width. Predictions are memoized: the controller probes many candidate
    schedules per control step and hysteresis keeps the distinct set small.
    """

    def __init__(self, dag: StepDag, costs: CostTable,
                 edge_bytes_fn: Callable[[Tuple[int, ...]], Dict[str, int]],
                 *, n_workers: Optional[int] = None):
        self.dag = dag
        self.costs = costs
        self.edge_bytes_fn = edge_bytes_fn
        self.n_workers = n_workers
        self._cache: Dict[Tuple[int, ...], float] = {}

    def __call__(self, schedule: Sequence[int]) -> float:
        key = tuple(int(b) for b in schedule)
        if key not in self._cache:
            dag = self.dag.with_wire_bytes(self.edge_bytes_fn(key))
            self._cache[key] = replay(dag, self.costs,
                                      n_workers=self.n_workers).step_time_s
        return self._cache[key]
