"""Residual-driven adaptive bit-width control (AdaQP-style, gradient-free).

Counterpart of ``repro.comm.controller`` (host logic, so the port keeps an
exact copy). The paper's pdADMM-G-Q picks one bit-width offline and keeps
it for the whole run; here each managed edge gets a bit-width per
iteration from the ADMM primal residual ``r_l = ||p_{l+1} - q_l||``. While
a residual is near its peak the constraint is loose and coarse wire noise
is masked (few bits suffice); as it contracts, the exchange graduates to
finer grids so quantization error never dominates the remaining constraint
violation.

  * **Bounded switching.** Bit-width is a small enum (`allowed_bits`);
    hysteresis and dwell bound the switches to ~len(allowed_bits) per edge
    over a run. On the padded-container ring a schedule change swaps a
    host-side widths table; on a uniform-codec ring it swaps a cached step.
  * **Global byte budget.** Given a total-byte budget for the managed edges,
    the controller demotes the loosest (highest-residual) edges first until
    the projected per-iteration spend fits the remaining budget.

``train_adaptive`` is the single-host loop that drives the controller over
``admm_edges``. ``objective="walltime"`` promotes the floor's widths where
the replay cost model (``analysis.replay.ScheduleCostModel``) predicts no
cost in time.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    allowed_bits: Tuple[int, ...] = (4, 8, 16)
    min_bits: int = 4
    max_bits: int = 16
    # peak-normalized residual ratio ABOVE threshold -> that bit-width;
    # below every threshold -> max_bits. Sorted descending by threshold.
    thresholds: Tuple[Tuple[float, int], ...] = ((0.30, 4), (0.06, 8))
    hysteresis: float = 0.2    # relative ratio margin required to switch
    min_dwell: int = 3         # iterations an edge must hold its bit-width
    byte_budget: Optional[float] = None   # total bytes for managed edges
    total_iters: Optional[int] = None     # needed when byte_budget is set
    # "global": every edge follows the summed residual's phase (coarse while
    # training is in flux, fine as it converges); per-edge differentiation
    # then comes only from budget-aware promotion staggering. "per_edge":
    # each edge normalizes against its own peak — sharper differentiation,
    # but an edge that never becomes active (peak ~ 0) reads as permanently
    # "at peak" and stays pinned at min_bits, which persists its projection
    # error for the whole run. Global is the accuracy-safe default.
    signal: str = "global"
    # "bytes" (default): emit the residual-driven accuracy floor directly —
    # the coarsest schedule the thresholds allow. "walltime": treat that
    # floor as the ACCURACY constraint and spend any bandwidth that is free
    # in *time*: each edge is promoted to the finest legal width whose
    # predicted step time (via the replay cost model passed to the
    # controller) stays within `walltime_slack` of the floor schedule's —
    # on a padded-container wire the physical payload is schedule-
    # independent, so precision is free; on a codec wire bigger payloads
    # cost time and the floor survives. Requires `cost_model`.
    objective: str = "bytes"
    walltime_slack: float = 0.0    # relative predicted-time headroom

    def clamp(self, bits: int) -> int:
        bits = min(max(bits, self.min_bits), self.max_bits)
        legal = [b for b in sorted(self.allowed_bits)
                 if self.min_bits <= b <= self.max_bits]
        # nearest legal value at or above the request (never under-deliver
        # precision except at the top of the range)
        for b in legal:
            if b >= bits:
                return b
        return legal[-1]


class BitWidthController:
    """Assigns a bit-width to each managed edge every iteration.

    `edge_elements[i]` is the number of quantized payload elements edge *i*
    moves per iteration (used for budget projection; e.g. a pdADMM boundary
    moving q forward and p backward manages ``2 * V * n_l`` elements).
    """

    def __init__(self, edge_elements: Sequence[int],
                 config: ControllerConfig = ControllerConfig(), *,
                 cost_model=None):
        if config.byte_budget is not None and not config.total_iters:
            raise ValueError("byte_budget requires total_iters")
        if not [b for b in config.allowed_bits
                if config.min_bits <= b <= config.max_bits]:
            raise ValueError(
                f"no allowed_bits {config.allowed_bits} inside "
                f"[min_bits={config.min_bits}, max_bits={config.max_bits}]")
        if config.objective not in ("bytes", "walltime"):
            raise ValueError(f"unknown objective {config.objective!r}")
        if config.objective == "walltime" and cost_model is None:
            raise ValueError(
                "objective='walltime' needs a cost_model: a callable "
                "schedule -> predicted step seconds (see "
                "repro_torch.analysis.replay.ScheduleCostModel)")
        self.config = config
        self.cost_model = cost_model
        self.edge_elements = [int(e) for e in edge_elements]
        n = len(self.edge_elements)
        self._bits: List[int] = [config.clamp(config.min_bits)] * n
        self._peak: List[float] = [0.0] * n
        self._global_peak: float = 0.0
        self._last_switch: List[int] = [-config.min_dwell] * n
        self._emitted: Tuple[int, ...] = tuple(self._bits)
        self.spent_bytes: float = 0.0
        self.n_switches: int = 0
        self._cooldown_until: int = -1   # force_widest() window end

    # -- policy ------------------------------------------------------------
    def _desired(self, ratio: float) -> int:
        for thr, bits in sorted(self.config.thresholds, reverse=True):
            if ratio > thr:
                return self.config.clamp(bits)
        return self.config.clamp(self.config.max_bits)

    def _edge_bytes(self, i: int, bits: int) -> float:
        return math.ceil(self.edge_elements[i] * bits / 8)

    def _legal(self) -> List[int]:
        cfg = self.config
        return sorted(b for b in cfg.allowed_bits
                      if cfg.min_bits <= b <= cfg.max_bits)

    def _per_iter_budget(self, iteration: int) -> Optional[float]:
        cfg = self.config
        if cfg.byte_budget is None:
            return None
        iters_left = max(cfg.total_iters - iteration, 1)
        return max(cfg.byte_budget - self.spent_bytes, 0.0) / iters_left

    def _projected(self) -> float:
        return sum(self._edge_bytes(i, b) for i, b in enumerate(self._bits))

    def assign(self, residuals: Sequence[float], iteration: int
               ) -> Tuple[int, ...]:
        """One control step: residuals -> per-edge bit-widths."""
        cfg = self.config
        assert len(residuals) == len(self.edge_elements)
        per_iter = self._per_iter_budget(iteration)
        legal = self._legal()
        g = sum(float(r) for r in residuals)
        self._global_peak = max(self._global_peak, g)
        g_ratio = g / self._global_peak if self._global_peak > 0 else 1.0
        for i, r in enumerate(residuals):
            r = float(r)
            self._peak[i] = max(self._peak[i], r)
            if cfg.signal == "global":
                ratio = g_ratio
            else:
                ratio = r / self._peak[i] if self._peak[i] > 0 else 1.0
            desired = self._desired(ratio)
            cur = self._bits[i]
            if desired == cur:
                continue
            if iteration - self._last_switch[i] < cfg.min_dwell:
                continue
            # hysteresis: the decision must survive a +/- margin on the ratio
            margin = 1.0 + cfg.hysteresis
            if desired > cur and self._desired(ratio * margin) <= cur:
                continue
            if desired < cur and self._desired(ratio / margin) >= cur:
                continue
            if desired > cur and per_iter is not None:
                # budget-aware promotion: take the largest affordable step so
                # we never promote into an immediate budget demotion (which
                # would thrash schedules and defeat hysteresis)
                head = per_iter - self._projected()
                afford = [b for b in legal if cur < b <= desired and
                          self._edge_bytes(i, b) - self._edge_bytes(i, cur)
                          <= head]
                if not afford:
                    continue
                desired = afford[-1]
            self._bits[i] = desired
            self._last_switch[i] = iteration
            self.n_switches += 1

        self._enforce_budget(iteration)
        self._emitted = (self._walltime_promote(iteration)
                         if cfg.objective == "walltime"
                         else tuple(self._bits))
        if iteration < self._cooldown_until:
            # post-rollback cooldown (force_widest): emit the widest legal
            # width on every edge, overriding even the budget — recovering
            # from corruption outranks the byte target for a few steps. The
            # floor/peaks keep evolving underneath, so the policy resumes
            # exactly where it would have been once the window closes.
            self._emitted = (self._legal()[-1],) * len(self._bits)
        self.spent_bytes += sum(self._edge_bytes(i, b)
                                for i, b in enumerate(self._emitted))
        return self._emitted

    def force_widest(self, iteration: int, cooldown: int) -> None:
        """Recovery hook (rollback response): make every `assign` in
        iterations ``[iteration, iteration + cooldown)`` emit the widest
        legal width — quantization noise must not be in the suspect set
        while the run re-converges past a corruption."""
        self._cooldown_until = max(self._cooldown_until,
                                   int(iteration) + int(cooldown))

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable control state (everything `assign` evolves) —
        saved into checkpoint manifests so a restored run resumes the
        schedule policy mid-flight instead of from the floor."""
        return {
            "bits": list(self._bits),
            "peak": list(self._peak),
            "global_peak": self._global_peak,
            "last_switch": list(self._last_switch),
            "emitted": list(self._emitted),
            "spent_bytes": self.spent_bytes,
            "n_switches": self.n_switches,
            "cooldown_until": self._cooldown_until,
        }

    def load_state_dict(self, sd: dict) -> None:
        self._bits = [int(b) for b in sd["bits"]]
        self._peak = [float(p) for p in sd["peak"]]
        self._global_peak = float(sd["global_peak"])
        self._last_switch = [int(i) for i in sd["last_switch"]]
        self._emitted = tuple(int(b) for b in sd["emitted"])
        self.spent_bytes = float(sd["spent_bytes"])
        self.n_switches = int(sd["n_switches"])
        self._cooldown_until = int(sd.get("cooldown_until", -1))

    def _walltime_promote(self, iteration: int) -> Tuple[int, ...]:
        """Promote each edge of the accuracy floor to the finest legal width
        whose predicted step time stays within ``walltime_slack`` of the
        floor schedule's, budget permitting. The floor (`self._bits`) keeps
        evolving under the residual policy with dwell/hysteresis untouched;
        the emitted schedule is a pure function of it, so it inherits the
        floor's stability and `n_switches` still counts policy switches
        only. Promotion only ever ADDS precision, so the residual-driven
        accuracy guarantee of the floor is preserved."""
        floor = tuple(self._bits)
        limit = self.cost_model(floor) * (1.0 + self.config.walltime_slack)
        per_iter = self._per_iter_budget(iteration)
        legal = self._legal()
        bits = list(floor)
        for i in range(len(bits)):
            for b in reversed(legal):
                if b <= bits[i]:
                    break
                trial = tuple(bits[:i] + [b] + bits[i + 1:])
                spend = sum(self._edge_bytes(j, t)
                            for j, t in enumerate(trial))
                if per_iter is not None and spend > per_iter:
                    continue
                if self.cost_model(trial) <= limit * (1.0 + 1e-9):
                    bits[i] = b
                    break
        return tuple(bits)

    def _enforce_budget(self, iteration: int) -> None:
        """Safety net for a shrinking budget (promotions are already
        budget-aware): demote the loosest edges until the projection fits."""
        per_iter = self._per_iter_budget(iteration)
        if per_iter is None:
            return
        legal = self._legal()
        while self._projected() > per_iter:
            # demote the edge spending the most that can still step down
            cand = [(self._edge_bytes(i, b), i) for i, b in
                    enumerate(self._bits) if b > legal[0]]
            if not cand:
                break
            _, i = max(cand)
            below = [b for b in legal if b < self._bits[i]]
            self._bits[i] = below[-1]
            self._last_switch[i] = iteration
            self.n_switches += 1

    @property
    def schedule(self) -> Tuple[int, ...]:
        """The emitted schedule: the residual-driven accuracy floor, wall-
        time-promoted when ``objective='walltime'``."""
        return self._emitted


# ---------------------------------------------------------------------------
# Managed-edge layouts
# ---------------------------------------------------------------------------

def stage_ring_edges(n_stages: int, V: int, h: int,
                     split_pq: bool = False) -> List[int]:
    """Managed-edge element counts for the DISTRIBUTED stage ring under the
    padded-container wire (``distributed_train(mixed_width=True)``): one
    edge per ring boundary moving the q-forward + p-backward slab pair
    (``2 * V * h`` elements), or — with ``split_pq`` — separate q edges
    followed by p edges so the controller can format the two directions
    independently. Unlike the single-host `admm_edges` layout, these edges
    are genuinely per-boundary inside ONE compiled SPMD step: schedule
    changes swap a traced widths table, not compilations."""
    if split_pq:
        return [V * h] * (2 * n_stages)
    return [2 * V * h] * n_stages


def admm_edges(dims, V: int) -> List[int]:
    """Managed-edge element counts for `train_adaptive`: per boundary l, one
    p/q edge (q_l forward + p_{l+1} backward: 2*V*n_l elements) followed by
    one u edge (u_l forward: V*n_l elements)."""
    n_bound = len(dims) - 2
    return ([2 * V * dims[l + 1] for l in range(n_bound)] +
            [V * dims[l + 1] for l in range(n_bound)])


def train_adaptive(seed, X, labels, masks, dims, config, epochs: int, *,
                   controller: BitWidthController, ledger,
                   grids_by_bits: Dict[int, "object"],
                   control_interval: int = 1, ckpt=None, ckpt_every: int = 0,
                   resume: bool = False, recovery=None, fault_hook=None,
                   init=None, device=None, jit: bool = True):
    """pdADMM-G-Q training with the controller assigning each boundary's
    p/q exchange (and, with an ``admm_edges``-shaped controller, its u
    exchange) a bit-width every iteration; every payload goes on the
    ledger. Returns ``(state, hist)`` like ``pdadmm.train``.

    The p/q wire is the optimisation grid itself (the projection is the
    prox of the grid's indicator, as in the paper); the u wire is an affine
    codec on the transmitted view of the dual (the stored dual stays
    exact). With a controller over the p/q edges only (the legacy layout)
    u flies fp32. One step per distinct schedule, built lazily.

    The loop rides ``pdadmm.run_chunked``: each control step runs
    ``control_interval`` iterations under its schedule with one host
    transfer of the chunk's metrics, then the controller is replayed over
    the chunk's interior iterations, so its dwell/peak/budget state
    evolves as if consulted every iteration (``control_interval=1`` is the
    per-iteration loop). ``jit`` is ``run_chunked``'s: on the card each
    schedule's step is captured once as a CUDA graph and replayed in
    every control step that uses it; every schedule's graph reads and
    writes one set of state buffers, so a switch copies nothing.

    ``seed`` (an int or a CPU ``torch.Generator``) draws the initial state
    on the grid the first iterations train on, unless ``init`` gives one
    (an ``ADMMState``; the reference's initial state comes over this way,
    since its ``jax.random`` numbers cannot be drawn here). Runs on
    ``device`` (default: the card).

    Fault tolerance: ``ckpt`` (a CheckpointManager or a directory) with
    ``ckpt_every=k`` saves state, controller and ledger rollup atomically
    every k iterations; ``resume=True`` restores the latest checkpoint
    first. ``fault_hook(iteration, state) -> state`` is the chaos seam: it
    may corrupt the state a chunk trains on. With either, each chunk's
    last objective and residual are checked (non-finite, or a spike past
    the last accepted objective by ``faults.SPIKE_TOL``): a bad chunk is
    discarded and rolled back to the latest checkpoint (or the initial
    state), and :meth:`BitWidthController.force_widest` holds the widest
    width for ``recovery.cooldown`` control steps.
    """
    from repro_torch import resolve_device
    from repro_torch.comm import ledger as ledger_mod
    from repro_torch.comm.codecs import FP32, AffineCodec, GridCodec
    from repro_torch.comm.faults import SPIKE_TOL, RecoveryConfig
    from repro_torch.core import pdadmm

    device = resolve_device(device)
    X, labels = X.to(device), labels.to(device)
    masks = {k: m.to(device) for k, m in masks.items()}
    L = len(dims) - 1
    V = X.shape[0]
    n_bound = L - 1
    manage_u = len(controller.edge_elements) == 2 * n_bound
    if not manage_u and len(controller.edge_elements) != n_bound:
        raise ValueError(f"{len(controller.edge_elements)} managed edges for "
                         f"{n_bound} boundaries; expected one or two each")

    if init is None:
        # the grid the first iterations train on (the initial schedule's
        # width, never coarser than 8): a coarser projection at init breaks
        # the forward consistency the residual-driven schedule reads from
        init_bits = max(controller.schedule[0],
                        min(8, max(grids_by_bits)))
        init_grid = grids_by_bits.get(init_bits,
                                      grids_by_bits[max(grids_by_bits)])
        state = pdadmm.init_state(
            seed, X, dims, dataclasses.replace(config, quantize_p=True,
                                               quantize_q=True,
                                               grid=init_grid),
            device=device)
    else:
        state = init

    step_cache = {}

    def split(schedule):
        pq = schedule[:n_bound]
        uu = schedule[n_bound:] if manage_u else None
        return pq, uu

    def step_for(schedule):
        if schedule not in step_cache:
            pq, uu = split(schedule)
            p_grids = tuple([None] + [grids_by_bits[b] for b in pq])
            q_grids = tuple(grids_by_bits[b] for b in pq)
            u_codecs = (tuple(AffineCodec(b) for b in uu)
                        if uu is not None else None)
            step_cache[schedule] = functools.partial(
                pdadmm.iterate, config=config, p_grids=p_grids,
                q_grids=q_grids, u_codecs=u_codecs)
        return step_cache[schedule]

    hist = {"objective": [], "residual": [], "val_acc": [], "test_acc": [],
            "schedules": []}
    bound_res = [0.0] * n_bound
    interval = max(1, int(control_interval))

    mgr = None
    if ckpt is not None:
        from repro_torch.ckpt.manager import CheckpointManager
        mgr = ckpt if hasattr(ckpt, "save") else CheckpointManager(str(ckpt))
    if (resume or ckpt_every) and mgr is None:
        raise ValueError("resume=/ckpt_every= need ckpt= (a "
                         "CheckpointManager or a directory path)")
    guard = mgr is not None or fault_hook is not None
    rec = recovery if recovery is not None else RecoveryConfig()
    state0, ctl_state0 = state, controller.state_dict()
    prev_obj = float("inf")
    n_rb = 0
    e = 0

    def _trim(at):
        for k in ("objective", "residual", "schedules"):
            del hist[k][at:]

    def _restore():
        nonlocal state, e, prev_obj, bound_res
        state, manifest = mgr.restore(like=state)
        ex = manifest.get("extra") or {}
        e = int(ex.get("iteration", 0))
        prev_obj = float(ex.get("prev_obj", float("inf")))
        bound_res = [float(r) for r in ex.get("bound_res",
                                              [0.0] * n_bound)]
        if ex.get("controller"):
            controller.load_state_dict(ex["controller"])
        _trim(e)

    if resume and mgr is not None and mgr.latest_step() is not None:
        _restore()

    while e < epochs:
        residuals = bound_res + bound_res if manage_u else bound_res
        sched = controller.assign(residuals, e)
        c = min(interval, epochs - e)
        if fault_hook is not None:
            state = fault_hook(e, state)
        state, ms = pdadmm.run_chunked(
            step_for(sched), state, (X, labels, masks["train"]), c, chunk=c,
            jit=jit)
        if guard:
            obj_last = float(ms["objective"][-1])
            res_last = float(ms["residual"][-1])
            bad = (not math.isfinite(obj_last)
                   or not math.isfinite(res_last)
                   or (math.isfinite(prev_obj) and obj_last > prev_obj
                       + SPIKE_TOL * (1.0 + abs(prev_obj))))
            if bad:
                n_rb += 1
                if n_rb > rec.max_rollbacks:
                    raise RuntimeError(
                        f"train_adaptive: {n_rb} rollbacks exceeded "
                        f"max_rollbacks={rec.max_rollbacks}")
                if ledger is not None:
                    ledger.record_fault(e, "step", "rolled_back", 1)
                if mgr is not None and mgr.latest_step() is not None:
                    _restore()
                else:
                    state, e, prev_obj = state0, 0, float("inf")
                    bound_res = [0.0] * n_bound
                    controller.load_state_dict(dict(ctl_state0))
                    _trim(0)
                controller.force_widest(e, rec.cooldown)
                continue
        # primal + dual residual per boundary: the primal part collapses to
        # 0 once p and q share a grid, the dual part keeps decaying with
        # real progress; their sum drives the width everywhere
        chunk_res = [[float(r) + float(d) for r, d in zip(lr, ldr)]
                     for lr, ldr in zip(ms["layer_residuals"],
                                        ms["layer_dual_residuals"])]
        pq, uu = split(sched)
        codecs = [GridCodec(grids_by_bits[b]) for b in pq]
        u_codecs = ([AffineCodec(b) for b in uu] if uu is not None else FP32)
        for i in range(c):
            hist["schedules"].append(sched)
            ledger_mod.record_admm_iteration(ledger, e + i, dims, V, codecs,
                                             codecs, u_codecs)
            hist["objective"].append(float(ms["objective"][i]))
            hist["residual"].append(float(ms["residual"][i]))
        # replay the controller over the chunk's interior iterations
        for i in range(1, c):
            br = chunk_res[i - 1]
            controller.assign(br + br if manage_u else br, e + i)
        bound_res = chunk_res[-1]
        prev_obj = hist["objective"][-1]
        e_before = e
        e += c
        if (mgr is not None and ckpt_every
                and e_before // ckpt_every != e // ckpt_every):
            extra = {"iteration": e, "prev_obj": prev_obj,
                     "bound_res": bound_res,
                     "controller": controller.state_dict()}
            if ledger is not None:
                extra["ledger"] = ledger.summary()
            mgr.save(e, state, extra=extra)
    hist["val_acc"].append(float(pdadmm.forward_accuracy(
        state, X, labels, masks["val"])))
    hist["test_acc"].append(float(pdadmm.forward_accuracy(
        state, X, labels, masks["test"])))
    return state, hist
