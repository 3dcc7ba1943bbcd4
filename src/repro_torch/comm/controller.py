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

``objective="walltime"`` needs the replay cost model and waits for the
port's analysis slice, as does the single-host ``train_adaptive`` loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


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
    # "bytes": emit the residual-driven accuracy floor directly — the
    # coarsest schedule the thresholds allow. "walltime" (promote edges
    # whose finer width the replay cost model predicts to be free in time)
    # raises until the port has the cost model.
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
                 config: ControllerConfig = ControllerConfig()):
        if config.byte_budget is not None and not config.total_iters:
            raise ValueError("byte_budget requires total_iters")
        if not [b for b in config.allowed_bits
                if config.min_bits <= b <= config.max_bits]:
            raise ValueError(
                f"no allowed_bits {config.allowed_bits} inside "
                f"[min_bits={config.min_bits}, max_bits={config.max_bits}]")
        if config.objective not in ("bytes", "walltime"):
            raise ValueError(f"unknown objective {config.objective!r}")
        if config.objective == "walltime":
            raise NotImplementedError(
                "objective='walltime' prices schedules with the replay cost "
                "model, which comes with the port's analysis slice")
        self.config = config
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
        self._emitted = tuple(self._bits)
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
        """The emitted schedule: the residual-driven accuracy floor."""
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
    """Managed-edge element counts for the single-host adaptive loop
    (``train_adaptive``, a later slice of the port): per boundary l, one
    p/q edge (q_l forward + p_{l+1} backward: 2*V*n_l elements) followed by
    one u edge (u_l forward: V*n_l elements)."""
    n_bound = len(dims) - 2
    return ([2 * V * dims[l + 1] for l in range(n_bound)] +
            [V * dims[l + 1] for l in range(n_bound)])
