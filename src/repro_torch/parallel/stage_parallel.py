"""Stage-parallel pdADMM-G / pdADMM-G-Q on a (data, model) ring — the
paper's model parallelism.

Counterpart of ``repro.parallel.stage_parallel``. Mapping:

  * layer-clients -> ring stages: homogeneous h→h layers stacked [L, ...],
    ``m = L / model`` consecutive layers per stage; every update of the
    iteration is one batched solve over all the layers this process holds
    (``D · S · m`` of them on a :class:`~repro_torch.parallel.ring.LocalRing`),
    since the updates read only the previous iteration's neighbours (no
    dependency between layers within an iteration — Algorithm 1);
  * node rows -> the data axis: p/q/z/u row-sharded, each data shard
    keeping its OWN W and b. Like the reference's devices, a shard's W/b
    updates reduce over its local rows only and nothing sums them across
    data shards, so with data > 1 the shards' weights drift apart; a host
    read returns data shard 0's (``parallel.ring``);
  * the p/q/u messages between layer-clients -> one forward (q, u) and one
    backward (p) ring shift per iteration, encoded by the wire codec
    (pdADMM-G-Q: grid codes) or, with a :class:`PaddedWire`, in fixed-size
    containers at a per-stage width.

Homogenisation (as in the reference): the input is projected to width h
beforehand (``Xp = relu(X @ P0)``), and the risk reads the first C columns
of the last layer's z (the head folded into layer L-1). First/last-layer
special cases are masked, so every stage computes the same thing.

Not in this slice of the port: the sentinel step (``health=`` /
``faults=``), checkpoints (``ckpt=`` / ``resume=``) and
``make_sentinel_primer`` (the fault-tolerance slice); the replay cost-model
hooks ``step_program_plan``, ``trace_step_dag``, ``choose_overlap_for``,
``step_cost_model`` and ``overlap="replay"`` (the analysis slice).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.codecs import FP32, WireCodec, codec_for_grid
from repro_torch.comm.transport import (ContainerExchange, NeighborExchange,
                                        PaddedWire)
from repro_torch.core import subproblems as sp
from repro_torch.core.pdadmm import ADMMConfig, _generator, relu, run_chunked
from repro_torch.parallel.ring import LocalRing

# ring-shift tags of the three boundary exchanges (told apart in flight)
TAG_Q, TAG_U, TAG_P = 0, 1, 2

FAULT_SLICE = ("the port's fault-tolerance slice (comm/faults.py, "
               "ckpt/manager.py)")
ANALYSIS_SLICE = "the port's analysis slice (analysis/replay.py)"


class StackState(NamedTuple):
    """All leaves stacked over layers: W [L,h,h], b [L,h], others [L,V,h]
    (global layout). On a ring each leaf takes the shard layout of
    :data:`STACK_SPECS`."""
    p: torch.Tensor
    W: torch.Tensor
    b: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    u: torch.Tensor


STACK_SPECS = StackState(p="layers_rows", W="layers", b="layers",
                         z="layers_rows", q="layers_rows", u="layers_rows")


def init_stack(seed, Xp, L: int, config: ADMMConfig) -> StackState:
    """Forward-consistent init from ``Xp`` [V, h] (already projected), on
    Xp's device. ``seed``: an int or a CPU ``torch.Generator`` (not the
    reference's ``jax.random`` numbers; tests hand the reference's stack
    over through numpy)."""
    V, h = Xp.shape
    gen = _generator(seed)
    scale = float(np.sqrt(2.0 / h))
    Ws, zs, ps, qs = [], [], [], []
    cur = Xp
    for _ in range(L):
        Wl = (torch.randn((h, h), generator=gen, dtype=torch.float32)
              * scale).to(Xp.device)
        zl = cur @ Wl
        ql = relu(zl)
        if config.quantize_p and config.grid is not None:
            ql = config.grid.project(ql)
        Ws.append(Wl)
        ps.append(cur)
        zs.append(zl)
        qs.append(ql)
        cur = ql
    return StackState(
        p=torch.stack(ps), W=torch.stack(Ws),
        b=torch.zeros((L, h), dtype=torch.float32, device=Xp.device),
        z=torch.stack(zs), q=torch.stack(qs),
        u=torch.zeros((L, V, h), dtype=torch.float32, device=Xp.device))


def shard_stack(state: StackState, ring) -> StackState:
    """A global stack -> the ring's shard layout."""
    return StackState(*(ring.to_local(x, spec)
                        for x, spec in zip(state, STACK_SPECS)))


def gather_stack(state: StackState, ring) -> StackState:
    """The ring's shard layout -> the global stack a host read of the
    reference returns (W and b: data shard 0's)."""
    return StackState(*(ring.to_global(x, spec)
                        for x, spec in zip(state, STACK_SPECS)))


def _masked_ce_val(z, labels, label_mask, n_classes: int):
    """Risk on z[..., :C] (head folded into the last layer), summed over
    the rows of each leading index: z [..., V, h] -> [...]."""
    logp = torch.log_softmax(z[..., :n_classes], dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (nll * label_mask).sum(dim=-1)


def _fista_last(a, z_old, labels, label_mask, nu, n_classes, n_iters,
                use_kernels: bool = True):
    """Head-folded z_L solve of [..., V, h] layer slabs: ONE
    ``subproblems.update_z_last`` over the flattened rows (labels and mask
    [..., V] alike; the FISTA map is row-independent)."""
    h = a.shape[-1]
    z = sp.update_z_last(a.reshape(-1, h), z_old.reshape(-1, h),
                         labels.reshape(-1), label_mask.reshape(-1), nu,
                         n_iters, n_classes=n_classes,
                         use_kernels=use_kernels)
    return z.reshape(a.shape)


def _not_yet(what: str, where: str):
    return NotImplementedError(f"{what} comes with {where}")


def make_distributed_step(mesh, L: int, n_classes: int,
                          config: ADMMConfig, *, overlap: bool = False,
                          donate: bool = False,
                          p_codec: Optional[WireCodec] = None,
                          q_codec: Optional[WireCodec] = None,
                          wire: Optional[PaddedWire] = None,
                          health: bool = False, faults=None, ring=None):
    """Build the distributed ADMM iteration on ``ring`` (default: a
    :class:`LocalRing` of ``mesh`` on the card); returns ``(step, ring)``.

    ``overlap=False`` (the paper's ordering): ``step(state, Xp, labels,
    label_mask) -> (state, metrics)``, every boundary exchange encoded,
    shifted and decoded where its value is consumed. ``state`` and the
    data are in the ring's shard layout (:func:`shard_stack`,
    ``ring.to_local(x, "rows")``).

    ``overlap=True`` (double-buffered boundary slabs): ``step((state,
    inflight), ...) -> ((state, inflight), metrics)``. The q/u forward
    shift that iteration k+1 consumes at entry is started at the end of
    iteration k and finished at the entry of k+1; the backward p shift is
    started right after the p-solve and finished right before the q-update.
    Every shift moves exactly the values the fused ordering moves, so
    ``overlap=True`` gives the same bits. Prime the first carry with
    :func:`make_overlap_primer`.

    ``p_codec`` / ``q_codec`` override the wire format derived from
    ``config``. ``wire`` (a :class:`PaddedWire`) ships p and q in
    fixed-size containers instead: the step takes a trailing ``widths``
    table (``widths[0][s]`` the q width index of stage s, ``widths[1][s]``
    the p one; host integers), and each stage's exchanges run at its own
    width. u always flies fp32.

    ``donate=True`` writes the new state into the storage of the state
    passed in (and returns those tensors): each field is copied into its old
    storage as soon as the step has read the old value for the last time
    (z at the end, after the metrics), and its temporary is released, so the
    step holds one state plus the fields still in flight instead of two
    whole states. It costs one device copy per field.
    """
    if health or faults is not None:
        raise _not_yet("health=/faults= (the sentinel step)", FAULT_SLICE)
    if wire is not None and (p_codec is not None or q_codec is not None):
        raise ValueError("wire= (padded containers) replaces the static "
                         "p/q codecs")
    ring = LocalRing(mesh) if ring is None else ring
    nu, rho = config.nu, config.rho
    uk = config.use_kernels
    p_grid = config.grid if config.quantize_p else None
    q_grid = config.grid if config.quantize_q else None
    if p_codec is None:
        p_codec = codec_for_grid(p_grid)
    if q_codec is None:
        q_codec = codec_for_grid(q_grid)
    ex_q = NeighborExchange(ring, "model", q_codec, TAG_Q)
    ex_u = NeighborExchange(ring, "model", FP32, TAG_U)
    ex_p = NeighborExchange(ring, "model", p_codec, TAG_P)
    cex_q = cex_p = None
    if wire is not None:
        cex_q = ContainerExchange(ring, "model", wire, TAG_Q)
        cex_p = ContainerExchange(ring, "model", wire, TAG_P)
    n_stages = mesh.shape["model"]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split over {n_stages} stages")
    m = L // n_stages
    stages = ring.axis_index("model")
    # local stage slots holding global layer 0 (local layer 0) and layer
    # L-1 (local layer m-1), if this process holds them
    first = stages.index(0) if 0 in stages else None
    last = stages.index(n_stages - 1) if n_stages - 1 in stages else None

    def body(st, fly, Xp, labels, label_mask, widths):
        D, S = st.p.shape[:2]
        B = D * S * m

        def flat(t):
            return t.reshape(B, *t.shape[3:])

        def unflat(t):
            return t.reshape(D, S, m, *t.shape[1:])

        def settle(old, fresh):
            """Under donation: the new value into the old value's storage,
            once the old value is dead."""
            if not donate:
                return fresh
            old.copy_(fresh)
            return old

        if wire is not None:
            sel_q = [widths[0][s] for s in stages]
            sel_p = [widths[1][s] for s in stages]
            # decodes read the ORIGINATING stage's width
            sel_q_prev = [widths[0][(s - 1) % n_stages] for s in stages]
            sel_p_next = [widths[1][(s + 1) % n_stages] for s in stages]

        # ---- neighbour exchange (previous iteration's values) -------------
        if overlap:
            q_fly, u_fly = fly
            q_prev = (cex_q.finish_shift_from_prev(q_fly, st.q, sel_q_prev)
                      if wire is not None
                      else ex_q.finish_shift_from_prev(q_fly, st.q))
            u_prev = ex_u.finish_shift_from_prev(u_fly, st.u)
        elif wire is not None:
            q_prev = cex_q.shift_from_prev(st.q, sel_q, sel_q_prev)
            u_prev = ex_u.shift_from_prev(st.u)
        else:
            q_prev = ex_q.shift_from_prev(st.q)
            u_prev = ex_u.shift_from_prev(st.u)
        if first is not None:                 # layer 0 has no predecessor
            q_prev[:, first, 0] = 0.0
            u_prev[:, first, 0] = 0.0

        # ---- entry residuals r = z - pW - b, chained through the family ---
        W0, b0, z0 = flat(st.W), flat(st.b), flat(st.z)
        r_in = sp._residual(flat(st.p), W0, b0, z0, uk)

        # ---- p-update (layer 0 keeps p0 = Xp and its residual) ------------
        p_new, _, r_new = sp.update_p(flat(st.p), W0, b0, z0, flat(q_prev),
                                      flat(u_prev), nu, rho, config.tau0,
                                      grid=p_grid, r0=r_in, use_kernels=uk)
        p, r = unflat(p_new), unflat(r_new)
        if first is not None:
            p[:, first, 0] = Xp[:, 0]
            r[:, first, 0] = unflat(r_in)[:, first, 0]
        p = settle(st.p, p)
        del p_new, r_new, r_in

        if overlap:    # the W/b/z solves never read p_next: start it now
            p_fly = (cex_p.start_shift_from_next(p, sel_p)
                     if wire is not None else ex_p.start_shift_from_next(p))

        # ---- W-update (layer 0: zeroed q/u make the same formula exact) ---
        W, _, r = sp.update_W(flat(p), W0, b0, z0, flat(q_prev),
                              flat(u_prev), nu, rho, config.tau0,
                              first=False, r0=flat(r), use_kernels=uk)
        W = settle(st.W, unflat(W))

        # ---- b-update (exact: b += mean over the shard's rows) ------------
        db = r.mean(dim=1)
        b = settle(st.b, unflat(b0 + db))
        r = r - db[:, None, :]

        # ---- z-update (a = pW + b = z - r) ---------------------------------
        a = z0 - r
        del r
        z = unflat(sp._zupdate(a, flat(st.q), z0, nu, uk))
        if last is not None:
            z[:, last, m - 1] = _fista_last(
                unflat(a)[:, last, m - 1], st.z[:, last, m - 1],
                labels[:, 0], label_mask[:, 0], nu, n_classes,
                config.fista_iters, use_kernels=uk)

        # ---- q-update (needs the next layer's NEW p) ------------------------
        if wire is not None:
            p_next = (cex_p.finish_shift_from_next(p_fly, p, sel_p_next)
                      if overlap else
                      cex_p.shift_from_next(p, sel_p, sel_p_next))
        else:
            p_next = (ex_p.finish_shift_from_next(p_fly, p) if overlap
                      else ex_p.shift_from_next(p))
        fz = relu(z)
        q = sp.update_q(p_next, st.u, fz, nu, rho, q_grid)
        if last is not None:                  # no q for layer L-1
            q[:, last, m - 1] = st.q[:, last, m - 1]
        q = settle(st.q, q)

        # ---- dual update -----------------------------------------------------
        rd = p_next - q
        if last is not None:
            rd[:, last, m - 1] = 0.0
        u = st.u + rho * rd
        u = settle(st.u, u)

        # overlap: q and u are what the next entry exchange sends
        out_fly = None
        if overlap:
            out_fly = ((cex_q.start_shift_from_prev(q, sel_q)
                        if wire is not None
                        else ex_q.start_shift_from_prev(q)),
                       ex_u.start_shift_from_prev(u))

        # ---- metrics (per-shard sums, then the ring's psums) ---------------
        per = (2, 3, 4)
        sq = (rd * rd).sum(dim=per)                              # [D, S]
        res_sq = ring.psum(sq, ("model", "data")).reshape(())
        # per-stage primal residual: the controller's per-boundary signal
        seg = ring.psum(ring.all_gather(sq, "model"), "data")[0, 0]
        risk = torch.zeros_like(sq)
        if last is not None:
            risk[:, last] = _masked_ce_val(z[:, last, m - 1], labels[:, 0],
                                           label_mask[:, 0], n_classes)
        risk_val = ring.psum(ring.psum(risk, "model"), "data")
        # the reference's objective: rr chains the DUAL residual p_next - q
        # (not z - pW - b) with the z step
        rr = rd + (z - st.z)
        lag = 0.5 * nu * (rr * rr).sum(dim=per)
        g = q - relu(z)
        if last is not None:
            g[:, last, m - 1] = 0.0
        lag = lag + 0.5 * nu * (g * g).sum(dim=per)
        d = p - q_prev
        if first is not None:
            d[:, first, 0] = 0.0
        lag = lag + (u_prev * d).sum(dim=per) + 0.5 * rho * (d * d).sum(
            dim=per)
        lag = (ring.psum(lag, ("model", "data")) + risk_val).reshape(())
        metrics = {"residual": torch.sqrt(res_sq), "objective": lag,
                   "stage_residuals": torch.sqrt(seg)}
        new = StackState(p, W, b, settle(st.z, z), q, u)
        return new, out_fly, metrics

    def step(carry, Xp, labels, label_mask, widths=None):
        if (wire is not None) != (widths is not None):
            raise ValueError("a padded-wire step takes the widths table, "
                             "and only it does")
        st, fly = carry if overlap else (carry, None)
        new, out_fly, metrics = body(st, fly, Xp, labels, label_mask, widths)
        return ((new, out_fly) if overlap else new), metrics

    return step, ring


def make_overlap_primer(mesh, q_codec: WireCodec = FP32, *,
                        wire: Optional[PaddedWire] = None,
                        sentinel: bool = False, ring=None):
    """Start the FIRST iteration's forward q/u exchange for an
    ``overlap=True`` step: ``prime(q, u) -> (q_inflight, u_inflight)``, the
    in-flight half of the carry (``prime(q, u, widths)`` with a padded
    ``wire``). ``q_codec`` must be the step's q wire; u flies fp32."""
    if sentinel:
        raise _not_yet("the sentinel primer", FAULT_SLICE)
    ring = LocalRing(mesh) if ring is None else ring
    ex_q = NeighborExchange(ring, "model", q_codec, TAG_Q)
    ex_u = NeighborExchange(ring, "model", FP32, TAG_U)
    if wire is None:
        def prime(q, u):
            return (ex_q.start_shift_from_prev(q),
                    ex_u.start_shift_from_prev(u))
        return prime
    cex = ContainerExchange(ring, "model", wire, TAG_Q)
    stages = ring.axis_index("model")

    def prime_container(q, u, widths):
        return (cex.start_shift_from_prev(q, [widths[0][s] for s in stages]),
                ex_u.start_shift_from_prev(u))
    return prime_container


def shard_rows(V: int, dp_total: int) -> tuple:
    """Per-data-shard row counts of a length-V axis split `dp_total` ways,
    under JAX's ceil-partition of uneven axes (shard i holds rows
    [i*ceil(V/n), (i+1)*ceil(V/n)) clipped to V — trailing shards may be
    short or empty). Sums to V exactly for every (V, n)."""
    c = -(-V // dp_total)
    return tuple(max(0, min(V, (i + 1) * c) - i * c) for i in range(dp_total))


def _dp_total(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def wire_bytes_per_iteration(mesh, L: int, V: int, h: int,
                             p_codec: WireCodec, q_codec: WireCodec) -> dict:
    """Exact global bytes one distributed iteration puts on the stage ring:
    every stage sends its boundary slab [1, rows_i, h] per data shard — q
    and u forward, p backward — each charged at its own
    ``codec.payload_bytes`` (ragged V accounted per shard)."""
    n_stages = mesh.shape["model"]
    assert L % n_stages == 0, (L, n_stages)
    rows = shard_rows(V, _dp_total(mesh))

    def edge_bytes(codec):
        return n_stages * sum(codec.payload_bytes((1, r, h)) for r in rows)

    return {
        "q_fwd": edge_bytes(q_codec),
        "u_fwd": edge_bytes(FP32),
        "p_bwd": edge_bytes(p_codec),
        "elements_per_edge": n_stages * V * h,
        "shard_rows": rows,
        "links": n_stages * len(rows),
    }


def container_wire_bytes_per_iteration(mesh, L: int, V: int, h: int,
                                       wire: PaddedWire, q_bits, p_bits
                                       ) -> dict:
    """Exact global bytes one padded-container iteration puts on the stage
    ring: per stage, the q/p containers' active packed size (logical
    ``q_fwd`` / ``p_bwd``) and their fixed capacity (``container_bytes``,
    physical, per stage); u fp32. Ragged V accounted per data shard."""
    n_stages = mesh.shape["model"]
    assert len(q_bits) == len(p_bits) == n_stages
    rows = shard_rows(V, _dp_total(mesh))
    cap = sum(wire.capacity((1, r, h)) for r in rows)
    return {
        "q_fwd": [sum(wire.payload_bytes((1, r, h), b) for r in rows)
                  for b in q_bits],
        "p_bwd": [sum(wire.payload_bytes((1, r, h), b) for r in rows)
                  for b in p_bits],
        "u_fwd": n_stages * sum(FP32.payload_bytes((1, r, h)) for r in rows),
        "container_bytes": cap,
        "elements_per_edge": n_stages * V * h,
        "shard_rows": rows,
        "links": n_stages * len(rows),
    }


def _record_container_iteration(ledger, iteration: int, mesh, L, V, h,
                                wire: PaddedWire, q_bits, p_bits) -> None:
    """One padded-container iteration on the ledger: per stage, the q/p
    containers at their ACTIVE bit-width (logical payload) and fixed
    capacity (physical wire bytes); u as one fp32 record."""
    wb = container_wire_bytes_per_iteration(mesh, L, V, h, wire, q_bits,
                                            p_bits)
    n_el = V * h
    for i in range(mesh.shape["model"]):
        ledger.record(iteration, f"q_fwd/s{i}", "ppermute", n_el,
                      int(q_bits[i]), wb["q_fwd"][i],
                      wire_bytes=wb["container_bytes"])
        ledger.record(iteration, f"p_bwd/s{i}", "ppermute", n_el,
                      int(p_bits[i]), wb["p_bwd"][i],
                      wire_bytes=wb["container_bytes"])
    ledger.record(iteration, "u_fwd", "ppermute", wb["elements_per_edge"],
                  32, wb["u_fwd"])


def _record_container_qu_pair(ledger, iteration: int, mesh, L, V, h,
                              wire: PaddedWire, q_bits, suffix: str) -> None:
    """Charge one unconsumed q+u in-flight pair of the container path
    (``/inflight`` tail or ``/dropped`` on a q-schedule change)."""
    wb = container_wire_bytes_per_iteration(mesh, L, V, h, wire, q_bits,
                                            q_bits)
    ledger.record(iteration, "q_fwd/" + suffix, "ppermute",
                  wb["elements_per_edge"], int(max(q_bits)),
                  sum(wb["q_fwd"]),
                  wire_bytes=mesh.shape["model"] * wb["container_bytes"])
    ledger.record(iteration, "u_fwd/" + suffix, "ppermute",
                  wb["elements_per_edge"], 32, wb["u_fwd"])


def _record_ring_span(ledger, start: int, n: int, mesh, L, V, h,
                      p_codec: WireCodec, q_codec: WireCodec) -> None:
    """Record `n` iterations of ring traffic (q/u forward, p backward) in
    one shot — the chunked training loop's per-chunk rollup."""
    wb = wire_bytes_per_iteration(mesh, L, V, h, p_codec, q_codec)
    n_el = wb["elements_per_edge"]
    ledger.record_span(start, n, "q_fwd", "ppermute", n_el, q_codec.bits,
                       wb["q_fwd"])
    ledger.record_span(start, n, "u_fwd", "ppermute", n_el, 32, wb["u_fwd"])
    ledger.record_span(start, n, "p_bwd", "ppermute", n_el, p_codec.bits,
                       wb["p_bwd"])


def _record_qu_pair(ledger, iteration: int, mesh, L, V, h,
                    p_codec: WireCodec, q_codec: WireCodec,
                    suffix: str) -> None:
    """Charge one q+u forward slab pair that crossed the link outside the
    consumed per-iteration traffic: the in-flight tail a finished overlap
    run leaves in its carry (``/inflight``) or slabs superseded by a
    schedule change (``/dropped``). Bytes on the wire are bytes on the
    ledger, consumed or not."""
    wb = wire_bytes_per_iteration(mesh, L, V, h, p_codec, q_codec)
    n_el = wb["elements_per_edge"]
    ledger.record(iteration, "q_fwd/" + suffix, "ppermute", n_el,
                  q_codec.bits, wb["q_fwd"])
    ledger.record(iteration, "u_fwd/" + suffix, "ppermute", n_el, 32,
                  wb["u_fwd"])


def step_program_plan(*args, **kwargs):
    raise _not_yet("step_program_plan", ANALYSIS_SLICE)


def trace_step_dag(*args, **kwargs):
    raise _not_yet("trace_step_dag", ANALYSIS_SLICE)


def choose_overlap_for(*args, **kwargs):
    raise _not_yet("choose_overlap_for", ANALYSIS_SLICE)


def step_cost_model(*args, **kwargs):
    raise _not_yet("step_cost_model", ANALYSIS_SLICE)


def distributed_train(mesh, seed, Xp, labels, masks, L, n_classes,
                      config: ADMMConfig, epochs: int, *, ledger=None,
                      controller=None, grids_by_bits=None, overlap=False,
                      chunk: int = 32, mixed_width: bool = False,
                      faults=None, health: bool = False, ckpt=None,
                      ckpt_every: int = 0, resume: bool = False,
                      recovery=None, ring=None,
                      init: Optional[StackState] = None):
    """End-to-end stage-parallel training; returns ``(state, hist)`` with
    ``state`` the global stack (:func:`gather_stack`).

    ``Xp``, ``labels`` and ``masks`` are global tensors; the ring (default:
    a :class:`LocalRing` of ``mesh`` on Xp's device) takes its shards.
    ``init`` starts from a given global stack instead of
    ``init_stack(seed, ...)``.

    Without a controller the run rides ``pdadmm.run_chunked``: metrics stay
    on the device within a chunk (one host transfer per ``chunk``
    iterations). With ``overlap=True`` the in-flight q/u pair is part of
    the carry (primed once before the loop); results are bitwise those of
    ``overlap=False``.

    With a ``controller`` (+ ``grids_by_bits``) the p/q wire width is
    chosen each epoch from the global primal residual, one cached step per
    width in use, built lazily (``hist["n_compiled_steps"]``). A schedule
    change under overlap re-primes the carry.

    ``mixed_width=True`` (with a controller and ``grids_by_bits``) rides the
    padded-container wire: ONE step, and the controller gives each ring
    boundary its own width every iteration from the per-stage residuals
    (``n_stages`` managed edges, q and p shared, or ``2 * n_stages``: q
    edges then p edges). The ledger records each stage's container at its
    active width (logical) and at its capacity (physical).

    With a ``ledger`` every iteration's ring traffic is recorded edge by
    edge; under overlap every slab pair that crossed the link without being
    consumed is charged too (``*/inflight`` at the end, ``*/dropped`` on a
    schedule change).

    ``faults``, ``health``, ``ckpt``, ``ckpt_every``, ``resume``,
    ``recovery`` and ``overlap="replay"`` raise: they come with later
    slices of the port.
    """
    if overlap == "replay":
        raise _not_yet('overlap="replay"', ANALYSIS_SLICE)
    if (faults is not None or health or ckpt is not None or ckpt_every
            or resume or recovery is not None):
        raise _not_yet("faults=/health=/ckpt=/resume=/recovery=",
                       FAULT_SLICE)
    overlap = bool(overlap)
    V, h = Xp.shape
    ring = LocalRing(mesh, Xp.device) if ring is None else ring
    state = init_stack(seed, Xp, L, config) if init is None else init
    state = shard_stack(state, ring)
    data = (ring.to_local(Xp, "rows"), ring.to_local(labels, "rows"),
            ring.to_local(masks["train"], "rows"))
    hist = {"objective": [], "residual": [], "schedules": []}
    step_cache = {}

    def codecs_for(bits):
        if bits is None:
            return (codec_for_grid(config.grid if config.quantize_p
                                   else None),
                    codec_for_grid(config.grid if config.quantize_q
                                   else None))
        codec = codec_for_grid(grids_by_bits[bits])
        return codec, codec

    def step_for(bits):
        if bits not in step_cache:
            pc, qc = codecs_for(bits)
            step_cache[bits] = make_distributed_step(
                mesh, L, n_classes, config, overlap=overlap, p_codec=pc,
                q_codec=qc, ring=ring)[0]
        return step_cache[bits]

    def prime(bits, st):
        return make_overlap_primer(mesh, codecs_for(bits)[1],
                                   ring=ring)(st.q, st.u)

    def keep(m):
        hist["objective"].append(float(m["objective"]))
        hist["residual"].append(float(m["residual"]))

    if mixed_width:
        if controller is None or grids_by_bits is None:
            raise ValueError("mixed_width needs a controller and "
                             "grids_by_bits")
        wire = PaddedWire.from_grids(grids_by_bits)
        n_stages = mesh.shape["model"]
        n_edges = len(controller.edge_elements)
        if n_edges not in (n_stages, 2 * n_stages):
            raise ValueError(f"{n_edges} managed edges for {n_stages} "
                             "stages; expected one or two per stage")
        step_cache["container"] = make_distributed_step(
            mesh, L, n_classes, config, overlap=overlap, wire=wire,
            ring=ring)[0]
        step = step_cache["container"]
        primer = (make_overlap_primer(mesh, wire=wire, ring=ring)
                  if overlap else None)
        stage_res = [0.0] * n_stages
        inflight, prev_q_bits = None, None
        for e in range(epochs):
            sig = stage_res if n_edges == n_stages else stage_res + stage_res
            sched = controller.assign(sig, e)
            q_bits = sched[:n_stages]
            p_bits = sched[:n_stages] if n_edges == n_stages \
                else sched[n_stages:]
            hist["schedules"].append(sched)
            widths = [wire.sel_of_bits(q_bits), wire.sel_of_bits(p_bits)]
            if overlap:
                if inflight is None or q_bits != prev_q_bits:
                    if inflight is not None and ledger is not None:
                        # the superseded pair (old q widths) already
                        # crossed the link
                        _record_container_qu_pair(ledger, e, mesh, L, V, h,
                                                  wire, prev_q_bits,
                                                  "dropped")
                    inflight = primer(state.q, state.u, widths)
                    prev_q_bits = q_bits
                (state, inflight), m = step((state, inflight), *data,
                                            widths)
            else:
                state, m = step(state, *data, widths)
            stage_res = [float(v) for v in m["stage_residuals"]]
            keep(m)
            if ledger is not None:
                _record_container_iteration(ledger, e, mesh, L, V, h, wire,
                                            q_bits, p_bits)
        if overlap and ledger is not None and epochs > 0:
            _record_container_qu_pair(ledger, epochs, mesh, L, V, h, wire,
                                      prev_q_bits, "inflight")
    elif controller is None:
        p_codec, q_codec = codecs_for(None)
        step = step_for(None)
        carry = (state, prime(None, state)) if overlap else state
        carry, ms = run_chunked(step, carry, data, epochs, chunk=chunk)
        state = carry[0] if overlap else carry
        hist["objective"] = [float(x) for x in ms.get("objective", ())]
        hist["residual"] = [float(x) for x in ms.get("residual", ())]
        if ledger is not None and epochs > 0:
            _record_ring_span(ledger, 0, epochs, mesh, L, V, h, p_codec,
                              q_codec)
            if overlap:   # the tail pair still in flight in the carry
                _record_qu_pair(ledger, epochs, mesh, L, V, h, p_codec,
                                q_codec, "inflight")
    else:
        residual = 0.0
        inflight, cur_bits = None, None
        for e in range(epochs):
            (bits,) = controller.assign([residual], e)
            hist["schedules"].append(bits)
            step = step_for(bits)
            p_codec, q_codec = codecs_for(bits)
            if overlap:
                if inflight is None or bits != cur_bits:
                    if inflight is not None and ledger is not None:
                        _record_qu_pair(ledger, e, mesh, L, V, h,
                                        *codecs_for(cur_bits), "dropped")
                    inflight = prime(bits, state)
                    cur_bits = bits
                (state, inflight), m = step((state, inflight), *data)
            else:
                state, m = step(state, *data)
            residual = float(m["residual"])
            keep(m)
            if ledger is not None:
                _record_ring_span(ledger, e, 1, mesh, L, V, h, p_codec,
                                  q_codec)
        if overlap and ledger is not None and epochs > 0:
            _record_qu_pair(ledger, epochs, mesh, L, V, h,
                            *codecs_for(cur_bits), "inflight")
    hist["n_compiled_steps"] = len(step_cache)
    hist["overlap"] = overlap
    return gather_stack(state, ring), hist

