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

Fault tolerance (``health=`` / ``faults=`` / ``ckpt=``): the sentinel step
checks every boundary slab against its integrity header and substitutes the
last verified one on a failed verdict (``comm.faults``), and
``distributed_train`` rolls an unhealthy iteration back to its latest
checkpoint (``ckpt.manager``).

Replay cost model (``analysis.replay``): :func:`trace_step_dag` records
one step variant into the replay DAG, :func:`choose_overlap_for` and
``distributed_train(overlap="replay")`` pick the overlap knob by predicted
time, :func:`step_cost_model` prices bit-width schedules for the
controller's ``objective="walltime"``, and :func:`step_program_plan`
states the collectives and kernel launches a step commits to.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.comm import faults as FT
from repro_torch.comm.codecs import (FP32, AffineCodec, Fp32Codec,
                                     GridCodec, WireCodec, codec_for_grid)
from repro_torch.comm.transport import (ContainerExchange, NeighborExchange,
                                        PaddedWire, sel_table,
                                        stage_entries)
from repro_torch.core import subproblems as sp
from repro_torch.core.pdadmm import ADMMConfig, _generator, relu, run_chunked
from repro_torch import resolve_device
from repro_torch.parallel.ring import LocalRing

# ring-shift tags of the three boundary exchanges (told apart in flight)
TAG_Q, TAG_U, TAG_P = 0, 1, 2


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


def make_distributed_step(mesh, L: int, n_classes: int,
                          config: ADMMConfig, *, overlap: bool = False,
                          donate: bool = False,
                          p_codec: Optional[WireCodec] = None,
                          q_codec: Optional[WireCodec] = None,
                          wire: Optional[PaddedWire] = None,
                          health: bool = False,
                          faults: Optional[FT.FaultPlan] = None, ring=None):
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
    the p one), an int32 ``[2, n_stages]`` tensor on the ring's device
    (rows of host integers are moved there once a call;
    ``PaddedWire.widths_table`` builds one), and each stage's exchanges
    run at its own width. The kernels a step launches do not depend on
    the table (one predicated launch per width of the wire), so one
    captured graph replays every schedule. u always flies fp32.

    ``health=True`` (or any ``faults=`` plan) builds the SENTINEL step:
    every boundary slab flies with its int32[2] checksum/seqno header
    (:mod:`repro_torch.comm.faults`), the carry's state becomes
    ``(StackState, GoodSlabs)`` with the last verified boundaries, the step
    takes a trailing :class:`~repro_torch.comm.faults.FaultControls` (after
    ``widths``), and ``metrics["health"]`` holds ``wire_bad`` (int32 [3],
    failed verdicts per edge summed over stages and data shards),
    ``p_finite`` / ``W_finite`` / ``b_finite`` / ``z_finite``,
    ``residual_finite`` and ``objective_spike``. A failed verdict
    substitutes the last good slab. ``faults=`` also runs the injector
    around each exchange. Prime the good slabs with
    :func:`make_sentinel_primer` and, under overlap, the carry with
    ``make_overlap_primer(..., sentinel=True)``. With ``health=False,
    faults=None`` the step, its carry and its metrics are the plain ones.

    ``donate=True`` writes the new state into the storage of the state
    passed in (and returns those tensors): each field is copied into its old
    storage as soon as the step has read the old value for the last time
    (z at the end, after the metrics), and its temporary is released, so the
    step holds one state plus the fields still in flight instead of two
    whole states. It costs one device copy per field.
    """
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
    sentinel = bool(health) or faults is not None
    if sentinel:
        sx_q, sx_u, sx_p = _sentinel_exchanges(ring, p_codec, q_codec, wire,
                                               faults)
    n_stages = mesh.shape["model"]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split over {n_stages} stages")
    m = L // n_stages
    stages = ring.axis_index("model")
    # local stage slots holding global layer 0 (local layer 0) and layer
    # L-1 (local layer m-1), if this process holds them
    first = stages.index(0) if 0 in stages else None
    last = stages.index(n_stages - 1) if n_stages - 1 in stages else None

    def body(st, fly, Xp, labels, label_mask, widths, ctl, good):
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

        sel_q = sel_p = sel_q_prev = sel_p_next = None
        if wire is not None:
            sel_q, sel_p, sel_q_prev, sel_p_next = _stage_widths(
                widths, stages, n_stages, ring.device)

        # ---- neighbour exchange (previous iteration's values) -------------
        if sentinel:
            # a carried slab was stamped with the previous tick
            exp_qu = ctl.seqno - 1 if overlap else ctl.seqno
            if overlap:
                q_fly, u_fly = fly
            else:
                q_fly = sx_q.start(st.q[:, :, -1:], ctl, +1, sel=sel_q)
                u_fly = sx_u.start(st.u[:, :, -1:], ctl, +1)
            slab = st.q[:, :, -1:].shape
            qb, ok_q, raw_q = sx_q.finish(q_fly, ctl, exp_qu, slab,
                                          st.q.dtype, good.q, +1,
                                          sel_src=sel_q_prev)
            ub, ok_u, raw_u = sx_u.finish(u_fly, ctl, exp_qu, slab,
                                          st.u.dtype, good.u, +1)
            q_prev = torch.cat([qb, st.q[:, :, :-1]], dim=2)
            u_prev = torch.cat([ub, st.u[:, :, :-1]], dim=2)
        elif overlap:
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
            if sentinel:
                p_fly = sx_p.start(p[:, :, :1], ctl, -1, sel=sel_p)
            else:
                p_fly = (cex_p.start_shift_from_next(p, sel_p)
                         if wire is not None
                         else ex_p.start_shift_from_next(p))

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
        if sentinel:
            # the backward p slab always flies within its own tick
            if not overlap:
                p_fly = sx_p.start(p[:, :, :1], ctl, -1, sel=sel_p)
            pb, ok_p, _ = sx_p.finish(p_fly, ctl, ctl.seqno,
                                      p[:, :, :1].shape, p.dtype, good.p, -1,
                                      sel_src=sel_p_next)
            p_next = torch.cat([p[:, :, 1:], pb], dim=2)
        elif wire is not None:
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
        if overlap and sentinel:
            out_fly = (sx_q.start(q[:, :, -1:], ctl, +1, sel=sel_q),
                       sx_u.start(u[:, :, -1:], ctl, +1))
            if faults is not None:
                # a late send from my source: my carry keeps the stale pair
                # (caught next tick by its seqno)
                late = sx_q.pick(ctl.delay, +1)
                out_fly = (out_fly[0]._replace(held=(late, raw_q)),
                           out_fly[1]._replace(held=(late, raw_u)))
        elif overlap:
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
        new_good = None
        if sentinel:
            metrics["health"] = _health(ring, (ok_q, ok_u, ok_p),
                                        (p, W, b, z), res_sq, lag, ctl)
            new_good = FT.GoodSlabs(q=qb, u=ub, p=pb)
        new = StackState(p, W, b, settle(st.z, z), q, u)
        return new, out_fly, metrics, new_good

    n_extra = (wire is not None) + sentinel

    def step(carry, Xp, labels, label_mask, *extra):
        if len(extra) != n_extra:
            raise ValueError(f"this step takes {n_extra} trailing argument(s)"
                             " (the widths table of a padded wire, then the "
                             "FaultControls of a sentinel step)")
        widths = extra[0] if wire is not None else None
        ctl = extra[-1] if sentinel else None
        st_c, fly = carry if overlap else (carry, None)
        st, good = st_c if sentinel else (st_c, None)
        new, out_fly, metrics, new_good = body(st, fly, Xp, labels,
                                               label_mask, widths, ctl, good)
        out = (new, new_good) if sentinel else new
        return ((out, out_fly) if overlap else out), metrics

    return step, ring


def _stage_widths(widths, stages, n_stages: int, device) -> tuple:
    """(sel_q, sel_p, sel_q_prev, sel_p_next) of the local stages, on the
    device: each stage's q and p width indices, and those of the stage its
    q comes from and of the stage its p comes from (a decode reads the
    ORIGINATING stage's width)."""
    t = sel_table(widths, device)
    return (stage_entries(t[0], stages, n_stages),
            stage_entries(t[1], stages, n_stages),
            stage_entries(t[0], stages, n_stages, +1),
            stage_entries(t[1], stages, n_stages, -1))


def _sentinel_exchanges(ring, p_codec, q_codec, wire, plan):
    """The q, u and p sentinel exchanges of a step (or a primer: plan
    None)."""
    return (FT.SentinelExchange(ring, "model", 0, codec=q_codec, wire=wire,
                                plan=plan, tag=TAG_Q),
            FT.SentinelExchange(ring, "model", 1, codec=FP32, plan=plan,
                                tag=TAG_U),
            FT.SentinelExchange(ring, "model", 2, codec=p_codec, wire=wire,
                                plan=plan, tag=TAG_P))


HEALTH_FLAGS = ("p_finite", "W_finite", "b_finite", "z_finite",
                "residual_finite", "objective_spike")


def _health(ring, oks, new_leaves, res_sq, lag, ctl) -> dict:
    """The ``metrics["health"]`` block, replicated like the other metrics:
    failed verdicts per edge and the finite / spike sentinels."""
    axes = ("model", "data")

    def all_finite(t):
        # min and max propagate NaN, and an infinity is one of them: both
        # finite iff every element is (one read of t, no temporaries)
        lo, hi = torch.aminmax(t.reshape(*t.shape[:2], -1), dim=-1)
        bad = (~(torch.isfinite(lo) & torch.isfinite(hi))).to(torch.int32)
        return ring.psum(bad, axes).reshape(()) == 0

    health = {"wire_bad": torch.stack([
        ring.psum((~ok).to(torch.int32), axes).reshape(()) for ok in oks])}
    for name, t in zip(HEALTH_FLAGS[:4], new_leaves):
        health[name] = all_finite(t)
    prev = ctl.prev_obj
    health["residual_finite"] = torch.isfinite(res_sq) & torch.isfinite(lag)
    health["objective_spike"] = torch.isfinite(prev) & (
        lag > prev + FT.SPIKE_TOL * (1.0 + prev.abs()))
    return health


def _health_row(metrics) -> np.ndarray:
    """One host read of a sentinel step's verdict: ``wire_bad`` (3), the
    six HEALTH_FLAGS, the objective and the residual, as float64 (from
    device tensors, or from the numpy metrics a replay read)."""
    h = metrics["health"]
    if isinstance(h["wire_bad"], np.ndarray):
        return np.concatenate([
            np.asarray(x, np.float64).reshape(-1)
            for x in (h["wire_bad"], *(h[k] for k in HEALTH_FLAGS),
                      metrics["objective"], metrics["residual"])])
    row = torch.cat([h["wire_bad"].to(torch.float64),
                     torch.stack([h[k] for k in HEALTH_FLAGS]).to(
                         torch.float64),
                     torch.stack([metrics["objective"],
                                  metrics["residual"]]).to(torch.float64)])
    return row.cpu().numpy()


def make_overlap_primer(mesh, q_codec: WireCodec = FP32, *,
                        wire: Optional[PaddedWire] = None,
                        sentinel: bool = False, ring=None):
    """Start the FIRST iteration's forward q/u exchange for an
    ``overlap=True`` step: ``prime(q, u) -> (q_inflight, u_inflight)``, the
    in-flight half of the carry (``prime(q, u, widths)`` with a padded
    ``wire``). ``q_codec`` must be the step's q wire; u flies fp32.

    ``sentinel=True`` primes the carry of a ``health=`` / ``faults=`` step:
    the primer takes a trailing ``seqno`` (stamp it with ``tick - 1``, the
    tick whose tail would have started this exchange) and each half is a
    sentinel slab with its header. Priming is always clean: no injection,
    a fresh checksum."""
    ring = LocalRing(mesh) if ring is None else ring
    stages = ring.axis_index("model")
    if sentinel:
        sx_q, sx_u, _ = _sentinel_exchanges(ring, FP32, q_codec, wire, None)
        n_stages = mesh.shape["model"]

        def start(q, u, sel_q, seqno):
            ctl = FT.null_controls(n_stages, seqno=seqno, device=q.device)
            return (sx_q.start(q[:, :, -1:], ctl, +1, sel=sel_q),
                    sx_u.start(u[:, :, -1:], ctl, +1))
        if wire is None:
            return lambda q, u, seqno: start(q, u, None, seqno)
        return lambda q, u, widths, seqno: start(
            q, u, _stage_widths(widths, stages, n_stages, ring.device)[0],
            seqno)
    ex_q = NeighborExchange(ring, "model", q_codec, TAG_Q)
    ex_u = NeighborExchange(ring, "model", FP32, TAG_U)
    if wire is None:
        def prime(q, u):
            return (ex_q.start_shift_from_prev(q),
                    ex_u.start_shift_from_prev(u))
        return prime
    cex = ContainerExchange(ring, "model", wire, TAG_Q)
    n_stages = mesh.shape["model"]

    def prime_container(q, u, widths):
        sel_q = _stage_widths(widths, stages, n_stages, ring.device)[0]
        return (cex.start_shift_from_prev(q, sel_q),
                ex_u.start_shift_from_prev(u))
    return prime_container


def make_sentinel_primer(mesh, p_codec: WireCodec = FP32,
                         q_codec: WireCodec = FP32, *,
                         wire: Optional[PaddedWire] = None, ring=None):
    """The initial :class:`~repro_torch.comm.faults.GoodSlabs` of a
    sentinel step: ``prime(q, u, p) -> GoodSlabs`` (``prime(q, u, p,
    widths)`` with a padded ``wire``). Each slab comes from a CLEAN ring
    shift in the step's wire format, the boundary a fault-free tick would
    decode, so a fault on the very first tick already substitutes the
    right value."""
    ring = LocalRing(mesh) if ring is None else ring
    stages = ring.axis_index("model")
    n_stages = mesh.shape["model"]
    ex_u = NeighborExchange(ring, "model", FP32, TAG_U)
    if wire is None:
        ex_q = NeighborExchange(ring, "model", q_codec, TAG_Q)
        ex_p = NeighborExchange(ring, "model", p_codec, TAG_P)

        def prime(q, u, p):
            return FT.GoodSlabs(q=ex_q.shift_from_prev(q)[:, :, :1],
                                u=ex_u.shift_from_prev(u)[:, :, :1],
                                p=ex_p.shift_from_next(p)[:, :, -1:])
        return prime
    cex_q = ContainerExchange(ring, "model", wire, TAG_Q)
    cex_p = ContainerExchange(ring, "model", wire, TAG_P)

    def prime_container(q, u, p, widths):
        sel_q, sel_p, sel_q_prev, sel_p_next = _stage_widths(
            widths, stages, n_stages, ring.device)
        return FT.GoodSlabs(
            q=cex_q.shift_from_prev(q, sel_q, sel_q_prev)[:, :, :1],
            u=ex_u.shift_from_prev(u)[:, :, :1],
            p=cex_p.shift_from_next(p, sel_p, sel_p_next)[:, :, -1:])
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


def _sentinel_links(mesh) -> int:
    """Sentinel-checked links per edge per iteration: one slab per stage
    per data shard."""
    return mesh.shape["model"] * _dp_total(mesh)


def _record_sentinel_headers(ledger, start: int, n: int, mesh,
                             edges=FT.EDGES) -> None:
    """Charge the integrity headers a sentinel step flies: int32[2] per
    slab per link per edge, physical ``wire_bytes`` only (kind
    ``"header"``, no logical payload: integrity is not part of the
    compression story)."""
    links = _sentinel_links(mesh)
    for edge in edges:
        ledger.record_span(start, n, edge, "header", 2 * links, 32,
                           payload_bytes=0,
                           wire_bytes=FT.SENTINEL_HEADER_BYTES * links)


# ---------------------------------------------------------------------------
# Replay cost-model hooks: record a step variant into the replay DAG and
# price schedules and the overlap knob against predicted wall time. They
# live here because they know how the steps are built.
# ---------------------------------------------------------------------------

class StepProgramPlan(NamedTuple):
    """The program one ``make_distributed_step`` configuration commits to,
    computed next to the step builder that owns it.

      * ``edge_events`` — every ring shift in ISSUE ORDER, as ``(edge,
        wire_dtype, bytes_per_link)`` (the reference's exactly). Sentinel
        steps add an ``<edge>.header`` event (int32[2], 8 B) after each
        payload; payload bytes are ``codec.payload_bytes`` /
        ``PaddedWire.capacity`` of the boundary slab.
      * ``n_carried`` — slabs leaving through the carry (2 under overlap:
        the q/u forward exchange; else 0).
      * ``min_work_to_consumer`` — matmuls or kernels required between a
        consumed shift and its first reader (overlap puts the W/b/z solves
        behind the p shift; 0 is the fused ordering).
      * ``pallas_calls`` — the reference's name for the per-kernel launch
        counts of one step, here in ``kernels.ops`` names: what the card
        launches (``fista_zlast`` once; both routes of a matmul kernel
        count as that kernel; no launch for 8-bit codes, their own
        container). Empty with ``use_kernels=False`` or on the CPU, where
        the plain versions compute.
      * ``expects_xor`` / ``donate`` / ``takes_widths`` / ``sentinel`` /
        ``overlap`` — flags for the fault injector, donation, the trailing
        widths table, headers and the carried exchange.
    """
    edge_events: tuple
    n_carried: int
    min_work_to_consumer: int
    pallas_calls: dict
    expects_xor: bool
    donate: bool
    takes_widths: bool
    sentinel: bool
    overlap: bool


def _codec_wire_format(codec, slab):
    """(wire dtype, per-link bytes) of one boundary slab under ``codec``."""
    if codec.bits >= 32:
        return "float32", codec.payload_bytes(slab)
    dtype = "uint8" if codec.bits <= 8 else "uint16"
    return dtype, codec.payload_bytes(slab)


def _widest_widths(wire: PaddedWire, n_stages: int) -> list:
    """A widths table with every stage at the wire's widest width."""
    k = len(wire.widths) - 1
    return [[k] * n_stages, [k] * n_stages]


def _kernel_launches(config: ADMMConfig, p_codec, q_codec, wire) -> dict:
    """Launches of one ring step on the card."""
    from repro_torch.kernels.ops import _packs
    out = {"fused_linear": 3,            # entry residual, gW, pg
           "admm_pgrad": 1, "relu_zupdate": 1, "fista_zlast": 1}

    def add(name, n=1):
        out[name] = out.get(name, 0) + n

    if config.quantize_p and config.grid is not None:
        # one resnorm and one projection per trial, the accepted step's
        # projection
        add("backtrack_resnorm", sp.MAX_DOUBLINGS)
        add("grid_project", sp.MAX_DOUBLINGS + 1)
    if config.quantize_q and config.grid is not None:
        add("grid_project")
    if wire is not None:
        # q and p: one predicated encode and decode per width of the wire
        # (and a pack and unpack per packed width), whatever the table
        for bits in wire.widths:
            add("grid_encode", 2)
            add("grid_decode", 2)
            if _packs(bits):
                add("pack_codes", 2)
                add("unpack_codes", 2)
        return out
    for codec in (q_codec, p_codec):     # u flies fp32
        if isinstance(codec, Fp32Codec):
            continue
        if isinstance(codec, GridCodec):
            add("grid_encode")
            add("grid_decode")
        if isinstance(codec, (GridCodec, AffineCodec)) and codec.bits <= 4:
            add("pack_codes")
            add("unpack_codes")
    return out


def step_program_plan(mesh, L: int, n_classes: int, config: ADMMConfig, *,
                      V: int, h: int, overlap: bool = False,
                      donate: bool = False,
                      p_codec: Optional[WireCodec] = None,
                      q_codec: Optional[WireCodec] = None,
                      wire: Optional[PaddedWire] = None,
                      health: bool = False,
                      faults: Optional[FT.FaultPlan] = None,
                      ring=None, device=None) -> StepProgramPlan:
    """Expected program of this ``make_distributed_step`` kwarg point (its
    signature plus the ``V``/``h`` problem size, and the ``ring`` or
    ``device`` that sets the kernel policy). Pure bookkeeping: nothing is
    traced. A sentinel step launches the kernels of the plain one (its
    checksums, verdicts and flips are PyTorch); a padded wire's step
    launches the same kernels whatever its widths table."""
    n_rows = _dp_total(mesh)
    r0 = shard_rows(V, n_rows)[0]
    slab = (1, r0, h)
    if p_codec is None:
        p_codec = codec_for_grid(config.grid if config.quantize_p else None)
    if q_codec is None:
        q_codec = codec_for_grid(config.grid if config.quantize_q else None)
    sentinel = bool(health) or faults is not None

    if wire is not None:
        q_fmt = p_fmt = ("uint8", wire.capacity(slab))
    else:
        q_fmt = _codec_wire_format(q_codec, slab)
        p_fmt = _codec_wire_format(p_codec, slab)
    u_fmt = ("float32", FP32.payload_bytes(slab))
    fmt = {"q_fwd": q_fmt, "u_fwd": u_fmt, "p_bwd": p_fmt}
    # issue order: the overlap step STARTS p mid-step and q/u at the tail
    # (the entry exchange finishes the carry, it issues nothing)
    order = ("p_bwd", "q_fwd", "u_fwd") if overlap \
        else ("q_fwd", "u_fwd", "p_bwd")
    events = []
    for edge in order:
        dtype, nbytes = fmt[edge]
        events.append((edge, dtype, nbytes))
        if sentinel:
            events.append((edge + ".header", "int32",
                           FT.SENTINEL_HEADER_BYTES))

    dev = ring.device if ring is not None else resolve_device(device)
    pallas = {}
    if config.use_kernels and dev.type != "cpu":
        pallas = _kernel_launches(config, p_codec, q_codec, wire)

    return StepProgramPlan(
        edge_events=tuple(events),
        n_carried=2 if overlap else 0,
        min_work_to_consumer=2 if overlap else 0,
        pallas_calls=pallas,
        expects_xor=faults is not None,
        donate=donate,
        takes_widths=wire is not None,
        sentinel=sentinel,
        overlap=overlap)


class RecordedStep(NamedTuple):
    """One recorded call of a step (:func:`record_step`): its program, the
    carry and arguments it was given, what it returned, and on the card the
    launches the kernel wrappers counted during the call (``{}`` on the
    CPU, where the plain versions compute)."""
    program: object
    carry: object
    args: tuple
    out: object
    launches: dict


def _step_inputs(L: int, V: int, h: int, n_classes: int, ring,
                 shapes_only: bool, config: ADMMConfig, inputs=None):
    """A stack state and (Xp, labels, label_mask) in the ring's shard
    layout: empty tensors for a shape-only trace; with ``inputs`` (global
    Xp, labels, label_mask) those and the forward-consistent
    ``init_stack`` (seed 0); else random values from seed 0 on the ring's
    device (labels below ``n_classes``)."""
    f32, dev = torch.float32, ring.device
    shapes = StackState(p=(L, V, h), W=(L, h, h), b=(L, h), z=(L, V, h),
                        q=(L, V, h), u=(L, V, h))
    if inputs is not None:
        data = tuple(x.to(dev) for x in inputs)
        st = init_stack(0, data[0], L, config)
    elif shapes_only:
        st = StackState(*(torch.empty(s, dtype=f32) for s in shapes))
        data = (torch.empty((V, h), dtype=f32),
                torch.empty((V,), dtype=torch.int32),
                torch.empty((V,), dtype=f32))
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        st = StackState(*(torch.randn(s, generator=g, device=dev)
                          for s in shapes))
        data = (torch.randn((V, h), generator=g, device=dev),
                torch.randint(0, n_classes, (V,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.ones((V,), dtype=f32, device=dev))
    return (shard_stack(st, ring),
            [ring.to_local(x, "rows") for x in data])


def record_step(mesh, L: int, n_classes: int, config: ADMMConfig, *,
                V: int, h: int, overlap: bool = False, donate: bool = False,
                p_codec: Optional[WireCodec] = None,
                q_codec: Optional[WireCodec] = None,
                wire: Optional[PaddedWire] = None, health: bool = False,
                faults: Optional[FT.FaultPlan] = None, widths=None,
                device=None, wrap=None, inputs=None,
                memory: bool = False) -> RecordedStep:
    """Record one call of the ``make_distributed_step`` step of this kwarg
    point (``analysis.torch_trace``) on a ``LocalRing`` of ``mesh``.

    ``device=None`` and no fault plan: shape-only tensors on the CPU
    (``FakeTensorMode``); nothing computes and nothing is allocated, at any
    size. The kernels take their plain versions and count the launches the
    card would make.

    Otherwise random state and data from seed 0 on ``device`` (default the
    card, raising without one: a fault plan's controls are data, so a
    ``faults=`` step always records real tensors), and the step really
    runs: on the card through the kernels, whose wrappers' counters are
    read around the call (``RecordedStep.launches``).
    ``inputs`` (global ``(Xp, labels, label_mask)``) replaces the random
    data, and the state is ``init_stack(0, Xp, L, config)``.

    Everything the step takes is built as its caller builds it: the
    padded wire's ``widths`` table (default every stage at the widest),
    the sentinel step's primed good slabs and its tick-0 controls (the
    plan's, else the all-clear ones), the overlap step's primed carry.
    ``wrap`` post-composes onto the step (``wrap(step)`` is recorded).
    ``memory`` tracks live bytes over the call, the carry and arguments
    held from the start (``StepProgram.memory``, over every shard the
    ring holds)."""
    from repro_torch.analysis import torch_trace as tt
    from repro_torch.kernels import ops
    shapes_only = device is None and faults is None
    dev = torch.device("cpu") if shapes_only else resolve_device(device)
    n_stages = mesh.shape["model"]
    sentinel = bool(health) or faults is not None
    if p_codec is None:
        p_codec = codec_for_grid(config.grid if config.quantize_p else None)
    if q_codec is None:
        q_codec = codec_for_grid(config.grid if config.quantize_q else None)
    with (tt.fake_mode() if shapes_only else contextlib.nullcontext()):
        inner = LocalRing(mesh, dev)
        rec = tt.StepRecorder(mesh.size, memory=memory)
        codecs = {} if wire is not None else dict(p_codec=p_codec,
                                                  q_codec=q_codec)
        step, _ = make_distributed_step(
            mesh, L, n_classes, config, overlap=overlap, donate=donate,
            wire=wire, health=health, faults=faults,
            ring=tt.RecordingRing(inner, rec), **codecs)
        st, args = _step_inputs(L, V, h, n_classes, inner, shapes_only,
                                config, inputs)
        tail = []
        if wire is not None:
            tail.append(widths if widths is not None
                        else _widest_widths(wire, n_stages))
        carry = st
        if sentinel:
            good = make_sentinel_primer(mesh, p_codec, q_codec, wire=wire,
                                        ring=inner)(st.q, st.u, st.p, *tail)
            carry = (st, good)
        if overlap:
            primer = make_overlap_primer(mesh, q_codec, wire=wire,
                                         sentinel=sentinel, ring=inner)
            fly = primer(st.q, st.u, *tail, *((-1,) if sentinel else ()))
            carry = (carry, fly)
        if sentinel:
            tail.append(faults.controls(0, n_stages, device=dev)
                        if faults is not None
                        else FT.null_controls(n_stages, device=dev))
        args = tuple(args) + tuple(tail)
        fn = step if wrap is None else wrap(step)
        if memory:
            rec.hold((carry, args))
        before = ops.launch_counts()
        with rec:
            out = fn(carry, *args)
        after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return RecordedStep(rec.program, carry, args, out, launches)


def trace_step_program(*args, **kwargs):
    """The ``StepProgram`` of one step: ``record_step(...).program``."""
    return record_step(*args, **kwargs).program


def trace_step_dag(mesh, L: int, n_classes: int, config: ADMMConfig, *,
                   V: int, h: int, overlap: bool = False,
                   p_codec: Optional[WireCodec] = None,
                   q_codec: Optional[WireCodec] = None,
                   wire: Optional[PaddedWire] = None, widths=None):
    """Record one step variant (:func:`trace_step_program`) into the replay
    task DAG (``analysis.replay.extract_step_dag``). The shift events
    carry their CommLedger edge names in the order each variant issues
    them: the baseline step q/u at entry and p mid-step, the overlap step p
    mid-step and q/u at the tail (its entry finishes the carry)."""
    from repro_torch.analysis import replay as rp
    program = trace_step_program(mesh, L, n_classes, config, V=V, h=h,
                                 overlap=overlap, p_codec=p_codec,
                                 q_codec=q_codec, wire=wire, widths=widths)
    return rp.extract_step_dag(program, n_stages=mesh.shape["model"],
                               n_rows=_dp_total(mesh))


def _replay_workers(ring, n_workers):
    """Executor slots of the replay: one for a ``LocalRing`` (one process
    drives every shard on one stream), else one per device."""
    if n_workers is not None:
        return n_workers
    return 1 if ring is None or isinstance(ring, LocalRing) else None


def choose_overlap_for(mesh, L: int, n_classes: int, config: ADMMConfig, *,
                       V: int, h: int, costs=None, n_workers=None,
                       ring=None) -> bool:
    """Replay-search the ``overlap`` knob for this training setup: trace
    both step variants and keep the predicted-faster one
    (``analysis.replay.choose_overlap``). With no cost table the hand
    default (overlap on) comes back without tracing anything."""
    from repro_torch.analysis import replay as rp
    if costs is None:
        return rp.choose_overlap(None, None, None)
    kw = dict(V=V, h=h)
    return rp.choose_overlap(
        trace_step_dag(mesh, L, n_classes, config, overlap=False, **kw),
        trace_step_dag(mesh, L, n_classes, config, overlap=True, **kw),
        costs, n_workers=_replay_workers(ring, n_workers))


def step_cost_model(mesh, L: int, n_classes: int, config: ADMMConfig,
                    costs, *, V: int, h: int, grids_by_bits,
                    mixed_width: bool = True, overlap: bool = False,
                    n_workers=None, ring=None):
    """The ``analysis.replay.ScheduleCostModel`` pricing THIS training
    setup's step: the ``cost_model`` a
    ``BitWidthController(objective="walltime")`` takes.

    ``mixed_width=True`` prices the padded-container step
    (``distributed_train(mixed_width=True)``): the shifted payload is the
    container's fixed capacity whatever the schedule says, so promoting an
    edge's precision is free in predicted time and the walltime objective
    spends the whole container. ``mixed_width=False`` prices the
    uniform-codec path (one managed edge, ``schedule == (bits,)``): the
    packed payload grows with the width, so a promotion is accepted only
    when the replay predicts the extra transfer stays hidden."""
    from repro_torch.analysis import replay as rp
    r0 = shard_rows(V, _dp_total(mesh))[0]
    slab = (1, r0, h)
    u_bytes = FP32.payload_bytes(slab)
    if mixed_width:
        wire = PaddedWire.from_grids(grids_by_bits)
        dag = trace_step_dag(mesh, L, n_classes, config, V=V, h=h,
                             overlap=overlap, wire=wire)
        cap = wire.capacity(slab)
        fixed = {"q_fwd": cap, "p_bwd": cap, "u_fwd": u_bytes}
        edge_bytes = lambda schedule: fixed             # noqa: E731
    else:
        # the DAG's structure does not depend on the width on the codec
        # path (only the packed payload does): trace once, reprice
        dag = trace_step_dag(mesh, L, n_classes, config, V=V, h=h,
                             overlap=overlap)

        def edge_bytes(schedule):
            b = codec_for_grid(grids_by_bits[schedule[0]]).payload_bytes(slab)
            return {"q_fwd": b, "p_bwd": b, "u_fwd": u_bytes}
    return rp.ScheduleCostModel(dag, costs, edge_bytes,
                                n_workers=_replay_workers(ring, n_workers))


_UNSET = object()


class _Calls:
    """How ``distributed_train``'s per-iteration loops (mixed-width,
    per-epoch controller, sentinel) call a step: ``calls(step, carry,
    args) -> (carry, metrics)``.

    Eager (``replay=False``): the step itself; metrics are device
    tensors. Replayed: one CUDA graph replay per call (``core.graphs``),
    the reference's jitted step. The first call of a step captures its
    program; the program is kept, so a re-primed carry, a rollback or a
    resume only loads the program's buffers and never captures again.
    ``args`` must be the tensors of the first call (the graph reads their
    addresses): the caller rewrites a widths table or fault controls in
    place. The carry comes back over the buffers; the metrics come back
    on the host in one copy (numpy)."""

    def __init__(self, replay: bool):
        self.replay = replay
        self.programs = {}

    def __call__(self, step, carry, args):
        if not self.replay:
            return step(carry, *args)
        from repro_torch.core import graphs
        prog = self.programs.get(step)
        if prog is None:
            prog = self.programs[step] = graphs.program_for(step, carry,
                                                            args, 1)
        elif any(a is not b for a, b in zip(tree_leaves(args),
                                            tree_leaves(prog.args))):
            raise ValueError("a replayed step's arguments must be the "
                             "tensors it was captured with (rewrite them "
                             "in place)")
        prog.buffers.load(carry)
        m = prog.iterate(step)
        return prog.buffers.state(), m


def _held_carry(fly, ring):
    """A primed in-flight sentinel slab in the form a faulted overlap
    step's carry takes (``held`` set, ``late`` all false, which keeps the
    arrival as it is), so a replayed step's carry keeps one structure."""
    late = torch.zeros(len(ring.axis_index("model")), dtype=torch.bool,
                       device=ring.device)
    return fly._replace(held=(late, [t.clone() for t in fly.handle]))


def _ft_train_loop(*, mesh, ring, state, data, L, V, h, n_classes, config,
                   epochs, hist, ledger, controller, codecs_for, step_cache,
                   overlap, faults, ckpt, ckpt_every, resume, recovery,
                   calls):
    """The sentinel training loop behind ``distributed_train(faults= /
    health= / ckpt=)``: one sentinel step per iteration (last-good
    substitution inside the step), one host read of its verdict, the fault
    accounting, checkpoints, and rollback. ``state`` is in the ring's shard
    layout; ``calls`` (:class:`_Calls`) runs each step, replayed or
    eagerly. Returns ``(state, hist)``; the policy is in the
    ``distributed_train`` docstring."""
    from repro_torch.ckpt.manager import CheckpointManager
    mgr = None
    if ckpt is not None:
        if not isinstance(ring, LocalRing):
            raise NotImplementedError(
                "ckpt= on a ProcessGroupRing (one process per shard) waits "
                "for the multi-card work (ROADMAP.md, Queue 1, \"NCCL "
                "across several cards\"): a checkpoint is written by one "
                "process that holds every shard")
        mgr = ckpt if hasattr(ckpt, "save") else CheckpointManager(str(ckpt))
    rec = recovery if recovery is not None else FT.RecoveryConfig()
    n_stages = mesh.shape["model"]
    links = _sentinel_links(mesh)
    dp_total = links // n_stages
    dev = ring.device

    def ft_step(bits):
        k = ("sentinel", bits)
        if k not in step_cache:
            pc, qc = codecs_for(bits)
            step_cache[k] = make_distributed_step(
                mesh, L, n_classes, config, overlap=overlap, p_codec=pc,
                q_codec=qc, health=True, faults=faults, ring=ring)[0]
        return step_cache[k]

    def prime_good(bits, st):
        pc, qc = codecs_for(bits)
        return make_sentinel_primer(mesh, pc, qc, ring=ring)(st.q, st.u,
                                                             st.p)

    def prime_fly(bits, st, seqno):
        fly = make_overlap_primer(mesh, codecs_for(bits)[1], sentinel=True,
                                  ring=ring)(st.q, st.u, seqno)
        if calls.replay and faults is not None:
            fly = tuple(_held_carry(f, ring) for f in fly)
        return fly

    ctl = None      # replayed: the tick's controls, rewritten in place

    def controls(tick, prev_obj):
        into = ctl if calls.replay else None
        if faults is not None:
            return faults.controls(tick, n_stages, prev_obj=prev_obj,
                                   device=dev, into=into)
        return FT.null_controls(n_stages, seqno=tick, prev_obj=prev_obj,
                                device=dev, into=into)

    def charge_pair(it, old_bits, suffix):
        # a q/u pair (and its headers) that crossed the link unconsumed
        _record_qu_pair(ledger, it, mesh, L, V, h, *codecs_for(old_bits),
                        suffix)
        for en in ("q_fwd/", "u_fwd/"):
            ledger.record(it, en + suffix, "header", 2 * links, 32,
                          payload_bytes=0,
                          wire_bytes=FT.SENTINEL_HEADER_BYTES * links)

    state0 = state
    ctl_state0 = controller.state_dict() if controller is not None else None
    fault_counts = {en: {"injected": 0, "detected": 0, "recovered": 0}
                    for en in FT.EDGES}
    ft_trace = []
    n_rb = 0
    e, tick = 0, 0
    prev_obj = float("inf")
    stage_res = 0.0
    good, inflight, cur_bits = None, None, _UNSET

    def _restore_latest(with_tick: bool):
        nonlocal state, e, tick, prev_obj, stage_res
        restored, manifest = mgr.restore(like=state)
        state = shard_stack(StackState(*restored), ring)
        ex = manifest.get("extra") or {}
        e = int(ex.get("iteration", 0))
        prev_obj = float(ex.get("prev_obj", float("inf")))
        stage_res = float(ex.get("residual", 0.0))
        if with_tick:
            # a resume continues the plan clock; an in-run rollback NEVER
            # rewinds it (faults are transient wire events)
            tick = int(ex.get("tick", tick))
        if controller is not None and ex.get("controller"):
            controller.load_state_dict(ex["controller"])
        del hist["objective"][e:]
        del hist["residual"][e:]

    if resume and mgr is not None and mgr.latest_step() is not None:
        _restore_latest(with_tick=True)

    def _save():
        extra = {"iteration": e, "tick": tick, "prev_obj": prev_obj,
                 "residual": stage_res,
                 "controller": (controller.state_dict()
                                if controller is not None else None)}
        if ledger is not None:
            extra["ledger"] = ledger.summary()
        mgr.save(e, gather_stack(state, ring), extra=extra)

    while e < epochs:
        if controller is not None:
            (bits,) = controller.assign([stage_res], e)
            hist["schedules"].append(bits)
        else:
            bits = None
        step = ft_step(bits)
        p_codec, q_codec = codecs_for(bits)
        if good is None or bits != cur_bits:
            if overlap and inflight is not None and ledger is not None:
                charge_pair(e, cur_bits, "dropped")
            ring.drain()        # the dropped pair's transfers end first
            good = prime_good(bits, state)
            inflight = prime_fly(bits, state, tick - 1) if overlap else None
            cur_bits = bits
        ctl = controls(tick, prev_obj)
        carry = ((state, good), inflight) if overlap else (state, good)
        out, m = calls(step, carry, (*data, ctl))
        if overlap:
            (new_state, new_good), new_inflight = out
        else:
            (new_state, new_good), new_inflight = out, None
        del carry, out
        row = _health_row(m)                 # the iteration's one host read
        wire_bad = [int(x) for x in row[:3]]
        flags = dict(zip(HEALTH_FLAGS, (bool(x) for x in row[3:9])))
        healthy = (all(flags[k] for k in HEALTH_FLAGS[:5])
                   and not flags["objective_spike"])
        # -- fault accounting (every attempt, healthy or not) --------------
        if faults is not None:
            for (en, s_, kind) in faults.events(tick, n_stages):
                ft_trace.append((tick, en, int(s_), kind))
                # one event corrupts that link's slab on EVERY data shard
                fault_counts[en]["injected"] += dp_total
                if ledger is not None:
                    ledger.record_fault(tick, en, "injected", dp_total,
                                        detail=kind)
        for en, bad in zip(FT.EDGES, wire_bad):
            if bad:
                # every failed verdict substituted the last good slab
                fault_counts[en]["detected"] += bad
                fault_counts[en]["recovered"] += bad
                if ledger is not None:
                    ledger.record_fault(tick, en, "detected", bad)
                    ledger.record_fault(tick, en, "recovered", bad)
        if ledger is not None:
            # the attempt's bytes moved whether or not it is accepted
            _record_ring_span(ledger, e, 1, mesh, L, V, h, p_codec, q_codec)
            _record_sentinel_headers(ledger, e, 1, mesh)
        tick += 1
        if healthy:
            state, good, inflight = new_state, new_good, new_inflight
            prev_obj, stage_res = float(row[9]), float(row[10])
            hist["objective"].append(prev_obj)
            hist["residual"].append(stage_res)
            e += 1
            if mgr is not None and ckpt_every and e % ckpt_every == 0:
                _save()
        else:
            # the failed attempt's carry (over a replayed step's buffers)
            # is dropped, so a step first built after the rollback shares
            # those buffers instead of taking new ones
            new_state = new_good = new_inflight = None
            n_rb += 1
            if ledger is not None:
                ledger.record_fault(tick - 1, "step", "rolled_back", 1)
            if n_rb > rec.max_rollbacks:
                raise RuntimeError(
                    f"distributed_train: {n_rb} rollbacks exceeded "
                    f"max_rollbacks={rec.max_rollbacks}: persistent "
                    "divergence, not transient faults")
            if overlap and ledger is not None:
                # the failed attempt's carried pair is discarded
                charge_pair(e, cur_bits, "dropped")
            if mgr is not None and mgr.latest_step() is not None:
                _restore_latest(with_tick=False)
            else:
                state = state0
                e = 0
                prev_obj = float("inf")
                stage_res = 0.0
                del hist["objective"][:]
                del hist["residual"][:]
                if controller is not None and ctl_state0 is not None:
                    controller.load_state_dict(ctl_state0)
            if controller is not None:
                controller.force_widest(e, rec.cooldown)
            good, inflight, cur_bits = None, None, _UNSET

    if overlap and ledger is not None and cur_bits is not _UNSET:
        # the tail pair still in flight in the carry at the end
        charge_pair(epochs, cur_bits, "inflight")
    hist["faults"] = {
        "per_edge": fault_counts,
        "injected": sum(c["injected"] for c in fault_counts.values()),
        "detected": sum(c["detected"] for c in fault_counts.values()),
        "recovered": sum(c["recovered"] for c in fault_counts.values()),
        "rolled_back": n_rb,
        "ticks": tick,
        "trace": ft_trace,
    }
    return state, hist


def distributed_train(mesh, seed, Xp, labels, masks, L, n_classes,
                      config: ADMMConfig, epochs: int, *, ledger=None,
                      controller=None, grids_by_bits=None, overlap=False,
                      chunk: int = 32, mixed_width: bool = False,
                      faults=None, health: bool = False, ckpt=None,
                      ckpt_every: int = 0, resume: bool = False,
                      recovery=None, ring=None,
                      init: Optional[StackState] = None, cost_table=None,
                      jit: bool = True):
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
    ``overlap=False``. ``jit`` is ``run_chunked``'s: on a ``LocalRing`` on
    the card the step is captured once as a CUDA graph and replayed (the
    in-flight pair is part of the graph's state); a ``ProcessGroupRing``
    always runs the eager loop (its shifts are gloo messages on the CPU).
    The controller, mixed-width and fault-tolerant loops below read each
    iteration's metrics on the host; with ``jit`` on a ``LocalRing`` on the
    card each of their iterations is one replay of its step's captured
    graph (the carry in the program's buffers, the widths table or the
    tick's fault controls rewritten in place before the replay, the
    metrics read in one copy after it), as the reference jits each of
    their steps; ``hist``, the ledger and the ring's byte count are the
    eager loop's.

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

    Fault tolerance (any of ``faults`` / ``health=True`` / ``ckpt``)
    switches to the SENTINEL loop: every iteration runs a ``health=True``
    step (integrity headers, last-good substitution, finite/spike
    sentinels; :mod:`repro_torch.comm.faults`), ``faults`` injects its
    deterministic chaos plan, and an UNHEALTHY iteration (non-finite state
    or metrics, or an objective spike: what undetected corruption causes)
    is rolled back to the latest checkpoint (or the initial state when
    there is none), the good-slab and overlap carries re-primed and
    :meth:`BitWidthController.force_widest` held for
    ``recovery.cooldown`` control steps; more than
    ``recovery.max_rollbacks`` rollbacks raise. ``ckpt`` is a
    :class:`repro_torch.ckpt.manager.CheckpointManager` or a directory;
    ``ckpt_every=k`` saves atomically every k accepted iterations (the
    global stack, :func:`gather_stack`, plus iteration, plan tick,
    objective, controller state and ledger rollup in the manifest), and
    ``resume=True`` restores the latest checkpoint first, through this
    ring's layout, so resuming onto another mesh is elastic. The plan tick
    advances every attempted iteration and is never rewound by a rollback;
    a resume continues it. ``hist["faults"]`` accounts every injected event
    (re-enumerated from the plan) against detected and recovered verdicts
    and rollbacks; the ledger gains per-edge fault counts and the header
    bytes. Not with ``mixed_width=True``; ``ckpt`` not on a
    ``ProcessGroupRing``.

    ``overlap="replay"`` makes the knob a replay-searched choice: both step
    variants are traced and the predicted-faster one runs
    (:func:`choose_overlap_for`, priced by ``cost_table``, a calibrated
    ``analysis.costs.CostTable``; without one the hand default, overlap
    on, applies). ``hist["overlap"]`` holds the resolved value.
    """
    V, h = Xp.shape
    if overlap == "replay":
        overlap = choose_overlap_for(mesh, L, n_classes, config, V=V, h=h,
                                     costs=cost_table, ring=ring)
    ft_mode = faults is not None or bool(health) or ckpt is not None
    if (resume or ckpt_every) and ckpt is None:
        raise ValueError("resume=/ckpt_every= need ckpt= (a "
                         "CheckpointManager or a directory path)")
    if ft_mode and mixed_width:
        raise NotImplementedError(
            "mixed_width is not supported with faults/health/ckpt yet: the "
            "fault-tolerant loop drives the uniform-codec step family")
    overlap = bool(overlap)
    ring = LocalRing(mesh, Xp.device) if ring is None else ring
    state = init_stack(seed, Xp, L, config) if init is None else init
    state = shard_stack(state, ring)
    data = (ring.to_local(Xp, "rows"), ring.to_local(labels, "rows"),
            ring.to_local(masks["train"], "rows"))
    hist = {"objective": [], "residual": [], "schedules": []}
    step_cache = {}
    from repro_torch.core import graphs
    calls = _Calls(jit and isinstance(ring, LocalRing)
                   and graphs.on_cuda(state))

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

    if ft_mode:
        state, hist = _ft_train_loop(
            mesh=mesh, ring=ring, state=state, data=data, L=L, V=V, h=h,
            n_classes=n_classes, config=config, epochs=epochs, hist=hist,
            ledger=ledger, controller=controller, codecs_for=codecs_for,
            step_cache=step_cache, overlap=overlap, faults=faults, ckpt=ckpt,
            ckpt_every=ckpt_every, resume=resume, recovery=recovery,
            calls=calls)
    elif mixed_width:
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
        # the step's widths table: one tensor, rewritten each iteration
        table = torch.zeros((2, n_stages), dtype=torch.int32,
                            device=ring.device)
        for e in range(epochs):
            sig = stage_res if n_edges == n_stages else stage_res + stage_res
            sched = controller.assign(sig, e)
            q_bits = sched[:n_stages]
            p_bits = sched[:n_stages] if n_edges == n_stages \
                else sched[n_stages:]
            hist["schedules"].append(sched)
            wire.widths_table(q_bits, p_bits, out=table)
            if overlap:
                if inflight is None or q_bits != prev_q_bits:
                    if inflight is not None and ledger is not None:
                        # the superseded pair (old q widths) already
                        # crossed the link
                        _record_container_qu_pair(ledger, e, mesh, L, V, h,
                                                  wire, prev_q_bits,
                                                  "dropped")
                    ring.drain()
                    inflight = primer(state.q, state.u, table)
                    prev_q_bits = q_bits
                (state, inflight), m = calls(step, (state, inflight),
                                             (*data, table))
            else:
                state, m = calls(step, state, (*data, table))
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
        carry, ms = run_chunked(step, carry, data, epochs, chunk=chunk,
                                jit=jit and isinstance(ring, LocalRing))
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
                    ring.drain()
                    inflight = prime(bits, state)
                    cur_bits = bits
                (state, inflight), m = calls(step, (state, inflight), data)
            else:
                state, m = calls(step, state, data)
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
    ring.drain()        # the tail pair in flight under overlap
    return gather_stack(state, ring), hist

