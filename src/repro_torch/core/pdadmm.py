"""pdADMM-G / pdADMM-G-Q: the paper's Algorithm 1, single host, on PyTorch.

Counterpart of ``repro.core.pdadmm``.

Variable layout (0-based, node-major):
  p[l] : [V, dims[l]]     layer input,  l = 0..L-1, p[0] = X (never updated)
  W[l] : [dims[l], dims[l+1]]
  b[l] : [dims[l+1]]
  z[l] : [V, dims[l+1]]
  q[l] : [V, dims[l+1]]   layer output, l = 0..L-2
  u[l] : [V, dims[l+1]]   dual,         l = 0..L-2
  constraint: p[l+1] = q[l]

Each layer's residual r = z - pW - b is computed once per iteration and
chained through the p-, W-, b- and z-updates (see the reference's module
docstring). With an equal-width hidden block the solvers run layer-stacked
over a leading [L_h, ...] axis, so each family is one kernel launch.
``iterate_reference`` keeps the pre-optimization math as the oracle.

State tensors are never updated in place: ``init_state`` gives p[l+1] and
q[l] the same tensor, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import subproblems as sp
from repro_torch.core.quantize import QuantGrid, uniform_grid


class ADMMState(NamedTuple):
    p: List[torch.Tensor]
    W: List[torch.Tensor]
    b: List[torch.Tensor]
    z: List[torch.Tensor]
    q: List[torch.Tensor]
    u: List[torch.Tensor]
    tau: List[torch.Tensor]    # last accepted τ_l  (warm-started each iter)
    theta: List[torch.Tensor]  # last accepted θ_l


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    nu: float = 1e-2
    rho: float = 1.0
    fista_iters: int = 15
    tau0: float = 1.0
    backtrack_decay: float = 0.5   # warm start: next τ0 = τ_used * decay
    quantize_p: bool = False
    quantize_q: bool = False
    grid: Optional[QuantGrid] = None
    use_kernels: bool = True       # heavy ops through kernels.ops dispatch
    stack_hidden: bool = True      # layer-stacked solves over equal widths


def relu(x):
    return torch.clamp(x, min=0.0)


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device="cpu").manual_seed(int(seed))


def init_state(seed, X, dims: Sequence[int], config: ADMMConfig, *,
               device=None) -> ADMMState:
    """dims: [n_0, n_1, ..., n_L] (n_0 = K*d input width, n_L = #classes).
    Forward-propagates X through random weights so (p, z, q) start
    self-consistent and residuals start 0. ``seed`` is an int or a CPU
    ``torch.Generator``; the weights are drawn on the CPU and moved, so a
    seed gives the same weights on every device (not the reference's
    ``jax.random`` numbers — tests hand the reference's state over through
    ``core.interop.state_from_numpy``). With ``quantize_p`` q and p start
    on the grid and share one tensor, as in the reference."""
    device = resolve_device(device)
    gen = _generator(seed)
    X = X.to(device)
    L = len(dims) - 1
    W, b, z, q, p, u = [], [], [], [], [X], []
    cur = X
    for l in range(L):
        Wl = (torch.randn((dims[l], dims[l + 1]), generator=gen,
                          dtype=torch.float32)
              * float(np.sqrt(2.0 / dims[l]))).to(device)
        bl = torch.zeros((dims[l + 1],), dtype=torch.float32, device=device)
        zl = cur @ Wl + bl
        W.append(Wl)
        b.append(bl)
        z.append(zl)
        if l < L - 1:
            ql = relu(zl)
            if config.quantize_p and config.grid is not None:
                ql = config.grid.project(ql)
            q.append(ql)
            p.append(ql)
            u.append(torch.zeros_like(ql))
            cur = ql
    tau = [torch.tensor(config.tau0, dtype=torch.float32, device=device)
           for _ in range(L)]
    theta = [torch.tensor(config.tau0, dtype=torch.float32, device=device)
             for _ in range(L)]
    return ADMMState(p, W, b, z, q, u, tau, theta)


def _u_wire(u, u_codecs):
    """The receiver's view of each dual u_l after its wire codec (the
    stored dual stays exact)."""
    if u_codecs is None:
        return list(u)
    from repro_torch.comm.codecs import fake_quantize
    return [ul if c is None else fake_quantize(c, ul)
            for c, ul in zip(u_codecs, u)]


def _default_grids(config: ADMMConfig, L: int, p_grids, q_grids):
    if p_grids is None:
        p_grids = (config.grid if config.quantize_p else None,) * L
    if q_grids is None:
        q_grids = (config.grid if config.quantize_q else None,) * (L - 1)
    return p_grids, q_grids


def iterate(state: ADMMState, X, labels, label_mask,
            config: ADMMConfig, p_grids: Optional[tuple] = None,
            q_grids: Optional[tuple] = None,
            u_codecs: Optional[tuple] = None) -> tuple:
    """One full Algorithm-1 iteration. Returns (new_state, metrics dict).

    Within an iteration the updates are sequential across variable families
    (p, W, b, z, q, u) and parallel across layers within each family.
    ``p_grids`` (length L, entry 0 unused) and ``q_grids`` (length L-1)
    give each layer its own grid; by default every layer uses
    ``config.grid`` where ``quantize_p`` / ``quantize_q`` ask for it.
    ``u_codecs`` (length L-1) quantizes the transmitted view of each dual
    u_l that layer l+1's p- and W-updates read; the stored dual stays exact.
    """
    L = len(state.W)
    p_grids, q_grids = _default_grids(config, L, p_grids, q_grids)
    if config.stack_hidden and _stackable(state, p_grids, q_grids):
        return _iterate_stacked(state, X, labels, label_mask, config,
                                p_grids, q_grids, u_codecs)
    return _iterate_layers(state, X, labels, label_mask, config, p_grids,
                           q_grids, u_codecs)


def _stackable(state: ADMMState, p_grids, q_grids) -> bool:
    """True when layers 1..L-2 share a square [h, h] weight (equal-width
    hidden block) and the grids are homogeneous over the stacked ranges."""
    L = len(state.W)
    if L < 4:                       # need >= 2 square layers to win anything
        return False
    h = state.W[1].shape[0]
    if any(tuple(state.W[l].shape) != (h, h) for l in range(1, L - 1)):
        return False
    if state.W[0].shape[1] != h or state.W[L - 1].shape[0] != h:
        return False
    return len(set(p_grids[1:L - 1])) <= 1 and len(set(q_grids)) <= 1


def _iterate_layers(state, X, labels, label_mask, config, p_grids, q_grids,
                    u_codecs):
    """Per-layer path: residual chaining + incremental backtracking,
    heterogeneous widths and grids allowed."""
    nu, rho = config.nu, config.rho
    uk = config.use_kernels
    decay = config.backtrack_decay
    L = len(state.W)

    p, W, b, z, q, u = (list(state.p), list(state.W), list(state.b),
                        list(state.z), list(state.q), list(state.u))
    tau, theta = list(state.tau), list(state.theta)
    u_wire = _u_wire(u, u_codecs)

    # ---- entry residuals r_l = z_l - p_l W_l - b_l (one fused op each) ----
    r = [sp._residual(p[l], W[l], b[l], z[l], uk) for l in range(L)]

    # ---- p-updates (l = 1..L-1) --------------------------------------------
    for l in range(1, L):
        p[l], tau[l], r[l] = sp.update_p(
            p[l], W[l], b[l], z[l], q[l - 1], u_wire[l - 1], nu, rho,
            tau[l] * decay + 1e-6, grid=p_grids[l], r0=r[l], use_kernels=uk)

    # ---- W-updates -----------------------------------------------------------
    for l in range(L):
        qp = q[l - 1] if l > 0 else None
        up = u_wire[l - 1] if l > 0 else None
        W[l], theta[l], r[l] = sp.update_W(
            p[l], W[l], b[l], z[l], qp, up, nu, rho,
            theta[l] * decay + 1e-6, first=(l == 0), r0=r[l], use_kernels=uk)

    # ---- b-updates (exact: b⁺ = b + mean r; matmul-free) --------------------
    for l in range(L):
        db = r[l].mean(dim=0)
        b[l] = b[l] + db
        r[l] = r[l] - db

    # ---- z-updates (a_l = p_l W_l + b_l = z_l - r_l; matmul-free) -----------
    z_old = list(state.z)
    for l in range(L - 1):
        z[l] = sp._zupdate(z[l] - r[l], q[l], z[l], nu, uk)
    z[L - 1] = sp.update_z_last(z[L - 1] - r[L - 1], z[L - 1], labels,
                                label_mask, nu, config.fista_iters,
                                use_kernels=uk)

    # ---- q-updates ------------------------------------------------------------
    dual_res = []
    for l in range(L - 1):
        q[l] = sp.update_q(p[l + 1], u[l], relu(z[l]), nu, rho,
                           grid=q_grids[l])
        dual_res.append(rho * torch.linalg.norm(q[l] - state.q[l]))

    # ---- dual updates + residuals -------------------------------------------
    res_sq = 0.0
    layer_res, cons = [], []
    for l in range(L - 1):
        u[l], rc = sp.update_u(u[l], p[l + 1], q[l], rho)
        cons.append(rc)
        rsq = sp._dot(rc, rc)
        res_sq = res_sq + rsq
        layer_res.append(torch.sqrt(rsq))

    new = ADMMState(p, W, b, z, q, u, tau, theta)
    # objective, reusing the chained residuals: rr_l = r_l + (z⁺_l - z_l)
    obj, _ = sp.ce_value_grad(z[L - 1], labels, label_mask)
    for l in range(L):
        rr = r[l] + (z[l] - z_old[l])
        obj = obj + 0.5 * nu * sp._dot(rr, rr)
    for l in range(L - 1):
        gq = q[l] - relu(z[l])
        obj = obj + 0.5 * nu * sp._dot(gq, gq)
        obj = obj + sp._dot(u[l], cons[l]) + 0.5 * rho * sp._dot(cons[l],
                                                                  cons[l])
    empty = torch.zeros((0,), dtype=torch.float32, device=obj.device)
    metrics = {
        "objective": obj,
        "residual": torch.sqrt(torch.as_tensor(res_sq, device=obj.device)),
        "layer_residuals": torch.stack(layer_res) if layer_res else empty,
        "layer_dual_residuals": torch.stack(dual_res) if dual_res else empty,
    }
    return new, metrics


def _iterate_stacked(state, X, labels, label_mask, config, p_grids, q_grids,
                     u_codecs):
    """Layer-stacked path for the equal-width hidden block (layers 1..L-2
    share [h, h] weights — the paper's large-scale configuration). Each
    variable family is ONE batched solve over the [L_h, ...] stack; the
    ragged first/last layers run individually."""
    nu, rho = config.nu, config.rho
    uk = config.use_kernels
    decay = config.backtrack_decay
    L = len(state.W)
    last = L - 1
    u_wire = _u_wire(state.u, u_codecs)

    # ---- stack the homogeneous block (layers 1..L-2) ------------------------
    ph = torch.stack(state.p[1:last])
    Wh = torch.stack(state.W[1:last])
    bh = torch.stack(state.b[1:last])
    zh = torch.stack(state.z[1:last])
    qph = torch.stack(state.q[0:last - 1])      # q_{l-1} for l in 1..L-2
    uph = torch.stack(u_wire[0:last - 1])
    tauh = torch.stack(state.tau[1:last])
    thetah = torch.stack(state.theta[1:last])
    grid_h = p_grids[1]
    q_grid = q_grids[0]

    # ---- entry residuals -------------------------------------------------------
    r0 = sp._residual(state.p[0], state.W[0], state.b[0], state.z[0], uk)
    rh = sp._residual(ph, Wh, bh, zh, uk)
    rl = sp._residual(state.p[last], state.W[last], state.b[last],
                      state.z[last], uk)

    # ---- p-updates: one batched solve for the block + the last layer ---------
    ph, tauh, rh = sp.update_p(ph, Wh, bh, zh, qph, uph, nu, rho,
                               tauh * decay + 1e-6, grid=grid_h, r0=rh,
                               use_kernels=uk)
    p_last, tau_last, rl = sp.update_p(
        state.p[last], state.W[last], state.b[last], state.z[last],
        state.q[last - 1], u_wire[last - 1], nu, rho,
        state.tau[last] * decay + 1e-6, grid=p_grids[last], r0=rl,
        use_kernels=uk)

    # ---- W-updates ---------------------------------------------------------------
    W0, theta0, r0 = sp.update_W(
        state.p[0], state.W[0], state.b[0], state.z[0], None, None, nu, rho,
        state.theta[0] * decay + 1e-6, first=True, r0=r0, use_kernels=uk)
    Wh, thetah, rh = sp.update_W(ph, Wh, bh, zh, qph, uph, nu, rho,
                                 thetah * decay + 1e-6, first=False, r0=rh,
                                 use_kernels=uk)
    W_last, theta_last, rl = sp.update_W(
        p_last, state.W[last], state.b[last], state.z[last],
        state.q[last - 1], u_wire[last - 1], nu, rho,
        state.theta[last] * decay + 1e-6, first=False, r0=rl, use_kernels=uk)

    # ---- b-updates (exact, matmul-free) ------------------------------------------
    db0 = r0.mean(dim=0)
    b0, r0 = state.b[0] + db0, r0 - db0
    dbh = rh.mean(dim=1, keepdim=True)
    bh, rh = bh + dbh[:, 0, :], rh - dbh
    dbl = rl.mean(dim=0)
    b_last, rl = state.b[last] + dbl, rl - dbl

    # ---- z-updates: hidden layers 0..L-2 in ONE stacked launch -------------------
    z_old_hid = torch.stack(state.z[0:last])             # [L-1, V, h]
    r_hid = torch.cat([r0[None], rh], dim=0)
    a_hid = z_old_hid - r_hid
    q_old = torch.stack(state.q)                         # [L-1, V, h]
    z_hid = sp._zupdate(a_hid, q_old, z_old_hid, nu, uk)
    z_last = sp.update_z_last(state.z[last] - rl, state.z[last], labels,
                              label_mask, nu, config.fista_iters,
                              use_kernels=uk)

    # ---- q-updates (closed form, elementwise over the [L-1, V, h] stack) ---------
    u_old = torch.stack(state.u)
    p_next = torch.cat([ph, p_last[None]], dim=0)       # p_{l+1}, new
    fz = relu(z_hid)
    q_new = sp.update_q(p_next, u_old, fz, nu, rho, grid=q_grid)
    dual_res = rho * torch.sqrt(((q_new - q_old) ** 2).sum(dim=(1, 2)))

    # ---- dual updates + residuals -------------------------------------------------
    u_new, cons = sp.update_u(u_old, p_next, q_new, rho)
    layer_sq = (cons ** 2).sum(dim=(1, 2))
    layer_res = torch.sqrt(layer_sq)
    res = torch.sqrt(layer_sq.sum())

    # ---- objective from the chained residuals -------------------------------------
    obj, _ = sp.ce_value_grad(z_last, labels, label_mask)
    rr_hid = r_hid + (z_hid - z_old_hid)
    rr_last = rl + (z_last - state.z[last])
    obj = obj + 0.5 * nu * ((rr_hid ** 2).sum() + (rr_last * rr_last).sum())
    gq = q_new - fz
    obj = obj + 0.5 * nu * (gq ** 2).sum()
    obj = obj + (u_new * cons).sum() + 0.5 * rho * (cons ** 2).sum()

    new = ADMMState(
        p=[state.p[0]] + list(ph.unbind(0)) + [p_last],
        W=[W0] + list(Wh.unbind(0)) + [W_last],
        b=[b0] + list(bh.unbind(0)) + [b_last],
        z=list(z_hid.unbind(0)) + [z_last],
        q=list(q_new.unbind(0)),
        u=list(u_new.unbind(0)),
        tau=[state.tau[0]] + list(tauh.unbind(0)) + [tau_last],
        theta=[theta0] + list(thetah.unbind(0)) + [theta_last])
    metrics = {
        "objective": obj,
        "residual": res,
        "layer_residuals": layer_res,
        "layer_dual_residuals": dual_res,
    }
    return new, metrics


def iterate_reference(state: ADMMState, X, labels, label_mask,
                      config: ADMMConfig, p_grids: Optional[tuple] = None,
                      q_grids: Optional[tuple] = None,
                      u_codecs: Optional[tuple] = None) -> tuple:
    """The pre-optimization Algorithm-1 iteration: naive per-trial φ
    re-evaluation, per-layer matmuls for b/z, no kernel dispatch. Ground
    truth for the fast path's equivalence tests."""
    nu, rho = config.nu, config.rho
    L = len(state.W)
    p_grids, q_grids = _default_grids(config, L, p_grids, q_grids)

    p, W, b, z, q, u = (list(state.p), list(state.W), list(state.b),
                        list(state.z), list(state.q), list(state.u))
    tau, theta = list(state.tau), list(state.theta)
    u_wire = _u_wire(u, u_codecs)

    for l in range(1, L):
        p[l], tau[l] = sp.update_p_reference(
            p[l], W[l], b[l], z[l], q[l - 1], u_wire[l - 1], nu, rho,
            tau[l] * config.backtrack_decay + 1e-6, grid=p_grids[l])

    for l in range(L):
        qp = q[l - 1] if l > 0 else None
        up = u_wire[l - 1] if l > 0 else None
        W[l], theta[l] = sp.update_W_reference(
            p[l], W[l], b[l], z[l], qp, up, nu, rho,
            theta[l] * config.backtrack_decay + 1e-6, first=(l == 0))

    for l in range(L):
        b[l] = sp.update_b(p[l], W[l], z[l])

    for l in range(L - 1):
        a = sp.linear(p[l], W[l], b[l])
        z[l] = sp.update_z_hidden(a, q[l], z[l], nu)
    aL = sp.linear(p[L - 1], W[L - 1], b[L - 1])
    z[L - 1] = sp.update_z_last_reference(aL, z[L - 1], labels, label_mask,
                                          nu, config.fista_iters)

    dual_res = []
    for l in range(L - 1):
        q[l] = sp.update_q(p[l + 1], u[l], relu(z[l]), nu, rho,
                           grid=q_grids[l])
        dual_res.append(rho * torch.linalg.norm(q[l] - state.q[l]))

    res_sq = 0.0
    layer_res = []
    for l in range(L - 1):
        u[l], rc = sp.update_u(u[l], p[l + 1], q[l], rho)
        rsq = sp._dot(rc, rc)
        res_sq = res_sq + rsq
        layer_res.append(torch.sqrt(rsq))

    new = ADMMState(p, W, b, z, q, u, tau, theta)
    obj = lagrangian(new, labels, label_mask, config)
    empty = torch.zeros((0,), dtype=torch.float32, device=obj.device)
    metrics = {
        "objective": obj,
        "residual": torch.sqrt(torch.as_tensor(res_sq, device=obj.device)),
        "layer_residuals": torch.stack(layer_res) if layer_res else empty,
        "layer_dual_residuals": torch.stack(dual_res) if dual_res else empty,
    }
    return new, metrics


def lagrangian(s: ADMMState, labels, label_mask, config: ADMMConfig):
    """L_ρ (Section III-B)."""
    nu, rho = config.nu, config.rho
    L = len(s.W)
    val, _ = sp.ce_value_grad(s.z[L - 1], labels, label_mask)
    for l in range(L):
        r = s.z[l] - sp.linear(s.p[l], s.W[l], s.b[l])
        val = val + 0.5 * nu * sp._dot(r, r)
    for l in range(L - 1):
        g = s.q[l] - relu(s.z[l])
        val = val + 0.5 * nu * sp._dot(g, g)
        d = s.p[l + 1] - s.q[l]
        val = val + sp._dot(s.u[l], d) + 0.5 * rho * sp._dot(d, d)
    return val


def forward_accuracy(s: ADMMState, X, labels, mask) -> torch.Tensor:
    """Inference accuracy of the trained MLP (standard forward pass)."""
    h = X
    L = len(s.W)
    for l in range(L - 1):
        h = relu(h @ s.W[l] + s.b[l])
    logits = h @ s.W[L - 1] + s.b[L - 1]
    pred = torch.argmax(logits, dim=-1)
    correct = ((pred == labels.long()) * mask).sum()
    return correct / torch.clamp(mask.sum(), min=1.0)


def calibrate_grid(seed, X, dims, bits: int, margin_frac: float = 0.05):
    """Fit a b-bit uniform grid to this model's activation range, sampled at
    a forward-consistent init (``seed``: an int or a CPU torch.Generator, as
    for ``init_state``) — the analogue of the paper choosing Δ = {-1..20}
    to cover its activations."""
    state = init_state(seed, X, dims, ADMMConfig(), device=X.device)
    vals = torch.cat([q.reshape(-1)[:20_000] for q in state.q] or
                     [X.reshape(-1)[:20_000]])
    lo, hi = float(torch.min(vals)), float(torch.max(vals))
    margin = (hi - lo) * margin_frac
    return uniform_grid(bits, lo - margin, hi + margin)


# ---------------------------------------------------------------------------
# Chunked training driver
# ---------------------------------------------------------------------------

def run_chunked(step_fn, state, args, n_iters: int, chunk: int = 32, *,
                jit: bool = True):
    """Run ``n_iters`` iterations of ``step_fn(state, *args) -> (state, m)``
    in chunks: the per-iteration metrics stay on the device within a chunk
    and move to the host once per chunk (nothing in an iteration syncs).

    ``jit=True`` (the reference's ``lax.scan`` chunk) runs the iterations
    of a state on a CUDA device through ``core.graphs``: one iteration is
    captured as a CUDA graph, cached per ``step_fn`` and signature, and
    replayed. The state comes back as tensors over buffers that every
    program over a state of its signature shares. Such a state does not
    change under a later call unless it is passed back in (then it is not
    copied again): a call that brings another state while a returned one
    is still held gets new buffers (and captures anew), and the held
    state keeps the old storage. A step that donates its input
    (``make_distributed_step(donate=True)``) writes into those buffers,
    which skip their copy-back. On the CPU, which has no graphs, and with
    ``jit=False``, ``step_fn`` is called once per iteration in a Python
    loop.

    Returns ``(state, metrics)`` with metrics stacked host-side over all
    ``n_iters`` (numpy arrays, leading axis = iteration); an empty dict when
    ``n_iters <= 0``.
    """
    if n_iters <= 0:
        return state, {}
    chunk = max(1, min(int(chunk), int(n_iters)))
    from repro_torch.core import graphs
    if jit and graphs.on_cuda(state):
        return graphs.run(step_fn, state, args, n_iters, chunk)
    pieces, done = [], 0
    while done < n_iters:
        c = min(chunk, n_iters - done)
        ms = []
        for _ in range(c):
            state, m = step_fn(state, *args)
            ms.append(m)
        pieces.append({k: torch.stack([m[k] for m in ms]).cpu().numpy()
                       for k in ms[0]})
        done += c
    metrics = {k: np.concatenate([piece[k] for piece in pieces])
               for k in pieces[0]}
    return state, metrics


def train(seed, X, labels, masks, dims, config: ADMMConfig, epochs: int,
          *, device=None, jit: bool = True, callback=None, chunk: int = 32):
    """Run `epochs` iterations from ``init_state(seed, ...)``; returns
    (state, history dict). The default driver is ``run_chunked(...,
    jit=True)``: on the card each iteration replays one captured CUDA
    graph, on the CPU the chunked eager loop runs, and the metrics reach
    the host once per ``chunk`` iterations. A ``callback(epoch, state,
    metrics)``, which needs the state every epoch, or ``jit=False`` runs
    the per-epoch eager loop instead, as the reference's ``train`` does."""
    device = resolve_device(device)
    X, labels = X.to(device), labels.to(device)
    masks = {k: m.to(device) for k, m in masks.items()}
    state = init_state(seed, X, dims, config, device=device)
    hist = {"objective": [], "residual": [], "val_acc": [], "test_acc": []}

    def step(s, *args):
        return iterate(s, *args, config=config)

    if callback is None and jit:
        state, ms = run_chunked(step, state, (X, labels, masks["train"]),
                                epochs, chunk=chunk)
        hist["objective"] = [float(x) for x in ms.get("objective", [])]
        hist["residual"] = [float(x) for x in ms.get("residual", [])]
    else:
        for e in range(epochs):
            state, m = step(state, X, labels, masks["train"])
            hist["objective"].append(float(m["objective"]))
            hist["residual"].append(float(m["residual"]))
            if callback is not None:
                callback(e, state, m)
    hist["val_acc"].append(float(forward_accuracy(state, X, labels,
                                                  masks["val"])))
    hist["test_acc"].append(float(forward_accuracy(state, X, labels,
                                                   masks["test"])))
    return state, hist
