#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Run from the repository root on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Phases, in order; any failure raises
and the script exits non-zero without printing a result:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of pdADMM-G / pdADMM-G-Q on cora with the paper's 10×1000
   GA-MLP, and time the kernel, the plain version and, where one PyTorch
   call computes the same function, that call (``library_ms``; the port
   never calls it).
3. Train pdADMM-G on cora at 10×1000 for a few iterations through
   ``repro_torch.core.pdadmm.train`` with every launch counter set to 0
   just before; its four kernels must have launched, the objective must be
   finite and must track the same run with ``use_kernels=False`` on the
   card at rtol 1e-3. Then time a few steady-state iterations of both
   paths, and trace one kernel-path iteration with torch.profiler (device
   time by kernel, the device's idle share).
4. The same for pdADMM-G-Q (p and q on ``uniform_grid(8, -2, 6)``, the
   quickstart's grid): the four, ``backtrack_resnorm`` and
   ``grid_project`` must launch. Both paths' τ per layer and iteration are
   printed with the trials per p-update that were active, and the layers
   where the two paths' τ differ. Where rtol 1e-3 fails and a τ differs,
   the two paths are held from one shared state one iteration at a time
   instead, and each flip is printed with its accept-test margin.
5. Two G-Q iterations with 8-bit grid codecs on the dual's wire
   (``u_codecs``): ``grid_encode`` and ``grid_decode`` must launch.
6. Print the wire bytes per iteration from the port's ledger (G, G-Q,
   G-Q with the u wire), the card (``nvidia-smi``), one JSON line with
   every kernel's numbers, and last the device line.

Tolerances (f32 on both sides, sums in another order): matmul kernels
max|kernel − plain| ≤ 1e-5·max|plain|; backtrack_resnorm within rtol 1e-5
of the plain value per layer; fista_zlast atol 1e-5 + rtol 1e-5 (expf
against torch's exp, ulps over 16 steps); relu_zupdate within 1e-6
relative (IEEE /3 in the kernel, a reciprocal multiply in PyTorch's CUDA
division by a scalar), and where the two branch objectives tie to 1e-5,
equal objective values; the grid kernels bitwise (the same arithmetic).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (the port's matmuls are full f32, no TF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MATMUL_REL_TOL = 1e-5
RESNORM_RTOL = 1e-5
FISTA_ATOL = 1e-5
FISTA_RTOL = 1e-5
TRAJ_RTOL = 1e-3
EPOCHS = 5          # iterations of each training run (the reference trains 200)
MAX_DOUBLINGS = 12  # the p-update's backtracking trials (subproblems.update_p)
BASE_KERNELS = ("fused_linear", "admm_pgrad", "relu_zupdate", "fista_zlast")
GQ_KERNELS = BASE_KERNELS + ("backtrack_resnorm", "grid_project")
WIRE_KERNELS = ("grid_encode", "grid_decode")
SOURCES = {
    "fused_linear": ("src/repro_torch/kernels/csrc/fused_linear.cu",
                     "src/repro/kernels/fused_linear.py:40"),
    "admm_pgrad": ("src/repro_torch/kernels/csrc/admm_pgrad.cu",
                   "src/repro/kernels/admm_pgrad.py:18"),
    "relu_zupdate": ("src/repro_torch/kernels/csrc/relu_zupdate.cu",
                     "src/repro/kernels/relu_zupdate.py:28"),
    "fista_zlast": ("src/repro_torch/kernels/csrc/fista_zlast.cu",
                    "src/repro/kernels/fista_zlast.py:88"),
    "backtrack_resnorm": ("src/repro_torch/kernels/csrc/backtrack_resnorm.cu",
                          "src/repro/kernels/backtrack_phi.py:44"),
    "grid_project": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                     "src/repro/kernels/quantize_kernel.py:51"),
    "grid_encode": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                    "src/repro/kernels/quantize_kernel.py:57"),
    "grid_decode": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                    "src/repro/kernels/quantize_kernel.py:64"),
}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, what bounds it) on the card for this much work."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def case(name, kernel, plain, library, n_bytes, n_ops, check):
    """Run, check and time one kernel at one shape."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    check(got, want, err)
    b_ms, b_by = bound(n_bytes, n_ops)
    row = {"shape": name, "max_abs_err": err, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain),
           "library_ms": None if library is None else time_ms(library),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"  {name}: err {err:.3e}  kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library {row['library_ms']}  bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return row


def matmul_check(got, want, err):
    tol = MATMUL_REL_TOL * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f"max abs err {err:.3e} > {tol:.3e}")


def resnorm_check(got, want, err):
    bad = (got - want).abs() > RESNORM_RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"backtrack_resnorm: {got.tolist()} vs plain "
                             f"{want.tolist()} beyond rtol {RESNORM_RTOL}")


def bitwise_check(got, want, err):
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"not bitwise equal ({got.dtype} vs "
                             f"{want.dtype}, max abs err {err:.3e})")


def fista_check(got, want, err):
    bad = (got - want).abs() > FISTA_ATOL + FISTA_RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"fista_zlast: {int(bad.sum())} elements beyond "
                             f"atol {FISTA_ATOL} + rtol {FISTA_RTOL}")


def zupdate_check_for(a, q, z0):
    def obj(z):
        return (z - a) ** 2 + (q - z.clamp(min=0)) ** 2 + (z - z0) ** 2

    def check(got, want, err):
        # The kernel divides by 3 in IEEE; PyTorch on CUDA multiplies by the
        # reciprocal, so values may differ by an ulp, and where the two
        # branch objectives tie the branch itself may differ.
        zn = ((a + z0) / 2).clamp(max=0)
        zp = ((a + q + z0) / 3).clamp(min=0)
        tied = (obj(zn) - obj(zp)).abs() <= 1e-5 * (obj(zn).abs() + 1e-6)
        far = (got - want).abs() > 1e-6 * want.abs() + 1e-7
        bad = far & ~tied
        if bool(bad.any()):
            raise AssertionError(f"relu_zupdate: {int(bad.sum())} untied "
                                 f"elements differ")
        if not bool(((obj(got) - obj(want)).abs()
                     <= 1e-5 * (obj(want).abs() + 1e-6)).all()):
            raise AssertionError("relu_zupdate: objective differs at a tie")
    return check


def kernel_phase(X, ds, dims, nu, rho, grid):
    from repro_torch.kernels import ref
    from repro_torch.kernels import quantize_kernel as qk
    from repro_torch.kernels.admm_pgrad import admm_pgrad
    from repro_torch.kernels.backtrack_phi import backtrack_resnorm
    from repro_torch.kernels.fista_zlast import fista_zlast, momentum_schedule
    from repro_torch.kernels.fused_linear import fused_linear
    from repro_torch.kernels.relu_zupdate import relu_zupdate

    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    V, K0, h, C = X.shape[0], dims[0], dims[1], dims[-1]
    B = len(dims) - 3                       # stacked hidden layers 1..L-2
    rows = {}

    print("fused_linear:", flush=True)
    fl = []
    for name, p, W, b, z in (
            (f"residual [{V},{K0}]@[{K0},{h}]", X, rand(K0, h, scale=K0 ** -0.5),
             rand(h), rand(V, h)),
            (f"residual x{B} [{V},{h}]@[{h},{h}]", rand(B, V, h).relu(),
             rand(B, h, h, scale=h ** -0.5), rand(B, h), rand(B, V, h)),
            (f"residual [{V},{h}]@[{h},{C}]", rand(V, h).relu(),
             rand(h, C, scale=h ** -0.5), rand(C), rand(V, C))):
        zb = z - b.unsqueeze(-2)
        lib = ((lambda zb=zb, p=p, W=W: torch.addmm(zb, p, W, alpha=-1))
               if p.dim() == 2 else
               (lambda zb=zb, p=p, W=W: torch.baddbmm(zb, p, W, alpha=-1)))
        nb = p.shape[0] if p.dim() == 3 else 1
        M, K = p.shape[-2:]
        N = W.shape[-1]
        fl.append(case(
            name, lambda: fused_linear(p, W, b, z, mode="residual"),
            lambda: ref.fused_linear_ref(p, W, b, z, mode="residual"), lib,
            4 * nb * (M * K + K * N + N + 2 * M * N),
            nb * (2 * M * K * N + 2 * M * N), matmul_check))
    g = rand(K0, h, scale=1e-3)
    fl.append(case(
        f"linear [{V},{K0}]@[{K0},{h}] (W-update pg)",
        lambda: fused_linear(X, g, None, mode="linear"),
        lambda: ref.fused_linear_ref(X, g, None, mode="linear"),
        lambda: torch.mm(X, g), 4 * (V * K0 + K0 * h + V * h),
        2 * V * K0 * h, matmul_check))
    rows["fused_linear"] = fl

    print("admm_pgrad:", flush=True)
    pg = []
    for name, r, W, shape_in in (
            (f"x{B} [{V},{h}]@[{h},{h}]ᵀ", rand(B, V, h),
             rand(B, h, h, scale=h ** -0.5), (B, V, h)),
            (f"[{V},{C}]@[{h},{C}]ᵀ", rand(V, C), rand(h, C, scale=C ** -0.5),
             (V, h))):
        u, p, q = rand(*shape_in), rand(*shape_in).relu(), rand(*shape_in).relu()
        c = u + rho * (p - q)
        lib = ((lambda c=c, r=r, W=W: torch.addmm(c, r, W.mT, alpha=-nu))
               if r.dim() == 2 else
               (lambda c=c, r=r, W=W: torch.baddbmm(c, r, W.mT, alpha=-nu)))
        nb = r.shape[0] if r.dim() == 3 else 1
        Vr, n_out = r.shape[-2:]
        n_in = W.shape[-2]
        pg.append(case(
            name, lambda: admm_pgrad(r, W, u, p, q, nu=nu, rho=rho),
            lambda: ref.admm_pgrad_ref(r, W, u, p, q, nu=nu, rho=rho), lib,
            4 * nb * (Vr * n_out + n_in * n_out + 4 * Vr * n_in),
            nb * (2 * Vr * n_out * n_in + 5 * Vr * n_in), matmul_check))
    rows["admm_pgrad"] = pg

    print("relu_zupdate:", flush=True)
    L1 = len(dims) - 2
    a, q, z0 = rand(L1, V, h), rand(L1, V, h).relu(), rand(L1, V, h)
    n = a.numel()
    rows["relu_zupdate"] = [case(
        f"[{L1},{V},{h}]", lambda: relu_zupdate(a, q, z0),
        lambda: ref.relu_zupdate_ref(a, q, z0), None, 16 * n, 27 * n,
        zupdate_check_for(a, q, z0))]

    print("fista_zlast:", flush=True)
    a, z0 = rand(V, C, scale=3.0), rand(V, C, scale=3.0)
    mask = ds.masks["train"]
    n_iters = 15
    steps = len(momentum_schedule(n_iters))
    rows["fista_zlast"] = [case(
        f"[{V},{C}] x{steps} steps",
        lambda: fista_zlast(a, z0, ds.labels, mask, nu=nu, n_iters=n_iters,
                            n_classes=C),
        lambda: ref.fista_zlast_ref(a, z0, ds.labels, mask, nu=nu,
                                    n_iters=n_iters),
        None, 4 * (3 * V * C + 2 * V), steps * V * (12 * C + 4 * C),
        fista_check)]

    print("backtrack_resnorm:", flush=True)
    bt = []
    half = (torch.arange(B, device=dev) % 2).to(torch.int32)
    for name, r0, d, W, active in (
            (f"x{B} [{V},{h}]@[{h},{h}], all active", rand(B, V, h),
             rand(B, V, h, scale=0.05), rand(B, h, h, scale=h ** -0.5), None),
            (f"x{B} [{V},{h}]@[{h},{h}], {int(half.sum())} active",
             rand(B, V, h), rand(B, V, h, scale=0.05),
             rand(B, h, h, scale=h ** -0.5), half),
            (f"[{V},{h}]@[{h},{C}]", rand(V, C), rand(V, h, scale=0.05),
             rand(h, C, scale=h ** -0.5), None)):
        lib = ((lambda r0=r0, d=d, W=W: torch.addmm(r0, d, W, alpha=-1))
               if d.dim() == 2 else
               (lambda r0=r0, d=d, W=W: torch.baddbmm(r0, d, W, alpha=-1)))
        nb = d.shape[0] if d.dim() == 3 else 1
        n_act = nb if active is None else int(active.sum())
        M, K = d.shape[-2:]
        N = W.shape[-1]
        bt.append(case(
            name, lambda r0=r0, d=d, W=W, a=active: backtrack_resnorm(r0, d, W, a),
            lambda r0=r0, d=d, W=W, a=active: ref.backtrack_resnorm_ref(r0, d, W, a),
            lib, 4 * (n_act * (M * N + M * K + K * N) + nb),
            n_act * (2 * M * K * N + 3 * M * N), resnorm_check))
    rows["backtrack_resnorm"] = bt

    def grid_input(*shape):
        # the p-update's candidates: mostly inside [lo, hi], some clipped
        return (torch.rand(shape, generator=gen, device=dev) * 9.0 - 2.5
                + rand(*shape, scale=0.01))

    print("grid_project:", flush=True)
    gp = []
    for shape in ((B, V, h), (V, h)):
        x = grid_input(*shape)
        n = x.numel()
        gp.append(case(
            "[" + ",".join(map(str, shape)) + "]",
            lambda x=x: qk.grid_project(x, grid),
            lambda x=x: ref.grid_project_ref(x, grid), None, 8 * n, 5 * n,
            bitwise_check))
    rows["grid_project"] = gp

    print("grid_encode / grid_decode:", flush=True)
    from repro_torch.core.quantize import uniform_grid
    enc, dec = [], []
    for bits in (8, 16):
        g = uniform_grid(bits, grid.lo, grid.hi)
        x = grid_input(V, h)
        n = x.numel()
        codes = ref.grid_encode_ref(x, g)
        cb = codes.element_size()
        enc.append(case(
            f"[{V},{h}] {bits}-bit", lambda x=x, g=g: qk.grid_encode(x, g),
            lambda x=x, g=g: ref.grid_encode_ref(x, g), None, (4 + cb) * n,
            4 * n, bitwise_check))
        dec.append(case(
            f"[{V},{h}] {bits}-bit", lambda c=codes, g=g: qk.grid_decode(c, g),
            lambda c=codes, g=g: ref.grid_decode_ref(c, g), None,
            (4 + cb) * n, 2 * n, bitwise_check))
    rows["grid_encode"], rows["grid_decode"] = enc, dec
    return rows


def p_trials(tau_prev, tau_new):
    """Backtracking trials per p-update that ran the resnorm on this layer:
    τ = τ0·2^j with τ0 = τ_prev·decay + 1e-6 in f32 (the driver's warm
    start), and the trial that passed ran too, so min(j + 1, 12)."""
    t0 = np.float32(np.float32(tau_prev) * np.float32(0.5) + np.float32(1e-6))
    j = int(round(math.log2(float(np.float32(tau_new) / t0))))
    return min(j + 1, MAX_DOUBLINGS)


def accept_margin(state, args, cfg, layer: int, t: float) -> float:
    """(φ(x⁺) − U − 1e-6|U|) / |U| for ``layer``'s p-update at trial τ = t,
    in f64 with plain tensor code: where it is near 0 the accept test is
    on its 1e-6 slack and two correct sums may decide either way."""
    from repro_torch.core import subproblems as sp
    f = [x.double() for x in (state.p[layer], state.W[layer], state.b[layer],
                              state.z[layer], state.q[layer - 1],
                              state.u[layer - 1])]
    p, W, b, z, qp, up = f
    nu, rho = cfg.nu, cfg.rho
    g = sp.grad_p(p, W, b, z, qp, up, nu, rho)
    phi0 = sp.phi(p, W, b, z, qp, up, nu, rho)
    x = cfg.grid.project((p - g / t).float()).double()
    d = x - p
    u_val = phi0 + sp._dot(g, d) + 0.5 * t * sp._dot(d, d)
    phi_x = sp.phi(x, W, b, z, qp, up, nu, rho)
    return float((phi_x - u_val - 1e-6 * u_val.abs()) / u_val.abs())


def train_run(X, ds, dims, cfg, epochs):
    """``pdadmm.train`` from seed 0; for G-Q with a per-epoch callback that
    keeps τ (the G run keeps the chunked driver, one host sync per run).
    Returns (state, history, τ per iteration [epochs][L] or [], seconds)."""
    from repro_torch.core import pdadmm
    taus = []
    keep_tau = None
    if cfg.quantize_p:
        def keep_tau(e, s, m):
            taus.append([float(t) for t in s.tau])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = pdadmm.train(0, X, ds.labels, ds.masks, dims, cfg, epochs,
                               device=X.device, callback=keep_tau)
    torch.cuda.synchronize()
    return state, hist, taus, time.perf_counter() - t0


def ms_per_iter(X, ds, config, state, n=5, **kw):
    from repro_torch.core import pdadmm
    args = (X, ds.labels, ds.masks["train"])
    state, _ = pdadmm.iterate(state, *args, config, **kw)      # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        state, m = pdadmm.iterate(state, *args, config, **kw)
    float(m["objective"])
    return (time.perf_counter() - t) / n * 1e3


def stepwise_check(X, ds, dims, cfg, epochs):
    """Both paths from one shared state (the kernel path's), one iteration
    at a time: the objective at rtol 1e-3 wherever τ agree on every layer;
    each τ flip printed with its accept-test margin."""
    from repro_torch.core import pdadmm
    args = (X, ds.labels, ds.masks["train"])
    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    s = pdadmm.init_state(0, X, dims, cfg, device=X.device)
    flips, held = [], 0
    for it in range(epochs):
        sk, mk = pdadmm.iterate(s, *args, cfg)
        sp_, mp = pdadmm.iterate(s, *args, cfg_plain)
        tk = [float(t) for t in sk.tau]
        tp = [float(t) for t in sp_.tau]
        ok, op = float(mk["objective"]), float(mp["objective"])
        differ = [l for l in range(1, len(tk)) if tk[l] != tp[l]]
        for l in differ:
            margin = accept_margin(s, args, cfg, l, min(tk[l], tp[l]))
            flips.append({"iteration": it, "layer": l, "tau_kernels": tk[l],
                          "tau_plain": tp[l], "margin": margin})
            print(f"  τ flip: iteration {it} layer {l}: kernels {tk[l]:.6g} "
                  f"plain {tp[l]:.6g}; (φ−U−slack)/|U| at the smaller τ "
                  f"{margin:.3e}", flush=True)
        if not math.isfinite(ok) or not math.isfinite(op):
            raise AssertionError(f"objective not finite at {it}: {ok}, {op}")
        if not differ:
            np.testing.assert_allclose(ok, op, rtol=TRAJ_RTOL)
            held += 1
        s = sk
    return {"flips": flips, "iterations_held": held}


def train_phase(X, ds, dims, cfg, epochs, required, label):
    """Train ``epochs`` iterations through the kernels with every launch
    count set to 0 just before, and again on the plain path; check the
    launches of ``required``, finiteness and the trajectory."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    state, hist, taus, t_train = train_run(X, ds, dims, cfg, epochs)
    counts = ops.launch_counts()
    print(f"{label}: {epochs} iterations in {t_train:.3f} s, launches "
          f"{counts}", flush=True)
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: "
                             f"{missing}")
    obj = np.asarray(hist["objective"])
    if obj.shape != (epochs,) or not np.all(np.isfinite(obj)):
        raise AssertionError(f"{label}: objective not finite: {obj}")

    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    _, hist_plain, taus_plain, _ = train_run(X, ds, dims, cfg_plain, epochs)
    obj_plain = np.asarray(hist_plain["objective"])
    print(f"  objective kernels {obj.tolist()}", flush=True)
    print(f"  objective plain   {obj_plain.tolist()}", flush=True)
    run = {"launches": counts, "objective": obj.tolist(),
           "objective_plain": obj_plain.tolist(),
           "test_acc": hist["test_acc"][-1], "val_acc": hist["val_acc"][-1],
           "test_acc_plain": hist_plain["test_acc"][-1], "train_s": t_train}
    if cfg.quantize_p:
        L = len(dims) - 1
        tau0 = [cfg.tau0] * L
        trials = [[p_trials(prev[l], cur[l]) for l in range(1, L)]
                  for prev, cur in zip([tau0] + taus[:-1], taus)]
        differ = [(it, l) for it in range(epochs) for l in range(1, L)
                  if taus[it][l] != taus_plain[it][l]]
        for it in range(epochs):
            print(f"  iteration {it}: τ kernels {taus[it][1:]}", flush=True)
            print(f"               τ plain   {taus_plain[it][1:]}")
            print(f"               active trials per p-update (layers 1.."
                  f"{L - 1}) {trials[it]}")
        print(f"  τ differs between the paths at {len(differ)} of "
              f"{epochs * (L - 1)} (iteration, layer): {differ}", flush=True)
        run.update(tau=taus, tau_plain=taus_plain, active_trials=trials,
                   tau_differs=differ)
    try:
        np.testing.assert_allclose(obj, obj_plain, rtol=TRAJ_RTOL)
        run["trajectory_check"] = f"rtol {TRAJ_RTOL} over {epochs} iterations"
    except AssertionError:
        if not run.get("tau_differs"):
            raise
        print(f"  the trajectories part beyond rtol {TRAJ_RTOL} after a τ "
              f"flip; holding both paths from one shared state instead",
              flush=True)
        run["stepwise"] = stepwise_check(X, ds, dims, cfg, epochs)
        run["trajectory_check"] = "stepwise from shared states"
    run["ms_per_iter"] = ms_per_iter(X, ds, cfg, state)
    run["ms_per_iter_plain"] = ms_per_iter(X, ds, cfg_plain, state)
    return state, run


def wire_phase(X, ds, cfg, state, n_iters: int = 2):
    """G-Q iterations with 8-bit grid codecs on every dual's wire, from
    ``state``; grid_encode and grid_decode must launch."""
    from repro_torch.comm.codecs import GridCodec
    from repro_torch.core import pdadmm
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.kernels import ops

    codecs = (GridCodec(uniform_grid(8, -1.0, 1.0)),) * (len(state.u))
    args = (X, ds.labels, ds.masks["train"])
    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    ops.reset_launch_counts()
    s, objs = state, []
    for _ in range(n_iters):
        s, m = pdadmm.iterate(s, *args, cfg, u_codecs=codecs)
        objs.append(float(m["objective"]))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"u wire (8-bit grid codecs): {n_iters} iterations, launches "
          f"{counts}, objective {objs}", flush=True)
    missing = [k for k in WIRE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"u wire: kernels never launched: {missing}")
    if not all(math.isfinite(o) for o in objs):
        raise AssertionError(f"u wire: objective not finite: {objs}")
    _, m_plain = pdadmm.iterate(state, *args, cfg_plain, u_codecs=codecs)
    _, m_kern = pdadmm.iterate(state, *args, cfg, u_codecs=codecs)
    np.testing.assert_allclose(float(m_kern["objective"]),
                               float(m_plain["objective"]), rtol=TRAJ_RTOL)
    return {"launches": counts, "objective": objs, "iterations": n_iters,
            "ms_per_iter": ms_per_iter(X, ds, cfg, state, n=3,
                                       u_codecs=codecs)}


def profile_phase(X, ds, cfg, state, ms_per_iter: float, top: int = 12):
    """Device time by kernel over one kernel-path iteration (torch.profiler),
    and the device's idle share of an unprofiled iteration
    (1 − busy / ``ms_per_iter``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import pdadmm

    args = (X, ds.labels, ds.masks["train"])
    state, _ = pdadmm.iterate(state, *args, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = pdadmm.iterate(state, *args, cfg)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [{"name": ev.key[:90], "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    launches = sum(r["calls"] for r in rows)
    print(f"profile (one kernel-path iteration): device busy {busy:.3f} ms "
          f"in {launches} launches; idle share of a {ms_per_iter:.3f} ms "
          f"iteration {1.0 - busy / ms_per_iter:.3f}", flush=True)
    for r in rows[:top]:
        print(f"  {r['device_ms']:8.3f} ms  x{r['calls']:<4d} {r['name']}")
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"device_busy_ms": busy, "device_launches": launches,
            "idle_share": 1.0 - busy / ms_per_iter, "kernels": rows[:top]}


def wire_bytes(dims, V: int, grid) -> dict:
    """Bytes per iteration on the layer links (the Fig-5 model, from the
    port's ledger) for G, G-Q, and G-Q with 8-bit u codecs."""
    from repro_torch.comm.codecs import GridCodec, codec_for_grid
    from repro_torch.comm.ledger import admm_bytes_per_iteration
    from repro_torch.core.quantize import uniform_grid
    fp32, gq = codec_for_grid(None), codec_for_grid(grid)
    out = {"G": admm_bytes_per_iteration(dims, V, fp32, fp32),
           "GQ": admm_bytes_per_iteration(dims, V, gq, gq),
           "GQ_u_wire": admm_bytes_per_iteration(
               dims, V, gq, gq, GridCodec(uniform_grid(8, -1.0, 1.0)))}
    print(f"wire bytes per iteration (ledger): {out}; G-Q saves "
          f"{1 - out['GQ'] / out['G']:.4f}, with the u wire "
          f"{1 - out['GQ_u_wire'] / out['G']:.4f}", flush=True)
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1

    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.graph.datasets import synthetic
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    t_build = time.perf_counter() - t0
    print(f"build: {lib_path} in {t_build:.1f} s", flush=True)
    log = (lib_path.parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())

    device = torch.device("cuda")
    ds = synthetic("cora", scale=1.0, device=device)
    X = ds.augmented(4)
    dims = [X.shape[1]] + [1000] * 9 + [ds.n_classes]
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    cfg_q = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                       grid=uniform_grid(8, -2.0, 6.0))
    print(f"cora: V={X.shape[0]} X={tuple(X.shape)} dims={dims}", flush=True)

    rows = kernel_phase(X, ds, dims, cfg.nu, cfg.rho, cfg_q.grid)
    runs = {}
    state, runs["G"] = train_phase(X, ds, dims, cfg, EPOCHS, BASE_KERNELS,
                                   "pdADMM-G")
    runs["G"]["profile"] = profile_phase(X, ds, cfg, state,
                                         runs["G"]["ms_per_iter"])
    state_q, runs["GQ"] = train_phase(X, ds, dims, cfg_q, EPOCHS, GQ_KERNELS,
                                      "pdADMM-G-Q")
    runs["GQ"]["profile"] = profile_phase(X, ds, cfg_q, state_q,
                                          runs["GQ"]["ms_per_iter"])
    runs["GQ_u_wire"] = wire_phase(X, ds, cfg_q, state_q)
    runs["wire_bytes_per_iter"] = wire_bytes(dims, X.shape[0], cfg_q.grid)
    for key in ("G", "GQ"):
        r = runs[key]
        print(f"{key}: ms per iteration: kernels {r['ms_per_iter']:.3f}  "
              f"plain {r['ms_per_iter_plain']:.3f}; test accuracy "
              f"{r['test_acc']:.4f} (plain {r['test_acc_plain']:.4f})",
              flush=True)

    # each kernel's launches come from the run whose path needs it
    run_of = dict.fromkeys(BASE_KERNELS, "G")
    run_of.update(backtrack_resnorm="GQ", grid_project="GQ",
                  grid_encode="GQ_u_wire", grid_decode="GQ_u_wire")
    kernels = []
    for name, cases in rows.items():
        head = cases[0]
        run = runs[run_of[name]]
        n_iter = run.get("iterations", EPOCHS)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": run["launches"][name],
            "launches_run": run_of[name],
            "launches_per_iter": run["launches"][name] / n_iter,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "cases": cases})
    card = card_line()
    record = {"card": card, "build_s": t_build, "kernels": kernels,
              "train": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is not finite")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
