#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Run from the repository root on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Phases, in order; any failure raises
and the script exits non-zero without printing a result:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of pdADMM-G on cora with the paper's 10×1000 GA-MLP, and time the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``; the port never calls it).
3. Train pdADMM-G on cora at 10×1000 for a few iterations through
   ``repro_torch.core.pdadmm.train`` with every launch counter set to 0
   just before; every kernel must have launched, the objective must be
   finite and must track the same run with ``use_kernels=False`` on the card
   at rtol 1e-3. Then time a few steady-state iterations of both paths,
   and trace one kernel-path iteration with torch.profiler (device time by
   kernel, the device's idle share).
4. Print the card (``nvidia-smi``), one JSON line with every kernel's
   numbers, and last the device line.

Tolerances (f32 on both sides, sums in another order): matmul kernels
max|kernel − plain| ≤ 1e-5·max|plain|; fista_zlast atol 1e-5 + rtol 1e-5
(expf against torch's exp, ulps over 16 steps); relu_zupdate within
1e-6 relative (IEEE /3 in the kernel, a reciprocal multiply in PyTorch's
CUDA division by a scalar), and where the two branch objectives tie to
1e-5, equal objective values.
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
FISTA_ATOL = 1e-5
FISTA_RTOL = 1e-5
EPOCHS = 5          # iterations of the main-path run (the reference trains 200)


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
    err = float((got - want).abs().max())
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


def kernel_phase(X, ds, dims, nu, rho):
    from repro_torch.kernels import ref
    from repro_torch.kernels.admm_pgrad import admm_pgrad
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
    return rows


def train_phase(X, ds, dims, cfg, epochs):
    from repro_torch.core import pdadmm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = pdadmm.train(0, X, ds.labels, ds.masks, dims, cfg, epochs,
                               device=X.device)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"main path: {epochs} iterations in {t_train:.3f} s, launches "
          f"{counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    obj = np.asarray(hist["objective"])
    if obj.shape != (epochs,) or not np.all(np.isfinite(obj)):
        raise AssertionError(f"objective not finite: {obj}")

    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    _, hist_plain = pdadmm.train(0, X, ds.labels, ds.masks, dims, cfg_plain,
                                 epochs, device=X.device)
    obj_plain = np.asarray(hist_plain["objective"])
    print(f"objective kernels {obj.tolist()}", flush=True)
    print(f"objective plain   {obj_plain.tolist()}", flush=True)
    np.testing.assert_allclose(obj, obj_plain, rtol=1e-3)

    def ms_per_iter(config, state, n=5):
        args = (X, ds.labels, ds.masks["train"])
        state, _ = pdadmm.iterate(state, *args, config)      # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            state, m = pdadmm.iterate(state, *args, config)
        float(m["objective"])
        return (time.perf_counter() - t) / n * 1e3

    return state, {
        "launches": counts, "objective": obj.tolist(),
        "objective_plain": obj_plain.tolist(),
        "test_acc": hist["test_acc"][-1], "val_acc": hist["val_acc"][-1],
        "test_acc_plain": hist_plain["test_acc"][-1],
        "train_s": t_train,
        "ms_per_iter": ms_per_iter(cfg, state),
        "ms_per_iter_plain": ms_per_iter(cfg_plain, state),
    }


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
    print(f"cora: V={X.shape[0]} X={tuple(X.shape)} dims={dims}", flush=True)

    rows = kernel_phase(X, ds, dims, cfg.nu, cfg.rho)
    state, run = train_phase(X, ds, dims, cfg, EPOCHS)
    run["profile"] = profile_phase(X, ds, cfg, state, run["ms_per_iter"])
    print(f"ms per iteration: kernels {run['ms_per_iter']:.3f}  plain "
          f"{run['ms_per_iter_plain']:.3f}; test accuracy {run['test_acc']:.4f}"
          f" (plain {run['test_acc_plain']:.4f})", flush=True)

    sources = {"fused_linear": "src/repro_torch/kernels/csrc/fused_linear.cu",
               "admm_pgrad": "src/repro_torch/kernels/csrc/admm_pgrad.cu",
               "relu_zupdate": "src/repro_torch/kernels/csrc/relu_zupdate.cu",
               "fista_zlast": "src/repro_torch/kernels/csrc/fista_zlast.cu"}
    replaces = {"fused_linear": "src/repro/kernels/fused_linear.py:40",
                "admm_pgrad": "src/repro/kernels/admm_pgrad.py:18",
                "relu_zupdate": "src/repro/kernels/relu_zupdate.py:28",
                "fista_zlast": "src/repro/kernels/fista_zlast.py:88"}
    kernels = []
    for name, cases in rows.items():
        head = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": run["launches"][name],
            "launches_per_iter": run["launches"][name] / EPOCHS,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "cases": cases})
    card = card_line()
    record = {"card": card, "build_s": t_build, "kernels": kernels,
              "train": run}
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
