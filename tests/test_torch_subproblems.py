"""The port's subproblem solvers against the JAX reference, in f64.

Shapes, grids and hyper-parameters are those of tests/test_fastpath.py.
In f64 the scalar backtracking engines of both packages take the same
decisions, so τ and θ are asserted bit for bit; iterates at rtol 1e-10 (the
reductions run in another order). Inputs are made with numpy from a seed
and handed to both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core import subproblems as jsp
from repro_torch.core import quantize as tq
from repro_torch.core import subproblems as tsp

HYPERS = [(0.01, 1.0, 1e-3), (1.0, 0.1, 1.0), (0.5, 2.0, 1e-2), (1e-3, 1e-3, 1.0)]
SHAPES = [(16, 8, 9), (32, 24, 8), (7, 5, 11)]
TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _problem(seed, V, ni, no):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(V, ni)), rng.normal(size=(ni, no)),
            rng.normal(size=(no,)), rng.normal(size=(V, no)),
            rng.normal(size=(V, ni)), rng.normal(size=(V, ni)) * 0.1]


def _j(arrays):
    return [jnp.asarray(a, jnp.float64) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def _same_f32(a, b):
    assert np.float32(a).tobytes() == np.float32(b).tobytes(), (a, b)


@pytest.mark.parametrize("V,ni,no", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_p_matches_jax(x64, V, ni, no, seed):
    prob = _problem(seed, V, ni, no)
    for nu, rho, t0 in HYPERS:
        pj, tj, rj = jsp.update_p(*_j(prob), nu, rho, t0)
        pt, tt, rt = tsp.update_p(*_t(prob), nu, rho, t0)
        assert tt.dtype == torch.float32
        _same_f32(float(tj), float(tt))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)


@pytest.mark.parametrize("V,ni,no", SHAPES[:2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_W_matches_jax(x64, V, ni, no, seed):
    prob = _problem(seed, V, ni, no)
    for nu, rho, t0 in HYPERS:
        for first in (True, False):
            Wj, tj, rj = jsp.update_W(*_j(prob), nu, rho, t0, first=first)
            Wt, tt, rt = tsp.update_W(*_t(prob), nu, rho, t0, first=first)
            _same_f32(float(tj), float(tt))
            np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)


def test_forced_doublings_match_jax(x64):
    """τ0 far too small: the search really doubles, and stops at 12."""
    prob = _problem(11, 24, 16, 12)
    prob[1] = prob[1] * 40.0
    for t0 in (1e-6, 1e-4, 1e-9):
        pj, tj, _ = jsp.update_p(*_j(prob), 1.0, 1.0, t0)
        pt, tt, _ = tsp.update_p(*_t(prob), 1.0, 1.0, t0)
        _same_f32(float(tj), float(tt))
        assert float(tt) > 2.0 * t0
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    # the cap: at most 12 doublings, as the reference's while_loop
    _, tt, _ = tsp.update_p(*_t(prob), 1.0, 1.0, 1e-9)
    assert float(tt) == float(np.float32(1e-9) * 2 ** 12)


def test_batched_solves_equal_per_layer_solves():
    """The leading layer axis stands in for jax.vmap: one batched call gives
    what the per-layer calls give, τ included."""
    probs = [_problem(s, 16, 8, 8) for s in (0, 1, 2)]
    stacked = [torch.stack(x) for x in zip(*(_t(p) for p in probs))]
    t0 = torch.tensor([1e-3, 1.0, 1e-2], dtype=torch.float64)
    pb, tb, rb = tsp.update_p(*stacked, 0.5, 2.0, t0)
    Wb, thb, rWb = tsp.update_W(*stacked, 0.5, 2.0, t0, first=False)
    for i, prob in enumerate(probs):
        pi, ti, ri = tsp.update_p(*_t(prob), 0.5, 2.0, t0[i])
        Wi, thi, rWi = tsp.update_W(*_t(prob), 0.5, 2.0, t0[i], first=False)
        assert float(tb[i]) == float(ti) and float(thb[i]) == float(thi)
        for got, want in ((pb[i], pi), (rb[i], ri), (Wb[i], Wi),
                          (rWb[i], rWi)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-14)


GRIDS = [("u8", lambda m: m.uniform_grid(8, -2.0, 2.0)),
         ("int", lambda m: m.integer_grid())]


@pytest.mark.parametrize("name,make", GRIDS, ids=[g[0] for g in GRIDS])
@pytest.mark.parametrize("V,ni,no", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projected_update_p_matches_jitted_jax(x64, V, ni, no, seed, name,
                                               make):
    """pdADMM-G-Q's p-update: the port's 12 sync-free trials against the
    reference's jitted while_loop, τ bit for bit."""
    prob = _problem(seed, V, ni, no)
    gj, gt = make(jq), make(tq)
    for nu, rho, t0 in HYPERS:
        step = jax.jit(functools.partial(jsp.update_p, nu=nu, rho=rho,
                                         tau0=t0, grid=gj))
        pj, tj, rj = step(*_j(prob))
        pt, tt, rt = tsp.update_p(*_t(prob), nu, rho, t0, grid=gt)
        assert tt.dtype == torch.float32
        _same_f32(float(tj), float(tt))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
        # the chained residual is z - p⁺W - b
        p_, W, b, z = _t(prob)[:4]
        np.testing.assert_allclose(rt.numpy(), (z - pt @ W - b).numpy(),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name,make", GRIDS, ids=[g[0] for g in GRIDS])
@pytest.mark.parametrize("V,ni,no", SHAPES)
def test_projected_update_p_matches_its_naive_engine(V, ni, no, name, make):
    """Inside the port: the delta-residual trials against update_p_reference
    (fresh φ per trial), and both against the reference's naive engine."""
    grid = make(tq)
    for seed in (0, 3):
        prob = _problem(seed, V, ni, no)
        for nu, rho, t0 in HYPERS:
            pf, tf, _ = tsp.update_p(*_t(prob), nu, rho, t0, grid=grid)
            pr, tr = tsp.update_p_reference(*_t(prob), nu, rho, t0,
                                            grid=grid)
            assert float(tf) == float(tr), (seed, nu, rho, t0)
            np.testing.assert_allclose(pf.numpy(), pr.numpy(), atol=1e-9)


def test_reference_solvers_match_jax(x64):
    prob = _problem(4, 16, 8, 9)
    for nu, rho, t0 in HYPERS:
        for name, make in GRIDS + [("none", lambda m: None)]:
            pj, tj = jsp.update_p_reference(*_j(prob), nu, rho, t0,
                                            grid=make(jq))
            pt, tt = tsp.update_p_reference(*_t(prob), nu, rho, t0,
                                            grid=make(tq))
            _same_f32(float(tj), float(tt))
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        for first in (True, False):
            Wj, thj = jsp.update_W_reference(*_j(prob), nu, rho, t0,
                                             first=first)
            Wt, tht = tsp.update_W_reference(*_t(prob), nu, rho, t0,
                                             first=first)
            _same_f32(float(thj), float(tht))
            np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)


def test_projected_batched_solve_equals_per_layer_solves():
    probs = [_problem(s, 16, 8, 8) for s in (0, 1, 2)]
    stacked = [torch.stack(x) for x in zip(*(_t(p) for p in probs))]
    t0 = torch.tensor([1e-3, 1.0, 1e-2], dtype=torch.float64)
    grid = tq.uniform_grid(8, -2.0, 2.0)
    pb, tb, rb = tsp.update_p(*stacked, 0.5, 2.0, t0, grid=grid)
    for i, prob in enumerate(probs):
        pi, ti, ri = tsp.update_p(*_t(prob), 0.5, 2.0, t0[i], grid=grid)
        assert float(tb[i]) == float(ti)
        np.testing.assert_allclose(pb[i].numpy(), pi.numpy(), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(rb[i].numpy(), ri.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_projected_update_p_through_the_kernel_dispatch():
    """use_kernels=True on the CPU goes through ops (plain versions, f32)
    and takes the same steps as the plain tensor code."""
    prob = [a.astype(np.float32) for a in _problem(5, 32, 16, 16)]
    grid = tq.uniform_grid(8, -2.0, 2.0)
    for nu, rho, t0 in HYPERS:
        pk, tk, rk = tsp.update_p(*_t(prob), nu, rho, t0, grid=grid,
                                  use_kernels=True)
        pp, tp, rp = tsp.update_p(*_t(prob), nu, rho, t0, grid=grid)
        assert float(tk) == float(tp)
        np.testing.assert_allclose(pk.numpy(), pp.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rk.numpy(), rp.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("n_classes", [None, 4])
@pytest.mark.parametrize("n_iters", [0, 15])
def test_update_z_last_matches_jax(x64, n_classes, n_iters):
    rng = np.random.default_rng(2)
    V, C = 40, 6
    a, z0 = rng.normal(size=(V, C)) * 2, rng.normal(size=(V, C))
    labels = rng.integers(0, n_classes or C, V).astype(np.int32)
    mask = (rng.random(V) < 0.5).astype(np.float32)
    zj = jsp.update_z_last(*_j([a, z0]), jnp.asarray(labels),
                           jnp.asarray(mask), 0.01, n_iters, n_classes,
                           use_kernels=False)
    zt = tsp.update_z_last(*_t([a, z0]), torch.from_numpy(labels),
                           torch.from_numpy(mask), 0.01, n_iters, n_classes,
                           use_kernels=False)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)


@pytest.mark.parametrize("n_iters", [0, 15])
def test_update_z_last_reference_matches_jax(x64, n_iters):
    rng = np.random.default_rng(3)
    V, C = 40, 6
    a, z0 = rng.normal(size=(V, C)) * 2, rng.normal(size=(V, C))
    labels = rng.integers(0, C, V).astype(np.int32)
    mask = (rng.random(V) < 0.5).astype(np.float32)
    zj = jsp.update_z_last_reference(*_j([a, z0]), jnp.asarray(labels),
                                     jnp.asarray(mask), 0.01, n_iters)
    zt = tsp.update_z_last_reference(*_t([a, z0]), torch.from_numpy(labels),
                                     torch.from_numpy(mask), 0.01, n_iters)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)


def test_ce_value_grad_matches_jax(x64):
    rng = np.random.default_rng(4)
    z = rng.normal(size=(30, 5)) * 3
    labels = rng.integers(0, 5, 30).astype(np.int32)
    mask = (rng.random(30) < 0.5).astype(np.float32)
    vj, gj = jsp.ce_value_grad(jnp.asarray(z), jnp.asarray(labels),
                               jnp.asarray(mask))
    vt, gt = tsp.ce_value_grad(torch.from_numpy(z), torch.from_numpy(labels),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)


@pytest.mark.parametrize("grid", ["none", "int", "u8"])
def test_update_q_and_u_match_jax(x64, grid):
    make = {"none": lambda m: None, "int": lambda m: m.integer_grid(),
            "u8": lambda m: m.uniform_grid(8, -2.0, 6.0)}[grid]
    rng = np.random.default_rng(5)
    pn, u, fz = (rng.normal(size=(20, 9)) * 3 for _ in range(3))
    qj = jsp.update_q(*_j([pn, u, fz]), 0.01, 1.0, grid=make(jq))
    qt = tsp.update_q(*_t([pn, u, fz]), 0.01, 1.0, grid=make(tq))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
    uj, rj = jsp.update_u(*_j([u, pn]), qj, 1.0)
    ut, rt = tsp.update_u(*_t([u, pn]), qt, 1.0)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)


def test_update_z_hidden_and_update_b_match_jax(x64):
    rng = np.random.default_rng(6)
    a, q, z0 = (rng.normal(size=(25, 7)) for _ in range(3))
    np.testing.assert_array_equal(
        tsp.update_z_hidden(*_t([a, q, z0]), 0.01).numpy(),
        np.asarray(jsp.update_z_hidden(*_j([a, q, z0]), 0.01)))
    p, W, z = rng.normal(size=(25, 4)), rng.normal(size=(4, 7)), a
    np.testing.assert_allclose(tsp.update_b(*_t([p, W, z])).numpy(),
                               np.asarray(jsp.update_b(*_j([p, W, z]))), **TOL)


def test_phi_and_gradients_match_jax(x64):
    p, W, b, z, qp, up = _problem(7, 16, 8, 9)
    j, t = _j([p, W, b, z, qp, up]), _t([p, W, b, z, qp, up])
    for nu, rho, _ in HYPERS:
        np.testing.assert_allclose(float(tsp.phi(*t, nu, rho)),
                                   float(jsp.phi(*j, nu, rho)), rtol=1e-12)
        np.testing.assert_allclose(float(tsp.phi_first(*t[:4], nu)),
                                   float(jsp.phi_first(*j[:4], nu)), rtol=1e-12)
        np.testing.assert_allclose(tsp.grad_p(*t, nu, rho).numpy(),
                                   np.asarray(jsp.grad_p(*j, nu, rho)), **TOL)
        np.testing.assert_allclose(tsp.grad_W(*t[:4], nu).numpy(),
                                   np.asarray(jsp.grad_W(*j[:4], nu)), **TOL)
