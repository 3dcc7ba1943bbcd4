"""The port's greedy layerwise training against the JAX reference.

The reference draws its initial state and the inserted layers' noise with
``jax.random``; the port cannot, so each comparison hands them over: the
state through ``core.interop.state_from_numpy``, the noise as the arrays
the reference's ``_grow`` draws from its key.

* ``grow`` alone in f64 (the reference under the ``x64`` fixture), from a
  state two iterations past ``init_state``, for pdADMM-G and for
  pdADMM-G-Q (p on the paper's Δ = {-1, ..., 20}): every family at rtol
  1e-10, fresh τ and θ per layer, and p[l+1] and q[l] one tensor with
  ``quantize_p``.
* ``greedy_train`` in f32 on ``synthetic("citeseer", scale=0.03)`` with the
  schedule (2, 3, 4) (a per-layer stage, then the layer-stacked path):
  the objective tracks the live reference at rtol 1e-3, ``stage_layers``
  is equal and each stage's test accuracy is within 1/|test|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import greedy as jgr
from repro.core import pdadmm as jpd
from repro.core import quantize as jq
from repro.graph import datasets as jd
from repro_torch.core import greedy as tgr
from repro_torch.core import pdadmm as tpd
from repro_torch.core import quantize as tq
from repro_torch.core.interop import state_from_numpy


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _leaves(state):
    return [[np.asarray(x) for x in fam] for fam in state]


def _ref_noise(key, n_insert, h):
    """The inserted layers' noise as the reference's ``_grow`` draws it."""
    keys = jax.random.split(key, max(n_insert, 1))
    return [np.array(jax.random.normal(keys[i], (h, h), jnp.float32))
            for i in range(n_insert)]


def _configs(quantized, **kw):
    if not quantized:
        return jpd.ADMMConfig(**kw), tpd.ADMMConfig(**kw)
    return (jpd.ADMMConfig(quantize_p=True, grid=jq.integer_grid(-1, 20), **kw),
            tpd.ADMMConfig(quantize_p=True, grid=tq.integer_grid(-1, 20), **kw))


@pytest.mark.parametrize("quantized", [False, True], ids=["G", "GQ"])
def test_grow_f64_matches_jax(x64, quantized):
    dsj = jd.tiny()
    X = dsj.augmented(2).astype(jnp.float64)
    h, C = 16, dsj.n_classes
    cfg_j, cfg_t = _configs(quantized, use_kernels=False)
    dims_old = [X.shape[1], h, C]
    dims_new = [X.shape[1], h, h, h, C]
    s = jpd.init_state(jax.random.PRNGKey(0), X, dims_old, cfg_j)
    s = jpd.ADMMState(*[[x.astype(jnp.float64) for x in fam] for fam in s])
    step = jax.jit(functools.partial(jpd.iterate, config=cfg_j))
    for _ in range(2):
        s, _ = step(s, X, dsj.labels, dsj.masks["train"])
    key = jax.random.PRNGKey(5)
    grown_j = jgr._grow(key, s, X, dims_new, cfg_j)

    st = state_from_numpy(_leaves(s), device="cpu", dtype=torch.float64)
    Xt = torch.from_numpy(np.array(X))
    grown_t = tgr.grow(st, Xt, dims_new, cfg_t, _ref_noise(key, 2, h))
    for fam in ("p", "W", "b", "z", "q", "u"):
        a, b = getattr(grown_j, fam), getattr(grown_t, fam)
        assert len(a) == len(b), fam
        for i, (x, y) in enumerate(zip(a, b)):
            assert y.dtype == torch.float64, (fam, i)
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-10,
                                       atol=1e-13, err_msg=f"{fam}[{i}]")
    assert [float(t) for t in grown_t.tau] == [float(t) for t in grown_j.tau]
    assert len({id(t) for t in grown_t.tau + grown_t.theta}) == 8
    assert all(t.dtype == torch.float32 for t in grown_t.tau + grown_t.theta)
    shared = [grown_t.p[l + 1] is grown_t.q[l] for l in range(3)]
    assert all(shared)      # p and q share one tensor, as init_state's do
    if quantized:
        for q in grown_t.q:
            assert torch.equal(q, tq.integer_grid(-1, 20).project(q))


def test_grow_refuses_the_wrong_noise_count():
    ds_X = torch.zeros((4, 3))
    cfg = tpd.ADMMConfig(use_kernels=False)
    s = tpd.init_state(0, ds_X, [3, 5, 2], cfg, device="cpu")
    with pytest.raises(ValueError, match="2 layers to insert, 1 noise"):
        tgr.grow(s, ds_X, [3, 5, 5, 5, 2], cfg, [np.zeros((5, 5))])


@pytest.mark.parametrize("quantized", [False, True], ids=["G", "GQ"])
def test_greedy_train_f32_tracks_live_jax(quantized):
    dsj = jd.synthetic("citeseer", seed=0, scale=0.03)
    X = dsj.augmented(2)
    hidden, C, schedule, epochs = 32, dsj.n_classes, (2, 3, 4), 4
    cfg_j, cfg_t = _configs(quantized, nu=1e-2, rho=1.0, use_kernels=False)
    key = jax.random.PRNGKey(0)
    state_j, hj = jgr.greedy_train(key, X, dsj.labels, dsj.masks, hidden, C,
                                   schedule, epochs, cfg_j)

    # the reference's own draws: init_state from k_init, each growth's noise
    # from a fresh split of k_grow
    k_grow, k_init = jax.random.split(key)
    s0 = jpd.init_state(k_init, X, [X.shape[1], hidden, C], cfg_j)
    noise = []
    for L_prev, L in zip(schedule, schedule[1:]):
        k_grow, sub = jax.random.split(k_grow)
        noise.append(_ref_noise(sub, L - L_prev, hidden))
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("X", X), ("labels", dsj.labels))}
    masks = {k: torch.from_numpy(np.array(m)) for k, m in dsj.masks.items()}
    stages = []
    state_t, ht = tgr.greedy_train(
        0, t["X"], t["labels"], masks, hidden, C, schedule, epochs, cfg_t,
        device="cpu", state=state_from_numpy(_leaves(s0), device="cpu"),
        noise=noise, callback=lambda si, s: stages.append((si, len(s.W))))

    assert stages == [(0, 2), (1, 3), (2, 4)]
    assert ht["stage_layers"] == hj["stage_layers"]
    assert len(ht["stage_seconds"]) == len(schedule)
    obj_t = np.asarray(ht["objective"])
    assert obj_t.shape == (len(schedule) * epochs,)
    assert np.all(np.isfinite(obj_t))
    np.testing.assert_allclose(obj_t, hj["objective"], rtol=1e-3)
    n_test = float(np.sum(np.asarray(dsj.masks["test"])))
    for a, b in zip(ht["test_acc"], hj["test_acc"]):
        assert abs(a - b) <= 1.0 / n_test + 1e-7
    assert len(state_t.W) == len(state_j.W) == schedule[-1]


def test_greedy_train_draws_its_noise_from_the_seed():
    ds_X = torch.rand((12, 6), generator=torch.Generator().manual_seed(0))
    labels = torch.arange(12) % 3
    masks = {k: torch.ones(12) for k in ("train", "val", "test")}
    cfg = tpd.ADMMConfig(use_kernels=False)
    runs = [tgr.greedy_train(7, ds_X, labels, masks, 5, 3, (2, 4), 2, cfg,
                             device="cpu") for _ in range(2)]
    (sa, ha), (sb, hb) = runs
    assert ha["objective"] == hb["objective"]
    assert all(torch.equal(x, y) for x, y in zip(sa.W, sb.W))
    assert ha["stage_layers"] == [2, 2, 4, 4]
