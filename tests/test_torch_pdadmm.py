"""The port's pdADMM-G driver against the JAX reference, from the same state.

The reference draws its initial weights with ``jax.random``; the port cannot,
so every comparison starts from the reference's ``init_state``, handed over
through ``repro_torch.core.interop.state_from_numpy``.

* One ``iterate`` in f64 on ``tiny()``: rtol 1e-8, every τ and θ bit for bit,
  on the layer-stacked path and on the per-layer path. It starts two
  reference iterations past ``init_state``: at the forward-consistent init
  every residual and gradient is zero up to rounding, and the accept test
  on φ ≈ 0 decides on rounding noise (either τ is a valid step there).
* Ten iterations in f32 on ``synthetic("citeseer", scale=0.03)``: the
  objective tracks a live reference ``train`` at rtol 1e-3 (f32 matmuls in
  another order). Not pinned to the reference's golden value, whose own
  test fails.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pdadmm as jpd
from repro.graph import datasets as jd
from repro_torch.core import pdadmm as tpd
from repro_torch.core.interop import state_from_numpy
from repro_torch.graph import datasets as td


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _leaves(state, dtype=None):
    out = []
    for fam in state:
        out.append([np.asarray(x if dtype is None else x.astype(dtype))
                    for x in fam])
    return out


def _assert_states_close(sj, st, rtol, atol):
    for fam in ("p", "W", "b", "z", "q", "u"):
        for i, (a, b) in enumerate(zip(getattr(sj, fam), getattr(st, fam))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=atol, err_msg=f"{fam}[{i}]")
    for fam in ("tau", "theta"):
        for i, (a, b) in enumerate(zip(getattr(sj, fam), getattr(st, fam))):
            assert np.float32(a).tobytes() == np.float32(b.numpy()).tobytes(), \
                (fam, i, float(a), float(b))


@pytest.mark.parametrize("tail,stack", [((16, 16, 16), True),
                                        ((24, 16), False),
                                        ((24, 16, 16, 12), False)],
                         ids=["stacked", "per_layer", "per_layer_L5"])
def test_one_iterate_f64_matches_jax(x64, tail, stack):
    dsj = jd.tiny()
    X = dsj.augmented(4).astype(jnp.float64)
    dims = [X.shape[1], *tail, dsj.n_classes]
    cfg_j = jpd.ADMMConfig(nu=1e-2, rho=1.0, use_kernels=False,
                           stack_hidden=stack)
    cfg_t = tpd.ADMMConfig(nu=1e-2, rho=1.0, use_kernels=False,
                           stack_hidden=stack)
    step = jax.jit(functools.partial(jpd.iterate, config=cfg_j))
    s0 = jpd.init_state(jax.random.PRNGKey(0), X, dims, cfg_j)
    s0 = jpd.ADMMState(*_leaves_jax64(s0))
    for _ in range(2):
        s0, _ = step(s0, X, dsj.labels, dsj.masks["train"])
    st = state_from_numpy(_leaves(s0), device="cpu", dtype=torch.float64)
    if stack:
        assert jpd._stackable(s0, (None,) * len(s0.W), (None,) * (len(s0.W) - 1))
        assert tpd._stackable(st, (None,) * (len(st.W) - 1))
    Xt, lab, mask = (torch.from_numpy(np.array(a))
                     for a in (X, dsj.labels, dsj.masks["train"]))
    s1j, mj = step(s0, X, dsj.labels, dsj.masks["train"])
    s1t, mt = tpd.iterate(st, Xt, lab, mask, cfg_t)
    _assert_states_close(s1j, s1t, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(float(mt["objective"]), float(mj["objective"]),
                               rtol=1e-8)
    np.testing.assert_allclose(float(mt["residual"]), float(mj["residual"]),
                               rtol=1e-8)
    for k in ("layer_residuals", "layer_dual_residuals"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-8, atol=1e-12)
    # the objective is the Lagrangian at the new state
    np.testing.assert_allclose(
        float(tpd.lagrangian(s1t, lab, mask, cfg_t)),
        float(jpd.lagrangian(s1j, dsj.labels, dsj.masks["train"], cfg_j)),
        rtol=1e-8)


def _leaves_jax64(state):
    return [[x.astype(jnp.float64) for x in fam] for fam in state]


def test_stacked_path_equals_per_layer_path():
    """Inside the port: the batched hidden block computes the per-layer solves."""
    ds = td.tiny(device="cpu")
    X = ds.augmented(4)
    dims = [X.shape[1], 16, 16, 16, 16, ds.n_classes]
    cfg_s = tpd.ADMMConfig(use_kernels=False)
    cfg_f = tpd.ADMMConfig(use_kernels=False, stack_hidden=False)
    s = tpd.init_state(0, X, dims, cfg_s, device="cpu")
    s = tpd.ADMMState(*[[x.double() for x in fam] for fam in s])
    X = X.double()
    for _ in range(3):
        a, ma = tpd.iterate(s, X, ds.labels, ds.masks["train"], cfg_s)
        b, mb = tpd.iterate(s, X, ds.labels, ds.masks["train"], cfg_f)
        for fa, fb in zip(a, b):
            for x, y in zip(fa, fb):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                           atol=1e-13)
        assert [float(t) for t in a.tau] == [float(t) for t in b.tau]
        np.testing.assert_allclose(float(ma["objective"]),
                                   float(mb["objective"]), rtol=1e-10)
        s = a


@pytest.mark.parametrize("tail", [(32, 32), (32, 32, 32)],
                         ids=["per_layer", "stacked"])
def test_ten_iterations_f32_track_live_jax_train(tail):
    dsj = jd.synthetic("citeseer", seed=0, scale=0.03)
    dst = td.synthetic("citeseer", seed=0, scale=0.03, device="cpu")
    Xj = dsj.augmented(2)
    Xt = dst.augmented(2)
    dims = [Xj.shape[1], *tail, dsj.n_classes]
    cfg_j = jpd.ADMMConfig(nu=1e-2, rho=1.0)
    cfg_t = tpd.ADMMConfig(nu=1e-2, rho=1.0)
    key = jax.random.PRNGKey(0)
    sj, hist = jpd.train(key, Xj, dsj.labels, dsj.masks, dims, cfg_j,
                         epochs=10)
    s0 = state_from_numpy(_leaves(jpd.init_state(key, Xj, dims, cfg_j)),
                          device="cpu")
    st, ms = tpd.run_chunked(functools.partial(tpd.iterate, config=cfg_t), s0,
                             (Xt, dst.labels, dst.masks["train"]), 10, chunk=4)
    assert ms["objective"].shape == (10,)
    assert np.all(np.isfinite(ms["objective"]))
    np.testing.assert_allclose(ms["objective"], hist["objective"], rtol=1e-3)
    assert ms["objective"][-1] < ms["objective"][0]
    # forward_accuracy on one shared state is equal
    s_shared = state_from_numpy(_leaves(sj), device="cpu")
    for split in ("val", "test"):
        acc_j = float(jpd.forward_accuracy(sj, Xj, dsj.labels, dsj.masks[split]))
        acc_t = float(tpd.forward_accuracy(s_shared, Xt, dst.labels,
                                           dst.masks[split]))
        assert acc_t == acc_j, (split, acc_t, acc_j)


def test_train_entry_point_runs_and_chunks():
    ds = td.tiny(device="cpu")
    X = ds.augmented(4)
    dims = [X.shape[1], 16, 16, 16, ds.n_classes]
    cfg = tpd.ADMMConfig()
    _, h3 = tpd.train(0, X, ds.labels, ds.masks, dims, cfg, 7, device="cpu",
                      chunk=3)
    _, h32 = tpd.train(0, X, ds.labels, ds.masks, dims, cfg, 7, device="cpu")
    seen = []
    _, hcb = tpd.train(0, X, ds.labels, ds.masks, dims, cfg, 7, device="cpu",
                       callback=lambda e, s, m: seen.append(e))
    assert seen == list(range(7))
    assert len(h3["objective"]) == 7
    np.testing.assert_array_equal(h3["objective"], h32["objective"])
    np.testing.assert_array_equal(hcb["objective"], h32["objective"])
    assert h3["objective"][-1] < h3["objective"][0]
    assert 0.0 <= h3["test_acc"][0] <= 1.0
    assert tpd.run_chunked(None, "s", (), 0) == ("s", {})


def test_unported_options_raise():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 8, ds.n_classes]
    s = tpd.init_state(0, X, dims, tpd.ADMMConfig(), device="cpu")
    args = (X, ds.labels, ds.masks["train"])
    with pytest.raises(NotImplementedError):
        tpd.iterate(s, *args, tpd.ADMMConfig(quantize_p=True))
    with pytest.raises(NotImplementedError):
        tpd.iterate(s, *args, tpd.ADMMConfig(), u_codecs=(None,))
    with pytest.raises(NotImplementedError):
        tpd.init_state(0, X, dims, tpd.ADMMConfig(quantize_p=True),
                       device="cpu")
