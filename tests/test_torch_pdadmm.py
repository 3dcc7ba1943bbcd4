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
  another order), for pdADMM-G and for pdADMM-G-Q (p and q on
  ``uniform_grid(8, -2, 6)``, also with 8-bit u wire codecs). Not pinned
  to the reference's golden value, whose own test fails.
* Inside the port, in f64: the fast ``iterate`` against the naive
  ``iterate_reference``, and the stacked path against the per-layer one,
  with and without grids.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jc
from repro.core import pdadmm as jpd
from repro.core import quantize as jq
from repro.graph import datasets as jd
from repro_torch.comm import codecs as tc
from repro_torch.core import pdadmm as tpd
from repro_torch.core import quantize as tq
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
        assert tpd._stackable(st, (None,) * len(st.W),
                              (None,) * (len(st.W) - 1))
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


def _gq(m, **kw):
    return m.ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                        grid=(jq if m is jpd else tq).uniform_grid(8, -2.0, 6.0),
                        **kw)


def _u_codecs(L, m):
    if m is None:
        return None
    return (m.GridCodec((jq if m is jc else tq).uniform_grid(8, -1.0, 1.0)),) \
        * (L - 1)


@pytest.mark.parametrize("tail,wire", [((32, 32), False),
                                       ((32, 32, 32), False),
                                       ((32, 32, 32), True)],
                         ids=["per_layer", "stacked", "stacked_u_wire"])
def test_ten_gq_iterations_f32_track_live_jax(tail, wire):
    """pdADMM-G-Q, the quickstart's grid: a live reference run (its jitted
    scan driver; the jitted step where u wire codecs are set) and the port
    from the reference's initial state, τ equal at every iteration."""
    dsj = jd.synthetic("citeseer", seed=0, scale=0.03)
    dst = td.synthetic("citeseer", seed=0, scale=0.03, device="cpu")
    Xj, Xt = dsj.augmented(2), dst.augmented(2)
    dims = [Xj.shape[1], *tail, dsj.n_classes]
    L = len(dims) - 1
    cfg_j, cfg_t = _gq(jpd), _gq(tpd)
    uj, ut = _u_codecs(L, jc if wire else None), _u_codecs(L, tc if wire
                                                            else None)
    key = jax.random.PRNGKey(0)
    s0 = jpd.init_state(key, Xj, dims, cfg_j)
    if wire:
        step = jax.jit(functools.partial(jpd.iterate, config=cfg_j,
                                         u_codecs=uj))
        sj, obj_j = s0, []
        for _ in range(10):
            sj, m = step(sj, Xj, dsj.labels, dsj.masks["train"])
            obj_j.append(float(m["objective"]))
    else:
        sj, hist = jpd.train(key, Xj, dsj.labels, dsj.masks, dims, cfg_j,
                             epochs=10)
        obj_j = hist["objective"]
    st = state_from_numpy(_leaves(s0), device="cpu")
    assert tpd._stackable(st, (cfg_t.grid,) * L, (cfg_t.grid,) * (L - 1)) \
        == (len(tail) == 3)
    obj_t = []
    for _ in range(10):
        st, m = tpd.iterate(st, Xt, dst.labels, dst.masks["train"], cfg_t,
                            u_codecs=ut)
        obj_t.append(float(m["objective"]))
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-3)
    assert [float(t) for t in st.tau] == [float(t) for t in sj.tau]
    # p and q stay on the grid
    g = cfg_t.grid
    for x in st.p[1:] + st.q:
        np.testing.assert_array_equal(x.numpy(), g.project(x).numpy())


def test_u_wire_changes_what_the_p_update_reads():
    """The u wire quantizes only the view layer l+1 reads: the stored dual
    is the same exact update, and the iterate moves."""
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 16, 16, 16, ds.n_classes]
    cfg = tpd.ADMMConfig(use_kernels=False)
    s = tpd.init_state(0, X, dims, cfg, device="cpu")
    args = (X, ds.labels, ds.masks["train"])
    for _ in range(3):
        s, _ = tpd.iterate(s, *args, cfg)
    codecs = (tc.GridCodec(tq.uniform_grid(4, -0.05, 0.05)),) * 3
    a, _ = tpd.iterate(s, *args, cfg)
    b, _ = tpd.iterate(s, *args, cfg, u_codecs=codecs)
    c, _ = tpd.iterate(s, *args, cfg, u_codecs=(None,) * 3)
    assert not torch.equal(a.p[1], b.p[1])
    for fa, fc in zip(a, c):
        for x, y in zip(fa, fc):
            assert torch.equal(x, y)


GRID_CASES = [("G", None), ("GQ_u8", "u8"), ("GQ_int", "int")]


def _grid_cfg(kind, **kw):
    grid = {"u8": tq.uniform_grid(8, -2.0, 6.0), "int": tq.integer_grid(),
            None: None}[kind]
    return tpd.ADMMConfig(quantize_p=grid is not None,
                          quantize_q=grid is not None, grid=grid, **kw)


def _f64(state):
    return tpd.ADMMState(*[[x.double() for x in fam] for fam in state])


@pytest.mark.parametrize("kind", [c[1] for c in GRID_CASES],
                         ids=[c[0] for c in GRID_CASES])
@pytest.mark.parametrize("tail", [(16, 12), (16, 16, 16)],
                         ids=["per_layer", "stacked"])
def test_iterate_matches_iterate_reference_f64(tail, kind):
    ds = td.tiny(device="cpu")
    X = ds.augmented(4).double()
    dims = [X.shape[1], *tail, ds.n_classes]
    cfg = _grid_cfg(kind, use_kernels=False)
    s = _f64(tpd.init_state(0, X.float(), dims, cfg, device="cpu"))
    args = (X, ds.labels, ds.masks["train"])
    for _ in range(2):
        s, _ = tpd.iterate(s, *args, cfg)
    fast, mf = tpd.iterate(s, *args, cfg)
    ref, mr = tpd.iterate_reference(s, *args, cfg)
    assert [float(t) for t in fast.tau] == [float(t) for t in ref.tau]
    assert [float(t) for t in fast.theta] == [float(t) for t in ref.theta]
    for fa, fb in zip(fast[:6], ref[:6]):
        for x, y in zip(fa, fb):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-8,
                                       atol=1e-10)
    for k in mf:
        np.testing.assert_allclose(np.asarray(mf[k]), np.asarray(mr[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)


def test_iterate_reference_matches_jax_f64(x64):
    """The port's oracle against the reference's, from a handed-over state,
    under the integer grid Δ = {-1..20}."""
    dsj = jd.tiny()
    X = dsj.augmented(4).astype(jnp.float64)
    dims = [X.shape[1], 16, 16, dsj.n_classes]
    cfg_j = jpd.ADMMConfig(quantize_p=True, quantize_q=True,
                           grid=jq.integer_grid(), use_kernels=False)
    cfg_t = _grid_cfg("int", use_kernels=False)
    s0 = jpd.ADMMState(*_leaves_jax64(
        jpd.init_state(jax.random.PRNGKey(1), X, dims, cfg_j)))
    for _ in range(2):
        s0, _ = jpd.iterate(s0, X, dsj.labels, dsj.masks["train"], cfg_j)
    st = state_from_numpy(_leaves(s0), device="cpu", dtype=torch.float64)
    Xt, lab, mask = (torch.from_numpy(np.array(a))
                     for a in (X, dsj.labels, dsj.masks["train"]))
    s1j, mj = jpd.iterate_reference(s0, X, dsj.labels, dsj.masks["train"],
                                    cfg_j)
    s1t, mt = tpd.iterate_reference(st, Xt, lab, mask, cfg_t)
    _assert_states_close(s1j, s1t, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(float(mt["objective"]), float(mj["objective"]),
                               rtol=1e-8)


@pytest.mark.parametrize("kind", ["u8", "int"])
def test_stacked_path_equals_per_layer_path_under_a_grid(kind):
    ds = td.tiny(device="cpu")
    X = ds.augmented(4).double()
    dims = [X.shape[1], 16, 16, 16, 16, ds.n_classes]
    cfg_s = _grid_cfg(kind, use_kernels=False)
    cfg_f = _grid_cfg(kind, use_kernels=False, stack_hidden=False)
    s = _f64(tpd.init_state(0, X.float(), dims, cfg_s, device="cpu"))
    codecs = (tc.GridCodec(tq.uniform_grid(8, -1.0, 1.0)),) * 4
    for it in range(3):
        u = codecs if it == 2 else None
        a, ma = tpd.iterate(s, X, ds.labels, ds.masks["train"], cfg_s,
                            u_codecs=u)
        b, mb = tpd.iterate(s, X, ds.labels, ds.masks["train"], cfg_f,
                            u_codecs=u)
        for fa, fb in zip(a, b):
            for x, y in zip(fa, fb):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                           atol=1e-13)
        assert [float(t) for t in a.tau] == [float(t) for t in b.tau]
        np.testing.assert_allclose(float(ma["objective"]),
                                   float(mb["objective"]), rtol=1e-10)
        s = a


def test_per_layer_grids_and_stackable():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 8, 8, 8, ds.n_classes]
    s = tpd.init_state(0, X, dims, tpd.ADMMConfig(), device="cpu")
    u8, u4 = tq.uniform_grid(8, -2.0, 6.0), tq.uniform_grid(4, -2.0, 6.0)
    assert tpd._stackable(s, (None, u8, u8, u4), (u8, u8, u8))
    assert not tpd._stackable(s, (None, u8, u4, u4), (u8, u8, u8))
    assert not tpd._stackable(s, (None, u8, u8, u8), (u8, u4, u8))
    # heterogeneous grids take the per-layer path, each layer on its grid
    cfg = tpd.ADMMConfig(use_kernels=False)
    out, _ = tpd.iterate(s, X, ds.labels, ds.masks["train"], cfg,
                         p_grids=(None, u8, u4, u4), q_grids=(u8, u4, u4))
    for x, g in zip(out.p[1:], (u8, u4, u4)):
        np.testing.assert_array_equal(x.numpy(), g.project(x).numpy())


def test_init_state_quantize_p_shares_one_projected_tensor():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 8, 8, ds.n_classes]
    cfg = _grid_cfg("u8")
    s = tpd.init_state(0, X, dims, cfg, device="cpu")
    for l in range(len(dims) - 2):
        assert s.p[l + 1] is s.q[l]
        np.testing.assert_array_equal(
            s.q[l].numpy(), cfg.grid.project(tpd.relu(s.z[l])).numpy())
    plain = tpd.init_state(0, X, dims, tpd.ADMMConfig(), device="cpu")
    assert torch.equal(plain.q[0], tpd.relu(plain.z[0]))


def test_calibrate_grid_matches_jax(monkeypatch):
    """On one handed-over state (the port's init_state replaced by the
    reference's), the fitted grid is the reference's."""
    dsj = jd.synthetic("citeseer", seed=0, scale=0.03)
    dst = td.synthetic("citeseer", seed=0, scale=0.03, device="cpu")
    Xj, Xt = dsj.augmented(2), dst.augmented(2)
    dims = [Xj.shape[1], 32, 32, dsj.n_classes]
    key = jax.random.PRNGKey(3)
    shared = state_from_numpy(
        _leaves(jpd.init_state(key, Xj, dims, jpd.ADMMConfig())), device="cpu")
    seen = []

    def handed_over(seed, X, dims_, config, *, device=None):
        seen.append((seed, tuple(dims_), device))
        return shared

    monkeypatch.setattr(tpd, "init_state", handed_over)
    for bits, frac in ((8, 0.05), (4, 0.2), (16, 0.0)):
        gj = jpd.calibrate_grid(key, Xj, dims, bits, frac)
        gt = tpd.calibrate_grid(7, Xt, dims, bits, frac)
        assert (gt.lo, gt.step, gt.n_levels) == (gj.lo, gj.step, gj.n_levels)
    assert seen[0] == (7, tuple(dims), Xt.device)


def test_calibrate_grid_takes_a_seed_or_a_generator():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 8, 8, ds.n_classes]
    a = tpd.calibrate_grid(5, X, dims, 8)
    b = tpd.calibrate_grid(torch.Generator().manual_seed(5), X, dims, 8)
    assert a == b and a.n_levels == 256 and a.lo < 0.0 < a.hi


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu", "--scale", "0.05", "--epochs", "3"])
    out = capsys.readouterr().out
    assert "pdADMM-G-Q" in out and "comm bytes/iter" in out and "saved" in out
