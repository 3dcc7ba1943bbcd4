"""The port's block-pdADMM against the JAX reference, and its card routes.

On the CPU, in f64 (the reference under the ``x64`` fixture, run eagerly),
on ``tests/test_fista_kernel.py``'s problem (L 3, B 2, S 4, d 8, tanh
blocks, the masked softmax-CE risk), inputs made with numpy from a seed,
three iterations:

* the generic route (``fista_prox`` on ``torch.func.grad(risk_fn)``) and the
  CE route (``ops.fista_zlast`` on the flattened rows, here its plain
  version) against the reference's routes at rtol 1e-10, and the port's
  two routes against each other;
* a quantized case: p on a 4-bit grid of step 1/4, q not (the paper's
  G-Q setting; the step is a power of two, so the reference's division by
  it and the port's multiply by its reciprocal agree);
* a ``torch.func`` case whose params are a dict of stacked tensors;
* the CE route at d = 80 classes (``n_classes=None``), as the card's
  block-a-row route takes it.

On a card (``cuda`` marker; skipped without one; the card has no JAX, so
the reference is imported only by the tests that use it):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_block_admm.py

the CE route on CUDA equals its CPU route at the ``fista_zlast`` tolerance
(atol 1e-5 + rtol 1e-5; f32), also at d = 80 classes (the kernel's
block-a-row route) with nothing run on the CPU in its place, and a grid
under the CUDA p step projects outside ``vmap`` through the
``grid_project`` kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import block_admm as TB
from repro_torch.core import pdadmm as tpd
from repro_torch.core import quantize as tq
from repro_torch.core.interop import block_state_from_numpy
from repro_torch.kernels import ops

L, B, S, D = 3, 2, 4, 8
ITERS = 3
GRID = dict(bits=4, lo=-1.875, hi=1.875)         # step 0.25
FISTA_TOL = 1e-5


@pytest.fixture
def x64():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _problem(seed=0, d=D, dict_params=False):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(L, d, d)) * 0.3
    if dict_params:
        W = {"w": W, "c": rng.normal(size=(L, d)) * 0.1}
    x0 = rng.normal(size=(B, S, d))
    labels = rng.integers(0, d, size=(B, S))
    mask = (rng.random((B, S)) < 0.75).astype(np.float64)
    return W, x0, labels, mask


def _torch_fns(labels, mask, dict_params=False):
    def block_fn(W, p):
        if dict_params:
            return torch.tanh(p @ W["w"] + W["c"])
        return torch.tanh(p @ W)

    def risk_fn(z):
        d = z.shape[-1]
        logp = torch.log_softmax(z.reshape(-1, d), dim=-1)
        nll = -logp.gather(-1, labels.reshape(-1, 1).long())[:, 0]
        return (nll * mask.reshape(-1)).sum()
    return block_fn, risk_fn


def _jax_fns(labels, mask, dict_params=False):
    import jax
    import jax.numpy as jnp

    def block_fn(W, p):
        if dict_params:
            return jnp.tanh(p @ W["w"] + W["c"])
        return jnp.tanh(p @ W)

    def risk_fn(z):
        d = z.shape[-1]
        logp = jax.nn.log_softmax(z.reshape(-1, d), axis=-1)
        nll = -jnp.take_along_axis(logp, labels.reshape(-1)[:, None],
                                   axis=-1)[:, 0]
        return jnp.sum(nll * mask.reshape(-1))
    return block_fn, risk_fn


def _configs(quantized):
    from repro.core import quantize as jq
    from repro.core.pdadmm import ADMMConfig as JConfig
    kw = dict(nu=1e-2, rho=1.0)
    if quantized:
        return (JConfig(quantize_p=True, grid=jq.uniform_grid(**GRID), **kw),
                _configs_port(True))
    return JConfig(**kw), tpd.ADMMConfig(**kw)


def _run_jax(W, x0, labels, mask, cfg, ce, dict_params):
    import jax
    import jax.numpy as jnp
    from repro.core import block_admm as JB
    lj, mj = jnp.asarray(labels), jnp.asarray(mask)
    block_fn, risk_fn = _jax_fns(lj, mj, dict_params)
    Wj = jax.tree.map(jnp.asarray, W)
    xj = jnp.asarray(x0)
    st = JB.init_block_state(block_fn, Wj, xj, L, cfg)
    it = JB.make_block_iterate(block_fn, risk_fn, cfg,
                               labels=lj if ce else None,
                               label_mask=mj if ce else None)
    objs = []
    for _ in range(ITERS):
        st, m = it(st, xj)
        objs.append(float(m["objective"]))
    return st, objs


def _run_torch(W, x0, labels, mask, cfg, ce, dict_params, device="cpu",
               dtype=torch.float64, n_classes=None):
    lt = torch.from_numpy(labels).to(device)
    mt = torch.from_numpy(mask).to(device=device, dtype=dtype)
    block_fn, risk_fn = _torch_fns(lt, mt, dict_params)
    as_t = (lambda a: torch.from_numpy(np.array(a)).to(device=device,
                                                       dtype=dtype))
    Wt = ({k: as_t(v) for k, v in W.items()} if dict_params else as_t(W))
    xt = as_t(x0)
    st = TB.init_block_state(block_fn, Wt, xt, L, cfg, device=device)
    it = TB.make_block_iterate(block_fn, risk_fn, cfg,
                               labels=lt if ce else None,
                               label_mask=mt if ce else None,
                               n_classes=n_classes)
    objs = []
    for _ in range(ITERS):
        st, m = it(st, xt)
        objs.append(float(m["objective"]))
    return st, objs


def _assert_states_close(sa, sb, rtol, atol):
    for fam in ("p", "z", "q", "u"):
        np.testing.assert_allclose(getattr(sb, fam).cpu().numpy(),
                                   np.asarray(getattr(sa, fam)), rtol=rtol,
                                   atol=atol, err_msg=fam)
    Wa, Wb = sa.W, sb.W
    if isinstance(Wb, dict):
        for k in Wb:
            np.testing.assert_allclose(Wb[k].cpu().numpy(), np.asarray(Wa[k]),
                                       rtol=rtol, atol=atol, err_msg=f"W[{k}]")
    else:
        np.testing.assert_allclose(Wb.cpu().numpy(), np.asarray(Wa), rtol=rtol,
                                   atol=atol, err_msg="W")


CASES = [(False, False), (True, False), (False, True)]
CASE_IDS = ["plain", "quantized", "dict_params"]


@pytest.mark.parametrize("ce", [False, True], ids=["generic", "ce"])
@pytest.mark.parametrize("quantized,dict_params", CASES, ids=CASE_IDS)
def test_block_iterate_f64_matches_jax(x64, quantized, dict_params, ce):
    W, x0, labels, mask = _problem(dict_params=dict_params)
    cfg_j, cfg_t = _configs(quantized)
    sj, oj = _run_jax(W, x0, labels, mask, cfg_j, ce, dict_params)
    st, ot = _run_torch(W, x0, labels, mask, cfg_t, ce, dict_params)
    _assert_states_close(sj, st, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ot, oj, rtol=1e-10)
    if quantized:
        grid = tq.uniform_grid(**GRID)
        assert torch.equal(st.p[1:], grid.project(st.p[1:]))
        assert float(st.u.abs().max()) > 0


def test_block_ce_route_at_d_classes_f64_matches_jax(x64):
    """The CE route with ``n_classes=None`` at d = 80: a softmax over all 80
    columns, past the kernel's lane-group route (at most 64 classes)."""
    W, x0, labels, mask = _problem(seed=5, d=80)
    cfg_j, cfg_t = _configs(False)
    sj, oj = _run_jax(W, x0, labels, mask, cfg_j, True, False)
    st, ot = _run_torch(W, x0, labels, mask, cfg_t, True, False)
    _assert_states_close(sj, st, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ot, oj, rtol=1e-10)


@pytest.mark.parametrize("quantized,dict_params", CASES, ids=CASE_IDS)
def test_block_routes_agree_f64(quantized, dict_params):
    """Inside the port: the CE route computes the generic route's iteration
    when the risk is the masked CE."""
    W, x0, labels, mask = _problem(seed=1, dict_params=dict_params)
    cfg = _configs_port(quantized)
    sg, og = _run_torch(W, x0, labels, mask, cfg, False, dict_params)
    sc, oc = _run_torch(W, x0, labels, mask, cfg, True, dict_params)
    _assert_states_close(_numpy_state(sg), sc, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(oc, og, rtol=1e-10)


def _configs_port(quantized):
    kw = dict(nu=1e-2, rho=1.0)
    if quantized:
        return tpd.ADMMConfig(quantize_p=True, grid=tq.uniform_grid(**GRID),
                              **kw)
    return tpd.ADMMConfig(**kw)


def _numpy_state(st):
    W = ({k: v.cpu().numpy() for k, v in st.W.items()}
         if isinstance(st.W, dict) else st.W.cpu().numpy())
    return TB.BlockState(st.p.cpu().numpy(), W, st.z.cpu().numpy(),
                         st.q.cpu().numpy(), st.u.cpu().numpy())


@pytest.mark.parametrize("dict_params", [False, True], ids=["tensor", "dict"])
def test_block_state_hands_over_from_numpy(dict_params):
    W, x0, labels, mask = _problem(dict_params=dict_params)
    st, _ = _run_torch(W, x0, labels, mask, _configs_port(False), True,
                       dict_params)
    back = block_state_from_numpy(_numpy_state(st), device="cpu",
                                  dtype=torch.float64)
    _assert_states_close(_numpy_state(st), back, rtol=0, atol=0)


def test_init_block_state_is_forward_consistent():
    W, x0, labels, mask = _problem()
    lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)
    block_fn, _ = _torch_fns(lt, mt)
    st = TB.init_block_state(block_fn, torch.from_numpy(W),
                             torch.from_numpy(x0), L, _configs_port(False),
                             device="cpu")
    assert tuple(st.p.shape) == (L, B, S, D)
    assert torch.equal(st.p[0], torch.from_numpy(x0))
    assert torch.equal(st.p[1:], st.z[:-1])
    assert torch.equal(st.q, st.z) and float(st.u.abs().sum()) == 0


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "quantized"])
def test_cuda_block_ce_route_matches_its_cpu_route(cuda, quantized):
    W, x0, labels, mask = _problem(seed=2)
    cfg = _configs_port(quantized)
    ops.reset_launch_counts()
    sg, og = _run_torch(W, x0, labels, mask, cfg, True, False, device=cuda,
                        dtype=torch.float32)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fista_zlast"] == ITERS
    # one projection at init (q), one per iteration (the stacked p)
    assert counts["grid_project"] == (ITERS + 1 if quantized else 0)
    sc, oc = _run_torch(W, x0, labels, mask, cfg, True, False, device="cpu",
                        dtype=torch.float32)
    np.testing.assert_allclose(sg.z[-1].cpu().numpy(), sc.z[-1].numpy(),
                               rtol=FISTA_TOL, atol=FISTA_TOL)
    np.testing.assert_allclose(og, oc, rtol=FISTA_TOL)


@pytest.mark.cuda
def test_cuda_block_ce_route_runs_at_d_classes(cuda, monkeypatch):
    """d = 80 classes (``n_classes=None``): the kernel's block-a-row route,
    with nothing run on the CPU in its place, equal to the CPU route."""
    from repro_torch.kernels import ref

    def no_cpu(*a, **k):
        raise AssertionError("the plain version ran in the kernel's place")
    monkeypatch.setattr(ref, "fista_zlast_ref", no_cpu)
    W, x0, labels, mask = _problem(seed=3, d=80)
    ops.reset_launch_counts()
    sg, og = _run_torch(W, x0, labels, mask, _configs_port(False), True,
                        False, device=cuda, dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fista_zlast"] == ITERS
    monkeypatch.undo()
    sc, oc = _run_torch(W, x0, labels, mask, _configs_port(False), True,
                        False, device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(sg.z[-1].cpu().numpy(), sc.z[-1].numpy(),
                               rtol=FISTA_TOL, atol=FISTA_TOL)
    np.testing.assert_allclose(og, oc, rtol=FISTA_TOL)


@pytest.mark.cuda
def test_cuda_p_step_projects_outside_vmap(cuda):
    W, x0, labels, mask = _problem(seed=4)
    ops.reset_launch_counts()
    st, objs = _run_torch(W, x0, labels, mask, _configs_port(True), False,
                          False, device=cuda, dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["grid_project"] == ITERS + 1
    grid = tq.uniform_grid(**GRID)
    assert torch.equal(st.p[1:], grid.project(st.p[1:].cpu()).to(cuda))
    assert np.all(np.isfinite(objs))
