"""The port's kernels on the pdADMM-G and pdADMM-G-Q paths.

On the CPU: each plain version (``repro_torch.kernels.ref``) against the JAX
reference's ``ref`` oracle and its Pallas kernel in interpret mode, at
tile-able shapes <= 128, with the same numpy inputs. The dispatch routes CPU
tensors to the plain versions, and the CUDA wrappers refuse CPU tensors.

On a card (``cuda`` marker; skipped without one): each CUDA kernel against
its plain version on the same CUDA inputs, at ragged and batched shapes.
Matmul tolerances are rtol 1e-4: f32 sums in another order. The grid
kernels repeat their plain version's arithmetic and are held bitwise. The card has
no JAX, so the reference is imported only by the tests that use it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import build, ops
from repro_torch.kernels import quantize_kernel as cuda_grid
from repro_torch.kernels import ref as tref
from repro_torch.kernels.admm_pgrad import admm_pgrad as cuda_admm_pgrad
from repro_torch.kernels.backtrack_phi import \
    backtrack_resnorm as cuda_backtrack_resnorm
from repro_torch.kernels.fista_zlast import fista_zlast as cuda_fista_zlast
from repro_torch.kernels.fista_zlast import momentum_schedule
from repro_torch.kernels.fused_linear import fused_linear as cuda_fused_linear
from repro_torch.kernels.relu_zupdate import relu_zupdate as cuda_relu_zupdate


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _j(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's oracles and Pallas kernels."""
    pytest.importorskip("jax")
    from repro.core import quantize
    from repro.kernels import admm_pgrad, fista_zlast, fused_linear, ref
    from repro.kernels import backtrack_phi, quantize_kernel, relu_zupdate
    return types.SimpleNamespace(
        ref=ref, fused_linear=fused_linear.fused_linear, quantize=quantize,
        backtrack_resnorm=backtrack_phi.backtrack_resnorm,
        grid=quantize_kernel,
        admm_pgrad=admm_pgrad.admm_pgrad, relu_zupdate=relu_zupdate.relu_zupdate,
        fista_zlast=fista_zlast.fista_zlast,
        momentum_schedule=fista_zlast.momentum_schedule)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --- plain versions vs the JAX reference (CPU) -------------------------------

@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (64, 128, 64), (128, 64, 8)])
@pytest.mark.parametrize("mode", ["linear", "residual"])
def test_fused_linear_plain_matches_jax(jx, M, K, N, mode):
    p, W, b, z = _np(0, (M, K), (K, N), (N,), (M, N))
    W /= np.sqrt(K)
    want_ref = np.asarray(jx.ref.fused_linear_ref(*_j(p, W, b, z), mode=mode))
    want_pl = np.asarray(jx.fused_linear(*_j(p, W, b, z), mode=mode,
                                             bm=128, bk=128, bn=128,
                                             interpret=True))
    got = tref.fused_linear_ref(*_t(p, W, b, z), mode=mode).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pl, rtol=1e-5, atol=1e-6)


def test_fused_linear_plain_batched_and_no_bias(jx):
    p, W, b, z = _np(1, (3, 32, 16), (3, 16, 8), (3, 8), (3, 32, 8))
    tp, tW, tb, tz = _t(p, W, b, z)
    batched = tref.fused_linear_ref(tp, tW, tb, tz, mode="residual")
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            tref.fused_linear_ref(tp[i], tW[i], tb[i], tz[i],
                                  mode="residual").numpy())
    # b=None is the reference's _matmul with a zero bias
    np.testing.assert_allclose(
        tref.fused_linear_ref(tp[0], tW[0], None).numpy(),
        np.asarray(jx.ref.fused_linear_ref(*_j(p[0], W[0], np.zeros(8, np.float32)))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V,ni,no", [(128, 128, 128), (128, 64, 128),
                                     (128, 128, 64)])
def test_admm_pgrad_plain_matches_jax(jx, V, ni, no):
    r, W, u, p, q = _np(2, (V, no), (ni, no), (V, ni), (V, ni), (V, ni))
    W /= np.sqrt(no)
    kw = dict(nu=0.01, rho=1.0)
    want_ref = np.asarray(jx.ref.admm_pgrad_ref(*_j(r, W, u, p, q), **kw))
    want_pl = np.asarray(jx.admm_pgrad(*_j(r, W, u, p, q), bm=128, bk=128,
                                           bn=128, interpret=True, **kw))
    got = tref.admm_pgrad_ref(*_t(r, W, u, p, q), **kw).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pl, rtol=1e-5, atol=1e-6)


def _zupdate_obj(z, a, q, z0):
    return (z - a) ** 2 + (q - np.maximum(z, 0)) ** 2 + (z - z0) ** 2


def _assert_zupdate_tie_tolerant(got, want, a, q, z0):
    """The rule of tests/test_kernels.py::test_relu_zupdate: where the two
    branch objectives tie to f32 precision either branch is a minimizer, so
    compare objective values; elsewhere the argmin itself."""
    np.testing.assert_allclose(_zupdate_obj(got, a, q, z0),
                               _zupdate_obj(want, a, q, z0),
                               rtol=1e-4, atol=1e-4)
    zn = np.minimum((a + z0) / 2, 0)
    zp = np.maximum((a + q + z0) / 3, 0)
    assert np.all(_zupdate_obj(got, a, q, z0)
                  <= _zupdate_obj(zn, a, q, z0) + 1e-5)
    assert np.all(_zupdate_obj(got, a, q, z0)
                  <= _zupdate_obj(zp, a, q, z0) + 1e-5)
    tied = np.abs(_zupdate_obj(zn, a, q, z0) - _zupdate_obj(zp, a, q, z0)) < 1e-3
    np.testing.assert_allclose(got[~tied], want[~tied], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(128, 100), (64, 128)])
def test_relu_zupdate_plain_matches_jax(jx, shape):
    a, q, z0 = _np(3, shape, shape, shape)
    got = tref.relu_zupdate_ref(*_t(a, q, z0)).numpy()
    for want in (np.asarray(jx.ref.relu_zupdate_ref(*_j(a, q, z0))),
                 np.asarray(jx.relu_zupdate(*_j(a, q, z0), interpret=True))):
        _assert_zupdate_tie_tolerant(got, want, a, q, z0)


def test_momentum_schedule_is_the_reference_schedule(jx):
    for n in (0, 1, 15):
        assert momentum_schedule(n) == jx.momentum_schedule(n)


@pytest.mark.parametrize("n_iters", [0, 15])
@pytest.mark.parametrize("width,n_classes", [(8, 8), (8, 5)])
def test_fista_zlast_plain_matches_jax(jx, n_iters, width, n_classes):
    V = 128
    a, z0 = _np(4, (V, width), (V, width), scale=2.0)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, n_classes, V).astype(np.int32)
    mask = (rng.random(V) < 0.6).astype(np.float32)
    kw = dict(nu=0.01, n_iters=n_iters, n_classes=n_classes)
    want_ref = np.asarray(jx.ref.fista_zlast_ref(*_j(a, z0, labels, mask), **kw))
    want_pl = np.asarray(jx.fista_zlast(*_j(a, z0, labels, mask), bm=128,
                                            interpret=True, **kw))
    got = tref.fista_zlast_ref(*_t(a, z0, labels, mask), **kw).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 64, 128),
                                   (128, 128, 8)])
def test_backtrack_resnorm_plain_matches_jax(jx, M, K, N):
    r0, d, W = _np(14, (M, N), (M, K), (K, N))
    W /= np.sqrt(K)
    want_ref = float(jx.ref.backtrack_resnorm_ref(*_j(r0, d, W)))
    want_pl = float(jx.backtrack_resnorm(*_j(r0, d, W), interpret=True))
    got = tref.backtrack_resnorm_ref(*_t(r0, d, W))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want_ref, rtol=1e-5)
    np.testing.assert_allclose(float(got), want_pl, rtol=1e-5)


def test_backtrack_resnorm_plain_batched_and_active():
    """The leading axis gives the per-layer values; an inactive layer is 0."""
    r0, d, W = _t(*_np(15, (4, 50, 9), (4, 50, 12), (4, 12, 9)))
    batched = tref.backtrack_resnorm_ref(r0, d, W)
    assert batched.shape == (4,)
    per = [tref.backtrack_resnorm_ref(r0[i], d[i], W[i]) for i in range(4)]
    np.testing.assert_array_equal(batched.numpy(), torch.stack(per).numpy())
    for active in (torch.tensor([True, False, True, False]),
                   torch.tensor([1, 0, 1, 0], dtype=torch.int32)):
        masked = tref.backtrack_resnorm_ref(r0, d, W, active)
        np.testing.assert_array_equal(
            masked.numpy(), (batched * torch.tensor([1., 0., 1., 0.])).numpy())
    assert float(tref.backtrack_resnorm_ref(r0[0], d[0], W[0],
                                            torch.tensor(False))) == 0.0


GRIDS = [("u8", lambda m: m.uniform_grid(8, -2.0, 6.0)),
         ("u16", lambda m: m.uniform_grid(16, -4.0, 4.0)),
         ("int", lambda m: m.integer_grid()),
         ("u4", lambda m: m.uniform_grid(4, 0.0, 15.0))]


@pytest.mark.parametrize("shape", [(64, 128), (3, 40, 128), (37,)])
@pytest.mark.parametrize("name,make", GRIDS, ids=[g[0] for g in GRIDS])
def test_grid_kernels_plain_match_jax_bitwise(jx, name, make, shape):
    """grid_project/encode/decode plain versions equal the Pallas kernels
    in interpret mode and the jitted reference oracles, bit for bit."""
    import jax
    gj, gt = make(jx.quantize), make(tq)
    (x,) = _np(16, shape, scale=5.0)
    x.reshape(-1)[0] = np.float32(5.984314441680908)
    (xj,), (xt,) = _j(x), _t(x)
    proj = tref.grid_project_ref(xt, gt).numpy()
    codes = tref.grid_encode_ref(xt, gt)
    assert codes.dtype == gt.code_dtype and codes.shape == xt.shape
    dec = tref.grid_decode_ref(codes, gt).numpy()
    codes_j = np.asarray(jx.grid.grid_encode(xj, gj, interpret=True))
    for want, got in (
            (jx.grid.grid_project(xj, gj, interpret=True), proj),
            (jax.jit(jx.ref.grid_project_ref, static_argnums=1)(xj, gj), proj),
            (codes_j, codes.to(torch.int32).numpy()),
            (jax.jit(jx.ref.grid_encode_ref, static_argnums=1)(xj, gj),
             codes.to(torch.int32).numpy()),
            (jx.grid.grid_decode(_j(codes_j)[0], gj, interpret=True), dec)):
        np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype))


# --- dispatch and wrapper checks (CPU) ---------------------------------------

def test_ops_routes_cpu_tensors_to_plain_versions():
    ops.reset_launch_counts()
    p, W, b, z = _t(*_np(6, (16, 8), (8, 4), (4,), (16, 4)))
    np.testing.assert_array_equal(
        ops.fused_linear(p, W, b, z, mode="residual").numpy(),
        tref.fused_linear_ref(p, W, b, z, mode="residual").numpy())
    u, pp, q = _t(*_np(7, (16, 8), (16, 8), (16, 8)))
    np.testing.assert_array_equal(
        ops.admm_pgrad(z, W, u, pp, q, nu=0.1, rho=1.0).numpy(),
        tref.admm_pgrad_ref(z, W, u, pp, q, nu=0.1, rho=1.0).numpy())
    np.testing.assert_array_equal(ops.relu_zupdate(u, pp, q).numpy(),
                                  tref.relu_zupdate_ref(u, pp, q).numpy())
    labels = torch.zeros(16, dtype=torch.int32)
    mask = torch.ones(16)
    np.testing.assert_array_equal(
        ops.fista_zlast(z, z, labels, mask, nu=0.01).numpy(),
        tref.fista_zlast_ref(z, z, labels, mask, nu=0.01).numpy())
    active = torch.tensor(True)
    np.testing.assert_array_equal(
        ops.backtrack_resnorm(z, p, W, active).numpy(),
        tref.backtrack_resnorm_ref(z, p, W, active).numpy())
    g = tq.uniform_grid(8, -2.0, 6.0)
    np.testing.assert_array_equal(ops.grid_project(u, g).numpy(),
                                  tref.grid_project_ref(u, g).numpy())
    codes = ops.grid_encode(u, g)
    np.testing.assert_array_equal(codes.numpy(),
                                  tref.grid_encode_ref(u, g).numpy())
    np.testing.assert_array_equal(ops.grid_decode(codes, g).numpy(),
                                  tref.grid_decode_ref(codes, g).numpy())
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_MODULES, 0)
    assert set(ops.KERNEL_MODULES) == {
        "fused_linear", "admm_pgrad", "relu_zupdate", "fista_zlast",
        "backtrack_resnorm", "grid_project", "grid_encode", "grid_decode"}


def test_cuda_wrappers_refuse_cpu_tensors():
    p, W, b, z = _t(*_np(8, (16, 8), (8, 4), (4,), (16, 4)))
    labels, mask = torch.zeros(16, dtype=torch.int32), torch.ones(16)
    calls = [lambda: cuda_fused_linear(p, W, b, z, mode="residual"),
             lambda: cuda_admm_pgrad(z, W, p, p, p, nu=0.1, rho=1.0),
             lambda: cuda_relu_zupdate(p, p, p),
             lambda: cuda_fista_zlast(z, z, labels, mask, nu=0.1, n_iters=3,
                                      n_classes=4),
             lambda: cuda_backtrack_resnorm(z, p, W),
             lambda: cuda_grid.grid_project(p, tq.integer_grid()),
             lambda: cuda_grid.grid_encode(p, tq.integer_grid()),
             lambda: cuda_grid.grid_decode(p.to(torch.uint8),
                                           tq.integer_grid())]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_MODULES, 0)


def test_grid_kernel_scalars_are_the_plain_versions():
    """The f32 (lo, step, 1/step) the grid kernels receive are the ones the
    plain versions compute with."""
    f32 = torch.float32
    rng = np.random.default_rng(19)
    grids = [tq.integer_grid(), tq.uniform_grid(8, -2.0, 6.0)] + [
        tq.uniform_grid(int(rng.integers(1, 17)), lo, lo + w)
        for lo, w in zip(rng.normal(size=200) * 10, rng.exponential(20, 200))]
    for g in grids:
        assert cuda_grid._scalars(g) == (g.lo_in(f32), g.step_in(f32),
                                         g.inv_step_in(f32))


def test_fista_zlast_wrapper_refuses_width_above_cap():
    a = torch.zeros(4, 65)
    with pytest.raises(ValueError, match="cap"):
        cuda_fista_zlast(a, a, torch.zeros(4, dtype=torch.int32),
                         torch.ones(4), nu=0.1, n_iters=1, n_classes=7)


def test_build_plan_compiles_every_source_for_sm90a(tmp_path, monkeypatch):
    cmds = build.compile_commands("nvcc", tmp_path)
    names = {c[c.index("-c") + 1].rsplit("/", 1)[-1] for c in cmds}
    assert names == {"fused_linear.cu", "admm_pgrad.cu", "relu_zupdate.cu",
                     "fista_zlast.cu", "backtrack_resnorm.cu",
                     "quantize_grid.cu"}
    for c in cmds:
        assert "arch=compute_90a,code=sm_90a" in c
        assert "--use_fast_math" not in c
    assert build.library_path().parent.name == build.source_hash()
    assert build.source_hash() == build.source_hash()
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args and args[args.index("-c") + 1].endswith("{fail}"):
    print("error: refused", file=sys.stderr)
    sys.exit(2)
if "-c" in args:
    print("ptxas info    : Used 8 registers")
open(out, "w").write("stand-in for " + " ".join(args))
"""


@pytest.mark.parametrize("fail", ["", "relu_zupdate.cu"])
def test_build_runs_one_compile_per_source_then_links(tmp_path, monkeypatch,
                                                      fail):
    """build() with a stand-in nvcc: every source compiled, one link, the
    library and its log keyed on the source hash; a failed compile raises
    with the compiler's message once every compile has ended."""
    import sys
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail or "-"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    if fail:
        with pytest.raises(RuntimeError, match="refused"):
            build.build()
        assert not build.library_path().exists()
        return
    lib = build.build()
    assert lib == tmp_path / "build" / build.source_hash() / build.LIB_NAME
    assert "-shared" in lib.read_text()
    log = (lib.parent / "build.log").read_text()
    assert log.count("Used 8 registers") == len(build.sources()) == 6
    assert build.build() == lib          # cached: no second build


# --- CUDA kernels vs their plain versions (card only) ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lead,M,K,N", [((), 97, 130, 40), ((), 2485, 300, 7),
                                        ((3,), 200, 64, 64)])
@pytest.mark.parametrize("mode", ["linear", "residual"])
def test_cuda_fused_linear_matches_plain(cuda, lead, M, K, N, mode):
    p, W, b, z = _t(*_np(9, lead + (M, K), lead + (K, N), lead + (N,),
                         lead + (M, N)), device=cuda)
    W /= np.sqrt(K)
    for bias in (b, None):
        got = cuda_fused_linear(p, W, bias, z, mode=mode)
        want = tref.fused_linear_ref(p, W, bias, z, mode=mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,V,ni,no", [((), 97, 130, 40), ((), 500, 64, 7),
                                          ((2,), 130, 96, 96)])
def test_cuda_admm_pgrad_matches_plain(cuda, lead, V, ni, no):
    r, W, u, p, q = _t(*_np(10, lead + (V, no), lead + (ni, no),
                            lead + (V, ni), lead + (V, ni), lead + (V, ni)),
                       device=cuda)
    got = cuda_admm_pgrad(r, W, u, p, q, nu=0.01, rho=1.0)
    want = tref.admm_pgrad_ref(r, W, u, p, q, nu=0.01, rho=1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 97, 130), (1000, 7)])
def test_cuda_relu_zupdate_matches_plain(cuda, shape):
    arrays = _np(11, shape, shape, shape)
    a, q, z0 = _t(*arrays, device=cuda)
    got = cuda_relu_zupdate(a, q, z0).cpu().numpy()
    want = tref.relu_zupdate_ref(a, q, z0).cpu().numpy()
    _assert_zupdate_tie_tolerant(got, want, *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_classes,n_iters", [(7, 7, 15), (8, 5, 0),
                                                     (40, 40, 15), (64, 33, 4)])
def test_cuda_fista_zlast_matches_plain(cuda, width, n_classes, n_iters):
    V = 300
    a, z0 = _t(*_np(12, (V, width), (V, width), scale=2.0), device=cuda)
    rng = np.random.default_rng(13)
    labels = torch.from_numpy(rng.integers(0, n_classes, V).astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.random(V) < 0.6).astype(np.float32)).to(cuda)
    kw = dict(nu=0.01, n_iters=n_iters, n_classes=n_classes)
    got = cuda_fista_zlast(a, z0, labels, mask, **kw)
    want = tref.fista_zlast_ref(a, z0, labels, mask, **kw)
    torch.cuda.synchronize()
    # expf and torch's exp differ by ulps; over 16 steps that is ~1e-6 of
    # the value, so an absolute 1e-5 plus 1e-5 of the value
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,M,K,N", [((), 97, 130, 40), ((), 2485, 1000, 7),
                                        ((3,), 200, 64, 64), ((8,), 130, 96, 70)])
def test_cuda_backtrack_resnorm_matches_plain(cuda, lead, M, K, N):
    r0, d, W = _t(*_np(17, lead + (M, N), lead + (M, K), lead + (K, N)),
                  device=cuda)
    W /= np.sqrt(K)
    masks = [None]
    if lead:
        masks.append((torch.arange(lead[0], device=cuda) % 2)
                     .to(torch.int32))
        masks.append(torch.zeros(lead, dtype=torch.int32, device=cuda))
    else:
        masks.append(torch.tensor(1, dtype=torch.int32, device=cuda))
    for active in masks:
        got = cuda_backtrack_resnorm(r0, d, W, active)
        want = tref.backtrack_resnorm_ref(r0, d, W, active)
        torch.cuda.synchronize()
        assert got.shape == want.shape == lead
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        # the fixed-order reduction gives the same bits on a second run
        assert torch.equal(got, cuda_backtrack_resnorm(r0, d, W, active))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(2485 * 1000, 0), (1001, 0), (1001, 1),
                                      (3, 0)])
@pytest.mark.parametrize("name,make", GRIDS, ids=[g[0] for g in GRIDS])
def test_cuda_grid_kernels_equal_plain_bitwise(cuda, name, make, n, offset):
    """Vector and scalar paths (an offset of one element breaks the 16-byte
    alignment), every code width, the clip and exact ties."""
    grid = make(tq)
    (x,) = _np(18, (n + offset,), scale=6.0)
    x[offset:offset + 40] = (grid.lo + (np.arange(-3, 37) + 0.5)
                             * grid.step).astype(np.float32)[:min(40, n)]
    xt = torch.from_numpy(x).to(cuda)[offset:]
    proj = cuda_grid.grid_project(xt, grid)
    codes = cuda_grid.grid_encode(xt, grid)
    dec = cuda_grid.grid_decode(codes, grid)
    torch.cuda.synchronize()
    assert torch.equal(proj, tref.grid_project_ref(xt, grid))
    assert codes.dtype == grid.code_dtype
    assert torch.equal(codes.to(torch.int32),
                       tref.grid_encode_ref(xt, grid).to(torch.int32))
    assert torch.equal(dec, tref.grid_decode_ref(codes, grid))
    assert torch.equal(cuda_grid.grid_decode(codes, grid, torch.float64),
                       tref.grid_decode_ref(codes, grid, torch.float64))
