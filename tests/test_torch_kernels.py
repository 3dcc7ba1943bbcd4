"""The port's kernels on the pdADMM-G and pdADMM-G-Q paths, and the LM
prefill's attention.

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
from repro_torch.kernels import pack_codes as cuda_pack
from repro_torch.kernels import quantize_kernel as cuda_grid
from repro_torch.kernels import ref as tref
from repro_torch.kernels.admm_pgrad import admm_pgrad as cuda_admm_pgrad
from repro_torch.kernels.backtrack_phi import \
    backtrack_resnorm as cuda_backtrack_resnorm
from repro_torch.kernels.fista_zlast import fista_zlast as cuda_fista_zlast
from repro_torch.kernels.fista_zlast import momentum_buffer, momentum_schedule
from repro_torch.kernels.fista_zlast import route as fista_route
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
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
    for n in (0, 1, 15, 300):
        assert momentum_schedule(n) == jx.momentum_schedule(n)
        # the kernel's buffer: each weight rounded to f32 once
        want = torch.from_numpy(np.asarray(jx.momentum_schedule(n),
                                           dtype=np.float32))
        assert torch.equal(momentum_buffer(n, "cpu"), want)


@pytest.mark.parametrize("n_iters", [0, 15])
@pytest.mark.parametrize("width,n_classes", [
    (8, 8), (8, 5),
    (3, 3), (16, 15), (40, 40),      # pubmed's, coauthor_cs's, ogbn_arxiv's classes
    (64, 7),                         # head-folded: a row wider than its classes
    (80, 80), (200, 130)])           # the kernel's block-a-row route (C > 64)
def test_fista_zlast_plain_matches_jax(jx, n_iters, width, n_classes):
    V = 128
    a, z0, labels, mask = _fista_np(V, width, n_classes)
    kw = dict(nu=0.01, n_iters=n_iters, n_classes=n_classes)
    want_ref = np.asarray(jx.ref.fista_zlast_ref(*_j(a, z0, labels, mask), **kw))
    want_pl = np.asarray(jx.fista_zlast(*_j(a, z0, labels, mask), bm=128,
                                            interpret=True, **kw))
    got = tref.fista_zlast_ref(*_t(a, z0, labels, mask), **kw).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=1e-5)


def _fista_np(V, width, n_classes):
    a, z0 = _np(4, (V, width), (V, width), scale=2.0)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, n_classes, V).astype(np.int32)
    mask = (rng.random(V) < 0.6).astype(np.float32)
    return a, z0, labels, mask


def test_fista_zlast_plain_matches_jax_past_255_steps(jx):
    """300 iterations, past the kernel's former cap of 256 steps. f32 on
    both sides with exps that differ by ulps: over 300 steps (values up to
    |z| ~ 4) that reaches ~4e-6 of the value, so 1e-5 absolute plus 1e-5
    of the value, the card tests' tolerance."""
    a, z0, labels, mask = _fista_np(64, 20, 12)
    kw = dict(nu=0.01, n_iters=300, n_classes=12)
    want = np.asarray(jx.ref.fista_zlast_ref(*_j(a, z0, labels, mask), **kw))
    got = tref.fista_zlast_ref(*_t(a, z0, labels, mask), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


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


def _flash_inputs(seed, B, Hq, Hkv, S, T, D, dtype):
    """numpy q [B,Hq,S,D], k, v [B,Hkv,T,D] rounded to ``dtype`` (a jnp
    dtype name), as f32 arrays."""
    import jax.numpy as jnp
    arrs = _np(seed, (B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))
    return [np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))
            for a in arrs]


def _bshd(a, dtype, device="cpu"):
    """[B,H,S,D] numpy -> the port's [B,S,H,D] layout, contiguous."""
    return torch.from_numpy(a).to(dtype).transpose(1, 2).contiguous().to(
        device)


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # the JAX test's


@pytest.mark.parametrize("B,H,S,T,D", [(1, 2, 128, 128, 64),
                                       (2, 1, 256, 256, 32),
                                       (1, 2, 64, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax(jx, B, H, S, T, D, dtype, causal):
    """The plain version against ``repro.kernels.ref.flash_attention_ref``
    at ``tests/test_kernels.py``'s shapes (the Pallas kernel itself is
    broken on the installed jax, so it is no oracle)."""
    import jax.numpy as jnp
    jdt = str(dtype).split(".")[-1]
    q, k, v = _flash_inputs(4, B, H, H, S, T, D, jdt)
    want = jx.ref.flash_attention_ref(*(jnp.asarray(a).astype(jdt)
                                        for a in (q, k, v)), causal=causal)
    got = tref.flash_attention_ref(*(_bshd(a, dtype) for a in (q, k, v)),
                                   causal=causal)
    assert got.dtype == dtype
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_gqa_matches_jax_on_expanded_kv(jx, dtype,
                                                              causal):
    """Ungrouped K/V (Hq 8 over Hkv 2) against the reference on K/V
    expanded with ``jnp.repeat``."""
    import jax.numpy as jnp
    jdt = str(dtype).split(".")[-1]
    q, k, v = _flash_inputs(5, 2, 8, 2, 96, 96, 32, jdt)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = jx.ref.flash_attention_ref(jq, jnp.repeat(jk, 4, axis=1),
                                      jnp.repeat(jv, 4, axis=1), causal=causal)
    got = tref.flash_attention_ref(*(_bshd(a, dtype) for a in (q, k, v)),
                                   causal=causal)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,T,q_offset", [(64, 64, 0), (40, 100, 60)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_bf16_p_matches_jax_attend_block(S, T, q_offset,
                                                               causal):
    """``p_dtype=bf16`` (the bf16 kernel's plain counterpart) against the
    JAX model's own attention, ``repro.models.layers._attend_block``
    (jitted), which rounds p to v's dtype before its PV product: the same
    bf16 roundings, so the outputs agree to 1 bf16 ulp of the largest
    output (2^-8 of it; the two einsums sum in another order before their
    one rounding), where the f32-P version lies about 10x farther."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    B, Hq, Hkv, D = 2, 8, 2, 32
    q, k, v = _np(14, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pos = q_offset + jnp.arange(S)
    want = jax.jit(jlayers._attend_block, static_argnums=4)(
        jq.reshape(B, S, Hkv, Hq // Hkv, D), jk, jv, pos, causal)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, S, Hq, D)
    tq_, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tref.flash_attention_ref(tq_, tk, tv, causal=causal,
                                   q_offset=q_offset, p_dtype=torch.bfloat16)
    f32p = tref.flash_attention_ref(tq_, tk, tv, causal=causal,
                                    q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    ulp = 2 ** -8 * float(np.abs(want).max())
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= ulp
    assert np.abs(f32p.float().numpy() - want).mean() > 5 * d.mean()


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
    c4 = codes.reshape(2, -1) >> 4
    np.testing.assert_array_equal(ops.pack_codes(c4, 4).numpy(),
                                  tref.pack_codes_ref(c4, 4).numpy())
    np.testing.assert_array_equal(
        ops.unpack_codes(ops.pack_codes(c4, 4), 4, c4.shape[1]).numpy(),
        c4.numpy())
    q, k, v = _t(*_np(8, (2, 16, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)))
    np.testing.assert_array_equal(
        ops.flash_attention(q, k, v, causal=True, q_offset=3).numpy(),
        tref.flash_attention_ref(q, k, v, causal=True, q_offset=3).numpy())
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_MODULES, 0)
    assert set(ops.KERNEL_MODULES) == {
        "fused_linear", "admm_pgrad", "relu_zupdate", "fista_zlast",
        "backtrack_resnorm", "grid_project", "grid_encode", "grid_decode",
        "pack_codes", "unpack_codes", "flash_attention"}


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
                                           tq.integer_grid()),
             lambda: cuda_pack.pack_codes(p.to(torch.uint8), 4),
             lambda: cuda_pack.unpack_codes(p.to(torch.uint8), 16, 4),
             lambda: cuda_flash(p[None, :, None], p[None, :, None],
                                p[None, :, None])]
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
    """The only cap on the classes (the softmax width) is the row's width:
    any count from 1 to N reaches the CUDA check, whatever route it takes
    (the distributed runtime's head-folded [V, h] layer at 7 classes,
    block-pdADMM's CE route at h), and more classes than columns raise."""
    a = torch.zeros(4, 1000)
    args = (a, a, torch.zeros(4, dtype=torch.int32), torch.ones(4))
    for n_classes in (7, 65, 1000):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_fista_zlast(*args, nu=0.1, n_iters=1, n_classes=n_classes)
    for n_classes in (0, 1001):
        with pytest.raises(ValueError, match="n_classes"):
            cuda_fista_zlast(*args, nu=0.1, n_iters=1, n_classes=n_classes)
    assert [fista_route(c) for c in (1, 64, 65, 2048, 2049, 19349, 19350)] \
        == ["lanes", "lanes", "registers", "registers", "shared", "shared",
            "streaming"]


def test_fista_zlast_routes_match_the_source():
    """The wrapper's route bounds (which allocate the streaming route's
    scratch) are the CUDA source's, read from its constants."""
    import re

    from repro_torch.kernels import fista_zlast as fz
    text = (build.CSRC / "fista_zlast.cu").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert fz.LANE_CLASSES == c["LANE_CLASSES"]
    assert fz.REG_CLASSES == c["WIDE_THREADS"] * c["WIDE_PER"]
    # the reduction slots (two floats a warp) are static shared memory
    assert fz.SMEM_CLASSES == ((c["SMEM_LIMIT"] - 2 * (c["MEM_THREADS"] // 32)
                                * 4) // 12)


def test_build_plan_compiles_every_source_for_sm90a(tmp_path, monkeypatch):
    cmds = build.compile_commands("nvcc", tmp_path)
    names = {c[c.index("-c") + 1].rsplit("/", 1)[-1] for c in cmds}
    assert names == {"fused_linear.cu", "admm_pgrad.cu", "relu_zupdate.cu",
                     "fista_zlast.cu", "backtrack_resnorm.cu",
                     "quantize_grid.cu", "pack_codes.cu",
                     "flash_attention.cu"}
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
    assert log.count("Used 8 registers") == len(build.sources()) == 8
    assert build.build() == lib          # cached: no second build


def test_fused_linear_k_splits():
    """K is split only where the tensor-core grid leaves the card's SMs
    unevenly loaded, and never for the row-parallel narrow outputs."""
    from repro_torch.kernels.fused_linear import k_splits
    assert k_splits(1, 2485, 1000, 5732, 132) == 4    # 160 tiles, 2 waves
    assert k_splits(1, 2485, 1000, 1000, 132) == 2
    assert k_splits(8, 2485, 1000, 1000, 132) == 1    # 1280 tiles
    assert k_splits(10, 2485, 1000, 1000, 132) == 1   # 12.5 vs 13 waves
    assert k_splits(1, 2485, 7, 1000, 132) == 1       # narrow
    assert k_splits(1, 300, 200, 1030, 132) == 2      # 33 slabs: not 4
    assert k_splits(1, 97, 40, 130, 132) == 1         # 5 slabs


@pytest.mark.parametrize("n_out,want", [
    (1000, "tensor_cores"),    # the hidden layers' r [2485, 1000]
    (7, "simt"),               # the last layer's r [2485, 7]
    (16, "simt"), (17, "tensor_cores"), (130, "tensor_cores")])
def test_admm_pgrad_route(n_out, want):
    """The 3xTF32 tile takes r wider than 16 columns; the SIMT tile the
    narrow last layer."""
    from repro_torch.kernels.admm_pgrad import route
    assert route(n_out) == want


@pytest.mark.parametrize("M,N,want_route,want_partials", [
    (2485, 1000, "tensor_cores", 20 * 8),   # hidden layers: 128x128 tiles
    (2485, 7, "rows", 78),                  # last layer: 32 rows a block
    (2485, 16, "rows", 78), (2485, 17, "tensor_cores", 20),
    (97, 40, "tensor_cores", 1), (300, 200, "tensor_cores", 3 * 2),
    (300, 7, "rows", 10)])
def test_backtrack_resnorm_route_and_partials(M, N, want_route,
                                              want_partials):
    """Pass 1 writes one partial per block of its route: per 128x128 output
    tile on the tensor cores, per 32 rows on the row-parallel route."""
    from repro_torch.kernels.backtrack_phi import partials_per_layer, route
    assert route(N) == want_route
    assert partials_per_layer(M, N) == want_partials


class _FakeLibrary:
    """Stands in for the CUDA library: records each entry point's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("n_out", [1000, 7])
def test_matmul_wrappers_pass_their_route(monkeypatch, n_out):
    """admm_pgrad and backtrack_resnorm hand C the route of their shape, and
    backtrack_resnorm sizes its partials for that route."""
    from repro_torch.kernels import admm_pgrad as pg
    from repro_torch.kernels import backtrack_phi as bt
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream_handle", lambda t: 0)
    monkeypatch.setattr(pg, "launches", 0)
    monkeypatch.setattr(bt, "launches", 0)
    L, V, h = 2, 300, 200
    r, W = torch.zeros(L, V, n_out), torch.zeros(L, h, n_out)
    u = torch.zeros(L, V, h)
    pg.admm_pgrad(r, W, u, u, u, nu=0.01, rho=1.0)
    args = lib.calls["admm_pgrad_f32"]
    assert args[6:10] == (L, V, n_out, h)
    assert args[-2] == int(pg.route(n_out) == "tensor_cores")
    r0, d, W = torch.zeros(L, V, n_out), torch.zeros(L, V, h), \
        torch.zeros(L, h, n_out)
    bt.backtrack_resnorm(r0, d, W)
    args = lib.calls["backtrack_resnorm_f32"]
    assert args[6:10] == (L, V, h, n_out)
    assert args[-3:-1] == (int(bt.route(n_out) == "tensor_cores"),
                           bt.partials_per_layer(V, n_out))
    assert pg.launches == bt.launches == 1


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: PTX's cvt.rna.tf32.f32 on the bit pattern."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_3xtf32(a, b, slab=32):
    """a @ b as the 3xTF32 tile core computes it: each operand split into
    hi = rna(x) and lo = rna(x − hi), each 32-wide slab of K summed from zero
    as lo·hi + hi·lo + hi·hi in f32, then added to the result in f32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], slab):
        k = slice(k0, k0 + slab)
        acc += (a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k]) + a_hi[:, k] @ b_hi[k]
    return acc


def _matmul_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


@pytest.mark.parametrize("case", ["pgrad", "resnorm", "resnorm_near_cancel"])
def test_3xtf32_emulation_holds_the_chip_limits(case):
    """A numpy emulation of the tile core's 3xTF32 arithmetic at [64, 1000] @
    [1000, 64] meets the limits chip_smoke.py holds the two kernels to:
    r @ Wᵀ within 1e-5 of max |f64| (MATMUL_REL_TOL), ||r0 − d W||² within
    rtol 1e-5 of the f64 value (RESNORM_RTOL). A single TF32 pass misses
    them where they have teeth: the product, and a residual 1% of d W."""
    rng = np.random.default_rng(21)
    M, K, N = 64, 1000, 64
    a = rng.normal(size=(M, K)).astype(np.float32)
    if case == "pgrad":       # r @ Wᵀ, W row-major [N, K]
        W = (rng.normal(size=(N, K)) / np.sqrt(K)).astype(np.float32)
        want = a.astype(np.float64) @ W.T.astype(np.float64)
        b = np.ascontiguousarray(W.T)

        def err(mm):
            return np.abs(mm(a, b) - want).max() / np.abs(want).max()
    else:
        W = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
        dW = a.astype(np.float64) @ W.astype(np.float64)
        r0 = rng.normal(size=(M, N))
        if case == "resnorm_near_cancel":
            r0 = dW + 0.01 * r0
        r0 = r0.astype(np.float32)
        want = ((r0 - dW) ** 2).sum()

        def err(mm):
            r = r0 - mm(a, W)
            return abs(float((r * r).sum(dtype=np.float32)) - want) / want
    assert err(_matmul_3xtf32) <= 1e-5
    if case != "resnorm":
        assert err(_matmul_1xtf32) > 1e-5


# --- CUDA kernels vs their plain versions (card only) ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lead,M,K,N", [
    ((), 97, 130, 40), ((), 2485, 300, 7), ((3,), 200, 64, 64),
    ((), 2485, 5732, 1000),          # layer 0: K split in 4 parts
    ((8,), 2485, 1000, 1000),        # the stacked hidden layers
    ((), 300, 1030, 200)])           # K split in 2, rows not 16-byte aligned
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
@pytest.mark.parametrize("lead,V,ni,no", [
    ((), 97, 130, 40), ((), 500, 64, 7), ((2,), 130, 96, 96),
    ((8,), 2485, 1000, 1000),        # the stacked hidden layers
    ((10,), 2485, 1000, 1000),       # the ring's
    ((), 2485, 1000, 7),             # the last layer: the SIMT route
    ((), 300, 200, 130),             # K = 130: 4-byte copies; ragged n_in
    ((2,), 97, 201, 130),            # odd n_in: no paired epilogue
    ((), 130, 96, 16), ((), 130, 96, 17),    # either side of the routes
    # the narrow route: n_out 1 and 15, n_in not a multiple of 4 (scalar
    # rows), the ring's stacked last layers, one row, n_out 16 at full size
    ((), 300, 1001, 1), ((), 300, 3, 15), ((10,), 2485, 1000, 7),
    ((), 1, 1000, 7), ((), 2485, 1000, 16)])
def test_cuda_admm_pgrad_matches_plain(cuda, lead, V, ni, no):
    r, W, u, p, q = _t(*_np(10, lead + (V, no), lead + (ni, no),
                            lead + (V, ni), lead + (V, ni), lead + (V, ni)),
                       device=cuda)
    got = cuda_admm_pgrad(r, W, u, p, q, nu=0.01, rho=1.0)
    want = tref.admm_pgrad_ref(r, W, u, p, q, nu=0.01, rho=1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # no atomics and no data-dependent order: the same bits on a second run
    assert torch.equal(got, cuda_admm_pgrad(r, W, u, p, q, nu=0.01, rho=1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 97, 130), (1000, 7)])
def test_cuda_relu_zupdate_matches_plain(cuda, shape):
    arrays = _np(11, shape, shape, shape)
    a, q, z0 = _t(*arrays, device=cuda)
    got = cuda_relu_zupdate(a, q, z0).cpu().numpy()
    want = tref.relu_zupdate_ref(a, q, z0).cpu().numpy()
    _assert_zupdate_tie_tolerant(got, want, *arrays)


def _fista_inputs(device, V, width, n_classes):
    a, z0 = _t(*_np(12, (V, width), (V, width), scale=2.0), device=device)
    rng = np.random.default_rng(13)
    labels = torch.from_numpy(rng.integers(0, n_classes, V).astype(np.int32))
    mask = torch.from_numpy((rng.random(V) < 0.6).astype(np.float32))
    return a, z0, labels.to(device), mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("V,width,n_classes,n_iters", [
    (300, 7, 7, 15), (300, 8, 5, 0), (300, 40, 40, 15), (300, 64, 33, 4),
    (300, 3, 3, 15), (300, 15, 15, 15),      # lane groups of 4 and 16
    (300, 1000, 7, 15),                      # the ring's head-folded layer
    (300, 1001, 7, 15),                      # odd width: row starts drift
    (300, 1000, 40, 15),                     # two columns a lane, wide rows
    (70001, 8, 7, 15),                       # V above gridDim.y's 65535
    (70001, 300, 7, 15),                     # row slots run out: the grid strides
    # a block a row: its class columns in registers (65 and 128: one column
    # a thread; 1000: four), head-folded with a ragged tail, past 255 steps
    (300, 65, 65, 15), (300, 128, 128, 15), (300, 1000, 1000, 15),
    (300, 1001, 100, 15), (300, 40, 40, 300), (300, 1000, 1000, 300),
    (70001, 66, 65, 15),                     # rows past the block slots
    (60, 5003, 4099, 15),                    # in shared memory (48 KB+)
    (24, 20003, 20000, 15),                  # streaming, a ragged tail
    (300, 20000, 20000, 4)])                 # streaming rows past the slots
def test_cuda_fista_zlast_matches_plain(cuda, V, width, n_classes, n_iters):
    a, z0, labels, mask = _fista_inputs(cuda, V, width, n_classes)
    kw = dict(nu=0.01, n_iters=n_iters, n_classes=n_classes)
    got = cuda_fista_zlast(a, z0, labels, mask, **kw)
    want = tref.fista_zlast_ref(a, z0, labels, mask, **kw)
    torch.cuda.synchronize()
    # expf and torch's exp differ by ulps and the row sums run in another
    # order; over 16 steps that is ~1e-6 of the value, so an absolute 1e-5
    # plus 1e-5 of the value on the class columns
    torch.testing.assert_close(got[:, :n_classes], want[:, :n_classes],
                               rtol=1e-5, atol=1e-5)
    # the proximal columns keep the plain version's roundings: bitwise
    assert torch.equal(got[:, n_classes:], want[:, n_classes:])


@pytest.mark.cuda
@pytest.mark.parametrize("V,width,n_classes", [
    (2485, 7, 7), (300, 1001, 40), (300, 1000, 1000), (60, 5003, 4099),
    (24, 20003, 20000)])
def test_cuda_fista_zlast_is_deterministic(cuda, V, width, n_classes):
    """No atomics; the group's shuffle reductions and the block-wide ones
    run in one fixed order."""
    a, z0, labels, mask = _fista_inputs(cuda, V, width, n_classes)
    kw = dict(nu=0.01, n_iters=15, n_classes=n_classes)
    assert torch.equal(cuda_fista_zlast(a, z0, labels, mask, **kw),
                       cuda_fista_zlast(a, z0, labels, mask, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,M,K,N", [
    ((), 97, 130, 40), ((), 2485, 1000, 7), ((3,), 200, 64, 64),
    ((8,), 130, 96, 70),
    ((8,), 2485, 1000, 1000),        # the stacked hidden layers
    ((10,), 2485, 1000, 1000),       # the ring's
    ((), 300, 130, 200),             # K = 130: 4-byte copies; ragged N
    ((2,), 97, 130, 131),            # odd N: no paired epilogue
    ((2,), 300, 130, 7),             # the row route with 4-byte loads
    ((), 130, 96, 16), ((), 130, 96, 17)])   # either side of the routes
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


@pytest.mark.cuda
@pytest.mark.parametrize("V,width,n_classes", [(300, 1000, 7), (2485, 1000, 7),
                                               (97, 130, 40), (64, 65, 64)])
def test_cuda_fista_zlast_wide_rows(cuda, V, width, n_classes):
    """Rows wider than the classes: the class columns at the FISTA
    tolerance, the proximal columns bit for bit."""
    a, z0 = _t(*_np(21, (V, width), (V, width), scale=2.0), device=cuda)
    rng = np.random.default_rng(22)
    labels = torch.from_numpy(rng.integers(0, n_classes, V)
                              .astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.random(V) < 0.6).astype(np.float32)).to(cuda)
    kw = dict(nu=0.01, n_iters=15, n_classes=n_classes)
    got = cuda_fista_zlast(a, z0, labels, mask, **kw)
    want = tref.fista_zlast_ref(a, z0, labels, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, :n_classes], want[:, :n_classes],
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[:, n_classes:], want[:, n_classes:])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 16])
@pytest.mark.parametrize("rows,n,pad,off,in_off", [
    (1, 2485 * 1000, 0, 0, 0), (1, 1001, 0, 0, 0), (3, 1001, 7, 0, 0),
    (4, 4096, 16, 0, 0), (2, 1, 0, 0, 0), (5, 33, 3, 0, 0),
    (10, 2485 * 1000, 0, 0, 0), (6, 4104, 0, 0, 0), (4, 4100, 0, 0, 0),
    (3, 1002, 2, 0, 0),
    # unpacking from containers whose first row starts 1, 2, 4 or 8 bytes
    # off a 16-byte boundary, at several waves of blocks
    (2, 2_000_001, 0, 1, 0), (2, 2_000_001, 3, 2, 0), (2, 2_000_000, 0, 4, 0),
    (2, 2_000_000, 5, 8, 0),
    # packing from codes whose first row starts 1, 2, 4 or 8 bytes off a
    # 16-byte boundary (16-bit codes: 2 for 1, a uint16 row starts at an
    # even byte), odd and even n
    (2, 2_000_001, 0, 0, 1), (2, 2_000_000, 3, 0, 2), (2, 2_000_001, 0, 0, 4),
    (2, 2_000_000, 5, 3, 8),
    # rows that are all head and tail (n 1..33), from misaligned starts
    (3, 1, 0, 0, 1), (4, 2, 1, 0, 2), (3, 7, 2, 1, 4), (5, 15, 0, 0, 8),
    (2, 16, 3, 0, 1), (4, 17, 1, 2, 2), (3, 31, 0, 0, 4), (6, 32, 5, 0, 1),
    (3, 33, 2, 4, 8)])
def test_cuda_pack_codes_equal_plain_bitwise(cuda, bits, rows, n, pad, off,
                                             in_off):
    """Every row offset (row strides that leave rows 8, 4 or 1 bytes off a
    16-byte boundary, as the ring's [10, 2,485,000] batch does), odd n,
    batched rows, packing from codes whose first row starts ``in_off``
    bytes off a 16-byte boundary, and unpacking from the head of wider
    rows, the container itself ``off`` bytes off a 16-byte boundary."""
    rng = np.random.default_rng(n + rows)
    dt = torch.uint8 if bits <= 8 else torch.uint16
    skip = (in_off + 1) // 2 if bits > 8 else in_off    # codes before row 0
    flat_codes = torch.from_numpy(rng.integers(
        0, 2 ** bits, skip + rows * (n + pad)).astype(np.int32)).to(dt).to(cuda)
    assert flat_codes.data_ptr() % 16 == 0
    wide = flat_codes[skip:].view(rows, n + pad)
    codes = wide[:, :n]
    if rows == 1:
        codes = codes[0]
    got = cuda_pack.pack_codes(codes, bits)
    want = tref.pack_codes_ref(codes.cpu(), bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    nb = got.shape[-1]
    flat = torch.zeros(off + rows * (nb + pad), dtype=torch.uint8,
                       device=cuda)
    room = flat[off:].view(got.shape[:-1] + (nb + pad,))
    room[..., :nb] = got
    back = cuda_pack.unpack_codes(room, bits, n)
    torch.cuda.synchronize()
    assert back.dtype == dt
    assert torch.equal(back.cpu().to(torch.int32),
                       tref.unpack_codes_ref(room.cpu(), bits, n)
                       .to(torch.int32))
    assert torch.equal(back.cpu().to(torch.int32),
                       codes.cpu().to(torch.int32))



@pytest.mark.cuda
@pytest.mark.parametrize("sel", [[0, 2, 1, 0, 2, 1, 1, 0, 2, 0],
                                 [2, 2, 0, 0, 2, 0, 0, 2, 2, 0],
                                 [1]])
@pytest.mark.parametrize("n", [2485 * 1000, 1001, 33])
def test_cuda_predicated_wire_kernels_equal_plain_bitwise(cuda, sel, n):
    """The row-predicated encode, pack, unpack and decode at each width of
    a 4/8/16 wire, over 2 x len(sel) rows (stage r % len(sel)): the rows
    at the width written as the plain versions write them, every other
    row as it was (a width no stage runs at leaves all as they were)."""
    grids = [tq.uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)]
    rows = 2 * len(sel)
    sel_t = torch.tensor(sel, dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(n + len(sel))
    x = torch.from_numpy((rng.random((rows, n)) * 9.0 - 2.5)
                         .astype(np.float32)).to(cuda)
    cap = 2 * n + 5                      # rows of a wider, odd container
    for k, (bits, grid) in enumerate(zip((4, 8, 16), grids)):
        fill = torch.full((rows, n), 3, dtype=grid.code_dtype, device=cuda)
        got = cuda_grid.grid_encode_sel(x, grid, fill.clone(), sel_t, k)
        want = tref.grid_encode_sel_ref(x, grid, fill.clone(), sel_t, k)
        torch.cuda.synchronize()
        assert torch.equal(got.to(torch.int32), want.to(torch.int32))
        box = torch.full((rows, cap), 7, dtype=torch.uint8, device=cuda)
        if bits != 8:
            packed = cuda_pack.pack_codes_sel(want, bits, box.clone(), sel_t,
                                              k)
            ref_packed = tref.pack_codes_sel_ref(want, bits, box.clone(),
                                                 sel_t, k)
            torch.cuda.synchronize()
            assert torch.equal(packed, ref_packed)
            codes = cuda_pack.unpack_codes_sel(ref_packed, bits, fill.clone(),
                                               sel_t, k)
            ref_codes = tref.unpack_codes_sel_ref(ref_packed, bits,
                                                  fill.clone(), sel_t, k)
            torch.cuda.synchronize()
            assert torch.equal(codes.to(torch.int32),
                               ref_codes.to(torch.int32))
        out = torch.full((rows, n), -1.0, device=cuda)
        dec = cuda_grid.grid_decode_sel(want, grid, out.clone(), sel_t, k)
        ref_dec = tref.grid_decode_sel_ref(want, grid, out.clone(), sel_t, k)
        torch.cuda.synchronize()
        assert torch.equal(dec, ref_dec)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,q_offset", [
    (1, 2, 2, 128, 128, 64, 0), (2, 1, 1, 256, 256, 32, 0),
    (1, 2, 2, 64, 64, 128, 0),                   # tests/test_kernels.py's
    (2, 32, 4, 256, 256, 64, 0),                 # GQA, tinyllama's heads
    (1, 4, 2, 1000, 1000, 64, 0),                # ragged S and T
    (2, 4, 1, 100, 300, 64, 200),                # q_offset > 0
    (1, 4, 2, 200, 200, 96, 0), (1, 4, 2, 200, 200, 128, 0),
    (1, 2, 1, 77, 77, 16, 0),
    (1, 24, 8, 130, 130, 64, 0),                 # granite-moe's heads, G 3
    (1, 28, 4, 130, 130, 128, 0)])               # qwen2-vl's heads, G 7
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(cuda, B, Hq, Hkv, S, T, D,
                                            q_offset, dtype, causal):
    jdt = "float32" if dtype == torch.float32 else "bfloat16"
    q, k, v = (_bshd(a, dtype, cuda)
               for a in _flash_inputs(12, B, Hq, Hkv, S, T, D, jdt))
    got = cuda_flash(q, k, v, causal=causal, q_offset=q_offset)
    want = tref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_takes_strided_heads(cuda):
    """q, k, v as [B,S,H,D] views of [B,H,S,D] tensors (strides passed to
    the kernel, no copy), and the count of launches."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.from_numpy(a).to(cuda).transpose(1, 2)
               for a in _flash_inputs(13, 2, 8, 2, 130, 130, 64, "float32"))
    assert not q.is_contiguous()
    before = fa.launches
    got = cuda_flash(q, k, v)
    want = tref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_flash(q[..., :48], k[..., :48], v[..., :48])


FLASH_BF16_FACTOR = 1.1   # chip_smoke.py's rule for the bf16 route


def _assert_flash_bf16(got, q, k, v, causal=True, q_offset=0):
    """The bf16 route (P rounded to bf16) against the plain version with f32
    P: its relative L2 distance, over the whole output and over every block
    of 64 query positions (a ragged tail joins the block before it, so
    that no block holds a handful of rows), at most 1.1 x that of the plain
    version with bf16 P (``p_dtype``); the JAX test's rtol = atol = 3e-2 as
    a ceiling."""
    kw = dict(causal=causal, q_offset=q_offset)
    want = tref.flash_attention_ref(q, k, v, **kw).float()
    plain = tref.flash_attention_ref(q, k, v, p_dtype=torch.bfloat16,
                                     **kw).float()
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got = got.float()
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)

    def dist(x):   # whole, then per block of 64 query positions (a ragged
        d = (x - want).square().sum(dim=(0, 2, 3))   # tail joins the last)
        w = want.square().sum(dim=(0, 2, 3))
        n = max(d.numel() // 64, 1)
        blk = (torch.arange(d.numel(), device=d.device) // 64).clamp(max=n - 1)
        zero = torch.zeros(n, device=d.device)
        return ((d.sum() / w.sum()).sqrt(),
                (zero.index_add(0, blk, d) / zero.index_add(0, blk, w)).sqrt())
    (gk, bk), (gp, bp) = dist(got), dist(plain)
    assert float(gk / gp) <= FLASH_BF16_FACTOR
    assert float((bk / bp).max()) <= FLASH_BF16_FACTOR


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,q_offset", [
    (1, 4, 2, 200, 200, 16, 0), (2, 4, 1, 77, 300, 16, 223),
    (1, 4, 2, 1000, 1000, 32, 0), (2, 4, 1, 100, 300, 32, 200),
    (2, 32, 4, 256, 256, 64, 0), (1, 4, 2, 130, 450, 64, 320),
    (1, 4, 4, 200, 200, 96, 0), (1, 4, 2, 100, 300, 96, 200),
    (1, 4, 2, 200, 200, 128, 0), (2, 4, 1, 100, 300, 128, 200),
    (2, 24, 8, 200, 200, 64, 0),                 # granite-moe: G 3
    (1, 28, 4, 200, 200, 128, 0),                # qwen2-vl: G 7
    (1, 64, 4, 100, 300, 128, 200)])             # qwen3-moe: G 16
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bf16_tensor_cores(cuda, B, Hq, Hkv, S, T, D,
                                                q_offset, causal):
    """The wgmma route at every head dimension, ragged S and T, q_offset >
    0, causal and full, held by the bf16 rule."""
    q, k, v = (_bshd(a, torch.bfloat16, cuda)
               for a in _flash_inputs(15, B, Hq, Hkv, S, T, D, "bfloat16"))
    got = cuda_flash(q, k, v, causal=causal, q_offset=q_offset)
    _assert_flash_bf16(got, q, k, v, causal, q_offset)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_takes_strided_heads(cuda):
    """bf16 q, k, v as [B,S,H,D] views of [B,H,S,D] tensors (strides
    passed to the kernel, no copy), and the count of launches."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).to(cuda).transpose(1, 2)
               for a in _flash_inputs(16, 2, 8, 2, 130, 130, 64, "bfloat16"))
    assert not q.is_contiguous()
    before = fa.launches
    got = cuda_flash(q, k, v)
    assert fa.launches == before + 1
    _assert_flash_bf16(got, q, k, v)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_autograd(cuda):
    """The kernel has no backward: under grad mode q, k or v that require
    grad raise, and nothing launches; under no_grad the same call runs and
    matches the plain version."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=cuda).manual_seed(14)
        q, k, v = (torch.randn((1, 128, h, 64), generator=gen, device=cuda)
                   .to(dtype).requires_grad_() for h in (8, 2, 2))
        before = fa.launches
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_flash(q, k, v)
        assert fa.launches == before
        with torch.no_grad():
            got = cuda_flash(q, k, v)
            want = tref.flash_attention_ref(
                q, k, v, p_dtype=None if dtype == torch.float32 else dtype)
        torch.cuda.synchronize()
        assert fa.launches == before + 1 and got.grad_fn is None
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_refuses_unaligned_layouts(cuda):
    """The bf16 route copies 16-byte chunks: a row stride that is not a
    multiple of 8 elements, or data off a 16-byte boundary, raises (no copy,
    no other route); the f32 route takes both."""
    B, S, H, D = 1, 64, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        pitch = torch.randn(B, S, H, D + 4, device=cuda).to(dtype)[..., :D]
        offset = torch.randn(B, S, H, D + 8, device=cuda).to(dtype)[..., 4:-4]
        for x in (pitch, offset):
            assert x.stride(-1) == 1 and x.shape[-1] == D
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="16-byte"):
                    cuda_flash(x, x, x)
                continue
            got = cuda_flash(x, x, x)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, tref.flash_attention_ref(x, x, x), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_stream_handle_is_the_current_stream(cuda):
    """Kernels launch on PyTorch's current stream, a side stream included."""
    x = torch.zeros(4, device=cuda)
    assert build.stream_handle(x) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert build.stream_handle(x) == side.cuda_stream
