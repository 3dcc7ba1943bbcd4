"""Parity of the port's data path with the JAX reference: datasets, graph
ops and quantization grids, on the CPU.

Datasets are numpy up to the final conversion, so they must be bitwise
equal. ``augment_features`` is held at rtol 1e-6: the port's ``index_add_``
and the reference's segment-sum may add in another order (on the CPU they
happen to agree bitwise today).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.graph import datasets as jd
from repro.graph import ops as jops
from repro_torch.core import quantize as tq
from repro_torch.graph import datasets as td
from repro_torch.graph import ops as tops

DATASETS = [
    ("tiny", lambda m: m.tiny(**({"device": "cpu"} if m is td else {}))),
    ("citeseer", lambda m: m.synthetic(
        "citeseer", seed=0, scale=0.03,
        **({"device": "cpu"} if m is td else {}))),
]


@pytest.mark.parametrize("name,make", DATASETS, ids=[d[0] for d in DATASETS])
def test_datasets_bitwise(name, make):
    dj, dt = make(jd), make(td)
    assert dj.n_classes == dt.n_classes and dj.name == dt.name
    assert dj.graph.n_nodes == dt.graph.n_nodes
    for a, b in ((dj.labels, dt.labels), (dj.graph.src, dt.graph.src),
                 (dj.graph.dst, dt.graph.dst),
                 (dj.graph.weight, dt.graph.weight)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    assert set(dj.masks) == set(dt.masks)
    for k in dj.masks:
        np.testing.assert_array_equal(np.asarray(dj.masks[k]),
                                      dt.masks[k].numpy())
    np.testing.assert_allclose(dt.features.numpy(), np.asarray(dj.features),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,make", DATASETS, ids=[d[0] for d in DATASETS])
@pytest.mark.parametrize("k_hops", [1, 4])
def test_augment_features(name, make, k_hops):
    dj, dt = make(jd), make(td)
    xj, xt = np.asarray(dj.augmented(k_hops)), dt.augmented(k_hops).numpy()
    assert xj.shape == xt.shape
    np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-7)


def test_spmm_and_row_normalize_on_shared_input():
    rng = np.random.default_rng(3)
    n = 40
    src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
    gj = jops.renormalized_adjacency(n, src, dst)
    gt = tops.renormalized_adjacency(n, src, dst, device="cpu")
    assert gt.n_edges == gj.n_edges
    h = rng.normal(size=(n, 5)).astype(np.float32)
    np.testing.assert_allclose(tops.spmm(gt, torch.from_numpy(h)).numpy(),
                               np.asarray(jops.spmm(gj, jnp.asarray(h))),
                               rtol=1e-6, atol=1e-7)
    h[3] = 0.0                       # the 1e-9 floor on an all-zero row
    # the row sums may be taken in another order: rtol 1e-6
    np.testing.assert_allclose(
        tops.row_normalize(torch.from_numpy(h)).numpy(),
        np.asarray(jops.row_normalize(jnp.asarray(h))), rtol=1e-6, atol=0)


GRIDS = [("int", lambda m: m.integer_grid()),
         ("u8", lambda m: m.uniform_grid(8, -2.0, 6.0)),
         ("u16", lambda m: m.uniform_grid(16, -4.0, 4.0)),
         ("u4", lambda m: m.uniform_grid(4, 0.0, 15.0))]


# where true division and the jitted reference's reciprocal multiply part:
# uniform_grid(8, -2, 6) gives code 255 by (x - lo) / step, 254 under jit
WITNESS = np.float32(5.984314441680908)


@pytest.mark.parametrize("name,make", GRIDS, ids=[g[0] for g in GRIDS])
def test_quant_grid_bitwise(name, make):
    """index/project/encode/decode equal the jitted reference bit for bit
    (the reference trains under jit: a reciprocal multiply for the division
    by step, one fused multiply-add for lo + ix·step)."""
    gj, gt = make(jq), make(tq)
    assert (gj.lo, gj.step, gj.n_levels, gj.bits, gj.hi) == \
        (gt.lo, gt.step, gt.n_levels, gt.bits, gt.hi)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 33)) * 6.0).astype(np.float32)
    # exact .5 ties on the grid's own lattice, both parities, and the clip
    ties = (gt.lo + (np.arange(-3, 40) + 0.5) * gt.step).astype(np.float32)
    x[0, :33] = ties[:33]
    x[1, :10] = ties[33:43]
    x[2, 0] = WITNESS
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(gt.index(xt).numpy(),
                                  np.asarray(jax.jit(gj.index)(xj)))
    np.testing.assert_array_equal(gt.project(xt).numpy(),
                                  np.asarray(jax.jit(gj.project)(xj)))
    enc_j, enc_t = np.asarray(jax.jit(gj.encode)(xj)), gt.encode(xt)
    assert str(enc_t.dtype).split(".")[-1] == enc_j.dtype.name
    np.testing.assert_array_equal(enc_t.to(torch.int32).numpy(),
                                  enc_j.astype(np.int32))
    np.testing.assert_array_equal(
        gt.decode(enc_t).numpy(),
        np.asarray(jax.jit(gj.decode)(jnp.asarray(enc_j))))


def test_quant_grid_witness_takes_the_jitted_code():
    gj, gt = jq.uniform_grid(8, -2.0, 6.0), tq.uniform_grid(8, -2.0, 6.0)
    xt = torch.tensor([WITNESS])
    assert int(jax.jit(gj.encode)(jnp.asarray([WITNESS]))[0]) == 254
    assert int(gt.encode(xt)[0]) == 254
    assert float(gt.index(xt)[0]) == 254.0
    # true division would round the other way: the fault this pins
    assert round(float((xt[0] - gt.lo) / gt.step)) == 255


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quant_grid_matches_jit_on_a_dense_sweep(bits):
    """2^17 uniform draws over and past the range: every code, projection
    and decoded value equal to the jitted reference's."""
    gj, gt = jq.uniform_grid(bits, -2.0, 6.0), tq.uniform_grid(bits, -2.0, 6.0)
    x = np.random.default_rng(bits).uniform(-2.5, 6.5, 1 << 17) \
        .astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(gt.project(xt).numpy(),
                                  np.asarray(jax.jit(gj.project)(xj)))
    codes = gt.encode(xt)
    np.testing.assert_array_equal(codes.to(torch.int32).numpy(),
                                  np.asarray(jax.jit(gj.encode)(xj))
                                  .astype(np.int32))
    np.testing.assert_array_equal(
        gt.decode(codes).numpy(),
        np.asarray(jax.jit(gj.decode)(jax.jit(gj.encode)(xj))))


def test_calibrated_grid_matches():
    x = np.random.default_rng(1).normal(size=(50, 7)).astype(np.float32)
    gj = jq.calibrated_grid(8, jnp.asarray(x), margin=0.1)
    gt = tq.calibrated_grid(8, torch.from_numpy(x), margin=0.1)
    assert (gj.lo, gj.step, gj.n_levels) == (gt.lo, gt.step, gt.n_levels)


@pytest.mark.parametrize("bits,axis", [(8, None), (4, None), (16, None),
                                       (8, 0), (8, 1)])
def test_affine_encode_decode_match_jit(bits, axis):
    """Deterministic affine codes and their decode equal the jitted
    reference's bit for bit."""
    x = (np.random.default_rng(bits).normal(size=(40, 9)) * 3) \
        .astype(np.float32)

    def jenc(v):
        return jq.affine_encode(v, bits=bits, axis=axis)

    cj, sj, zj = jax.jit(jenc)(jnp.asarray(x))
    ct, st, zt = tq.affine_encode(torch.from_numpy(x), bits=bits, axis=axis)
    assert str(ct.dtype).split(".")[-1] == np.asarray(cj).dtype.name
    np.testing.assert_array_equal(ct.to(torch.int32).numpy(),
                                  np.asarray(cj).astype(np.int32))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(
        tq.affine_decode(ct, st, zt).numpy(),
        np.asarray(jax.jit(jq.affine_decode)(cj, sj, zj)))
