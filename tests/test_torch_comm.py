"""The port's wire codecs and byte ledger against the JAX reference.

Bitwise where the reference is exact: packed bytes, deterministic codes and
their decode (against the jitted reference, the arithmetic it trains with),
byte accounting, and every ledger total as an integer. Stochastic rounding
draws from a ``torch.Generator`` where the reference takes a ``jax.random``
key, so it is held only to what both must satisfy: unbiasedness and the
error-feedback bound, as ``tests/test_comm.py`` does for the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jc
from repro.comm import ledger as jl
from repro.core import quantize as jq
from repro_torch.comm import codecs as tc
from repro_torch.comm import ledger as tl
from repro_torch.core import quantize as tq

BITS = [4, 8, 16]


def _codes(bits, n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** bits, n) \
        .astype(np.uint8 if bits <= 8 else np.uint16)


@pytest.mark.parametrize("n", [1, 7, 64, 1001])
@pytest.mark.parametrize("bits", BITS)
def test_packed_bytes_bitwise(bits, n):
    codes = _codes(bits, n, seed=n)
    pj = np.asarray(jc.pack_codes_jnp(jnp.asarray(codes), bits))
    pt = tc.pack_codes_jnp(torch.from_numpy(codes.astype(np.int32))
                           .to(tc._container_dtype(bits)), bits)
    assert pt.dtype == torch.uint8 and pj.dtype == np.uint8
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert pt.numel() == tc._body_bytes(bits, n) == jc._body_bytes(bits, n)
    back = tc.unpack_codes_jnp(pt, bits, n)
    assert back.dtype == tc._container_dtype(bits)
    np.testing.assert_array_equal(back.to(torch.int32).numpy(),
                                  codes.astype(np.int32))
    np.testing.assert_array_equal(
        back.to(torch.int32).numpy(),
        np.asarray(jc.unpack_codes_jnp(jnp.asarray(pj), bits, n))
        .astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 2, 5, 1000])
@pytest.mark.parametrize("bits", [1, 2, 4, 5, 8, 12, 16, 32])
def test_body_bytes_equal(bits, n):
    assert tc._body_bytes(bits, n) == jc._body_bytes(bits, n)


def _pair(make):
    return make(jq, jc), make(tq, tc)


CODECS = [
    ("fp32", lambda q, c: c.Fp32Codec()),
    ("grid4", lambda q, c: c.GridCodec(q.uniform_grid(4, -2.0, 6.0))),
    ("grid8", lambda q, c: c.GridCodec(q.uniform_grid(8, -2.0, 6.0))),
    ("grid16", lambda q, c: c.GridCodec(q.uniform_grid(16, -2.0, 6.0))),
    ("int_grid", lambda q, c: c.GridCodec(q.integer_grid())),
    ("affine4", lambda q, c: c.AffineCodec(4)),
    ("affine8", lambda q, c: c.AffineCodec(8)),
    ("affine16", lambda q, c: c.AffineCodec(16)),
]


@pytest.mark.parametrize("name,make", CODECS, ids=[c[0] for c in CODECS])
def test_deterministic_encode_decode_bitwise(name, make):
    cj, ct = _pair(make)
    assert (cj.name, cj.bits) == (ct.name, ct.bits)
    x = (np.random.default_rng(3).normal(size=(37, 5)) * 3 + 1) \
        .astype(np.float32)
    x[0, 0] = np.float32(5.984314441680908)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pj = jax.jit(cj.encode)(xj)
    pt = ct.encode(xt)
    assert str(pt.codes.dtype).split(".")[-1] == np.asarray(pj.codes).dtype.name
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(pj.codes))
    for a, b in ((pt.scale, pj.scale), (pt.zero, pj.zero)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dj = jax.jit(lambda p: cj.decode(p, shape=x.shape))(pj)
    dt = ct.decode(pt, shape=x.shape)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    for shape in ((37, 5), (3, 11, 2), (1,)):
        assert ct.payload_bytes(shape) == cj.payload_bytes(shape)
    assert ct.header_bytes() == cj.header_bytes()
    # fake_quantize = decode(encode(x)). Under ONE jit XLA folds the
    # clipped top code's lo + ix·step with two roundings where the jitted
    # halves fuse it (ROADMAP Queue 3), so it is held against the halves.
    np.testing.assert_array_equal(tc.fake_quantize(ct, xt).numpy(),
                                  np.asarray(dj))


def test_codec_factories_match():
    for args in ((32,), (8,), (4,), (16,), (8, -1.0, 3.0), (4, 0.0, 1.0)):
        a, b = jc.codec_for_bits(*args), tc.codec_for_bits(*args)
        assert type(a).__name__ == type(b).__name__
        assert (a.name, a.bits) == (b.name, b.bits)
    assert tc.codec_for_grid(None) is tc.FP32
    g = tq.integer_grid()
    assert tc.codec_for_grid(g) == tc.GridCodec(g)
    with pytest.raises(ValueError, match="container"):
        tc.AffineCodec(20)
    with pytest.raises(ValueError, match="shape"):
        tc.GridCodec(tq.uniform_grid(4, 0.0, 1.0)).decode(
            tc.WirePayload(torch.zeros(2, dtype=torch.uint8), None, None))


@pytest.mark.parametrize("bits", BITS)
def test_grid_codec_roundtrip_error_bound(bits):
    grid = tq.uniform_grid(bits, -2.0, 6.0)
    codec = tc.GridCodec(grid)
    x = torch.rand((37, 5), generator=torch.Generator().manual_seed(0)) * 8 - 2
    dec = codec.decode(codec.encode(x), shape=x.shape)
    assert dec.shape == x.shape
    assert float((dec - x).abs().max()) <= grid.step / 2 + 1e-6


@pytest.mark.parametrize("codec", [tc.GridCodec(tq.uniform_grid(4, -1.0, 1.0)),
                                   tc.AffineCodec(4)], ids=["grid4", "affine4"])
def test_stochastic_rounding_is_unbiased(codec):
    """A generator makes the rounding stochastic: each draw lands on a
    neighbouring level, and the mean over draws converges on x."""
    x = torch.linspace(-0.9, 0.9, 257)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tc.fake_quantize(codec, x, generator=gen)
                         for _ in range(400)])
    det = tc.fake_quantize(codec, x)
    step = float(draws.max() - draws.min()) / 15 if isinstance(
        codec, tc.AffineCodec) else codec.grid.step
    assert float((draws - x).abs().max()) <= step + 1e-6
    assert not torch.equal(draws[0], det) or not torch.equal(draws[0], draws[1])
    # the standard error of a 400-draw mean of a {0, step} variable is at
    # most step / 40; 5 standard errors
    assert float((draws.mean(0) - x).abs().max()) <= 5 * step / 40


def test_error_feedback_unbiased_over_rounds():
    """The carried residual keeps the cumulative transmitted mean within one
    round's quantization error of the true mean."""
    codec = tc.GridCodec(tq.uniform_grid(4, -1.0, 1.0))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=256)
                         .astype(np.float32)) * 0.3
    err = torch.zeros_like(x)
    sent_sum = torch.zeros_like(x)
    one_round = None
    for k in range(32):
        _, sent, err = tc.encode_with_error_feedback(codec, x, err)
        sent_sum = sent_sum + sent
        if k == 0:
            one_round = float((sent - x).abs().max())
    drift = float((sent_sum / 32 - x).abs().max())
    assert drift <= one_round + 1e-6
    plain = codec.decode(codec.encode(x), shape=x.shape)
    assert drift <= float((plain - x).abs().max()) + 1e-6
    # one deterministic feedback round equals the reference's (its encode
    # and decode jitted apart, as in test_deterministic_encode_decode_bitwise)
    cj = jc.GridCodec(jq.uniform_grid(4, -1.0, 1.0))
    xj = jnp.asarray(x.numpy())
    pj = jax.jit(cj.encode)(xj)
    sent_j = jax.jit(lambda p: cj.decode(p, shape=x.shape))(pj)
    _, sent_t, err_t = tc.encode_with_error_feedback(
        codec, x, torch.zeros_like(x))
    np.testing.assert_array_equal(sent_t.numpy(), np.asarray(sent_j))
    np.testing.assert_array_equal(err_t.numpy(), np.asarray(xj - sent_j))


# --- ledger --------------------------------------------------------------------

def _dims_cases():
    return [("G", [5732] + [1000] * 9 + [7], None, None),
            ("GQ8", [5732] + [1000] * 9 + [7], "u8", "u8"),
            ("GQint", [3703, 100, 100, 100, 6], "int", "int"),
            ("mixed", [50, 16, 24, 8, 3], "u4", None)]


GRID_OF = {"u8": lambda q: q.uniform_grid(8, -2.0, 6.0),
           "u4": lambda q: q.uniform_grid(4, 0.0, 15.0),
           "int": lambda q: q.integer_grid(), None: lambda q: None}


@pytest.mark.parametrize("name,dims,pg,qg", _dims_cases(),
                         ids=[c[0] for c in _dims_cases()])
def test_admm_bytes_per_iteration_equal(name, dims, pg, qg):
    V = 2485
    cj = [jc.codec_for_grid(GRID_OF[g](jq)) for g in (pg, qg)]
    ct = [tc.codec_for_grid(GRID_OF[g](tq)) for g in (pg, qg)]
    want = jl.admm_bytes_per_iteration(dims, V, *cj)
    got = tl.admm_bytes_per_iteration(dims, V, *ct)
    assert isinstance(got, int) and got == want
    for u in (jc.AffineCodec(8), jc.GridCodec(jq.uniform_grid(8, -1.0, 1.0))):
        ut = (tc.AffineCodec(8) if isinstance(u, jc.AffineCodec)
              else tc.GridCodec(tq.uniform_grid(8, -1.0, 1.0)))
        assert tl.admm_bytes_per_iteration(dims, V, *ct, ut) == \
            jl.admm_bytes_per_iteration(dims, V, *cj, u)


def _fill(mod, cmod, qmod):
    led = mod.CommLedger()
    dims = [40, 16, 16, 16, 5]
    per_p = [cmod.GridCodec(qmod.uniform_grid(b, -1.0, 3.0))
             for b in (4, 8, 16)]
    mod.record_admm_iteration(led, 0, dims, 33, cmod.FP32, cmod.FP32)
    mod.record_admm_iteration(led, 1, dims, 33, per_p,
                              cmod.GridCodec(qmod.integer_grid()),
                              cmod.AffineCodec(8))
    led.record(2, "grad_psum/W0", "psum", 1000, 8, wire_bytes=4000)
    led.record_handshake(2, "grad_psum/W0")
    led.record(2, "hdr/l0", "header", 2, 32, 8)
    led.record_span(3, 4, "q_fwd/l0", "ppermute", 100, 4)
    led.record_fault(5, "q_fwd/l1", "injected")
    led.record_fault(5, "q_fwd/l1", "detected", 2, "checksum")
    led.record_fault(6, "step", "rolled_back")
    other = mod.CommLedger()
    other.record(7, "p_bwd/l0", "ppermute", 9, 16, 18)
    return led.merge(other)


def test_ledger_rollups_equal():
    lj, lt = _fill(jl, jc, jq), _fill(tl, tc, tq)
    assert [tuple(vars(r).values()) for r in lt.records] == \
        [tuple(vars(r).values()) for r in lj.records]
    assert [tuple(vars(f).values()) for f in lt.faults] == \
        [tuple(vars(f).values()) for f in lj.faults]
    for method in ("total_bytes", "total_wire_bytes", "per_edge_wire",
                   "per_iteration", "per_edge", "fault_counts",
                   "baseline_fp32_bytes", "savings_vs_fp32", "summary"):
        assert getattr(lt, method)() == getattr(lj, method)(), method
    for it in range(8):
        assert lt.iteration_bytes(it) == lj.iteration_bytes(it)
        assert lt.per_edge_iteration_wire(it) == lj.per_edge_iteration_wire(it)
    assert isinstance(lt.total_bytes(), int)
    empty_j, empty_t = jl.CommLedger(), tl.CommLedger()
    assert empty_t.summary() == empty_j.summary()
    assert "faults" not in empty_t.summary()
