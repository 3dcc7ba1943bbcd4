"""The port's dense LM (``repro_torch.models``) against the JAX reference.

Inputs are made with numpy from a seed; the reference's weights come from
``bundle.init(PRNGKey(0))`` and reach the port through
``models.interop.lm_params_from_numpy``. The reference runs jitted, as its
engine and launchers run it (under jit XLA multiplies by 1/127 where the
source divides: ``_kv_quant``'s scales).

Tolerances:
* f32 layers: rtol 1e-5, atol 1e-5 of the tensor's largest magnitude
  (sums in another order).
* bf16 layers: within 2 bf16 ulps at the tensor's largest magnitude. The
  matmuls agree bit for bit; XLA on the CPU evaluates a bf16 ``silu`` with
  a rounding after each step of 1/(1+exp(-x)) and PyTorch rounds once, and
  an output near zero is a difference of larger terms.
* int8 KV codes and scales: bitwise.
* prefill and decode, f32: rtol 1e-4, atol 1e-5; bf16: 3e-2.
* The flash kernel's function against the reference's ``attention``: f32
  rtol 1e-5; bf16 3e-2, since the reference rounds the probabilities to
  bf16 before the PV product and the kernel does not (ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as j_get_arch
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models.interop import lm_params_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DENSE = ("tinyllama-1.1b", "yi-9b", "phi3-mini-3.8b", "granite-8b")


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """One numpy array as (jnp, torch) of ``dtype`` holding equal values."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, s = _np(0, (2, 8, 64), (64,))
    (jx, tx), (js, ts) = _pair(x * 3, dtype), _pair(s, dtype)
    _close(TL.rms_norm(tx, ts), jax.jit(JL.rms_norm)(jx, js), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_apply_rope_matches_jax(dtype, where):
    x, = _np(1, (2, 16 if where == "prefill" else 1, 4, 16), scale=2.0)
    pos = (np.arange(16)[None] if where == "prefill"
           else np.full((2, 1), 37))
    jx, tx = _pair(x, dtype)
    want = jax.jit(JL.apply_rope, static_argnums=2)(jx, jnp.asarray(pos),
                                                    10_000.0)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0), want, dtype)
    np.testing.assert_array_equal(TL.rope_freqs(16, 10_000.0).numpy(),
                                  np.asarray(JL.rope_freqs(16, 10_000.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,q_offset,causal", [
    (16, 1024, 0, True),       # Sq <= chunk: one block
    (32, 8, 0, True),          # Sq = 4 * chunk: the chunked path
    (32, 8, 5, True),          # with an offset
    (24, 1024, 0, False)])
def test_attention_matches_jax(dtype, S, chunk, q_offset, causal):
    q, k, v = _np(2, (2, S, 4, 16), (2, S + q_offset, 2, 16),
                  (2, S + q_offset, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jax.jit(lambda a, b, c: JL.attention(
        a, b, c, causal=causal, q_offset=q_offset, chunk=chunk))(jq, jk, jv)
    got = TL.attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                       chunk=chunk)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset", [0, 7])
def test_flash_function_is_the_reference_attention(dtype, q_offset):
    """What the kernel computes on the card (its plain version) against the
    reference's ``layers.attention`` with GQA and ``q_offset``: f32 at rtol
    1e-5; bf16 within 3e-2 (the reference rounds p to bf16 before PV)."""
    q, k, v = _np(3, (2, 24, 8, 32), (2, 24 + q_offset, 2, 32),
                  (2, 24 + q_offset, 2, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = _f32(jax.jit(lambda a, b, c: JL.attention(
        a, b, c, q_offset=q_offset))(jq, jk, jv))
    ops.reset_launch_counts()
    got = _f32(ops.flash_attention(tq, tk, tv, q_offset=q_offset))
    assert ops.launch_counts()["flash_attention"] == 0      # CPU: plain
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_attention_on_cpu_takes_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _np(4, (1, 8, 4, 16),
                                                (1, 8, 1, 16), (1, 8, 1, 16)))
    ops.reset_launch_counts()
    out = TL.attention(q, k, v)
    qg = q.reshape(1, 8, 1, 4, 16)
    want = TL._attend_block(qg, k, v, torch.arange(8), True).reshape(q.shape)
    assert torch.equal(out, want)
    assert ops.launch_counts()["flash_attention"] == 0


def _cache_inputs(seed, T=16):
    return _np(seed, (2, T, 2, 16), (2, T, 2, 16), (2, 1, 2, 16),
               (2, 1, 2, 16), (2, 1, 4, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [5, 15])
def test_cache_update_and_decode_attention_match_jax(dtype, length):
    kc, vc, kn, vn, q = _cache_inputs(5)
    (jkc, tkc), (jvc, tvc), (jkn, tkn), (jvn, tvn), (jq, tq) = (
        _pair(a, dtype) for a in (kc, vc, kn, vn, q))

    @jax.jit
    def ref(kc, vc, kn, vn, q, n):
        c = JL.cache_update(JL.KVCache(kc, vc, n), kn, vn)
        return c, JL.decode_attention(q, c)

    jc, jo = ref(jkc, jvc, jkn, jvn, jq, jnp.int32(length))
    tc = TL.cache_update(TL.KVCache(tkc, tvc, length), tkn, tvn)
    assert tc.length == int(jc.length) == length + 1
    np.testing.assert_array_equal(_f32(tc.k), _f32(jc.k))
    np.testing.assert_array_equal(_f32(tc.v), _f32(jc.v))
    _close(TL.decode_attention(tq, tc), jo, dtype)


def test_kv_quant_codes_bitwise_against_jitted_reference():
    x, = _np(6, (2, 64, 4, 16), scale=3.0)
    x[0, 0, 0] = 0.0                   # an all-zero row: the 1e-8 floor
    jc, js = jax.jit(JL._kv_quant)(jnp.asarray(x))
    tc, ts = TL._kv_quant(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_cache_matches_jax(dtype):
    kc, vc, kn, vn, q = _cache_inputs(7)
    jdt, tdt = DTYPES[dtype]
    jk8, jks = jax.jit(JL._kv_quant)(jnp.asarray(kc))
    jv8, jvs = jax.jit(JL._kv_quant)(jnp.asarray(vc))
    (jkn, tkn), (jvn, tvn), (jq, tq) = (_pair(a, dtype) for a in (kn, vn, q))

    @jax.jit
    def ref(k8, v8, ks, vs, kn, vn, q, n):
        c = JL.cache_update_q(JL.KVCacheQ(k8, v8, ks, vs, n), kn, vn)
        return c, JL.decode_attention_q(q, c, dtype=jdt)

    jc, jo = ref(jk8, jv8, jks, jvs, jkn, jvn, jq, jnp.int32(9))
    t = [torch.from_numpy(np.array(a)) for a in (jk8, jv8, jks, jvs)]
    tc = TL.cache_update_q(TL.KVCacheQ(*t, 9), tkn, tvn)
    assert tc.length == 10
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    _close(TL.decode_attention_q(tq, tc, dtype=tdt), jo, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    h, wg, wu, wd = _np(8, (2, 8, 64), (64, 128), (64, 128), (128, 64))
    pairs = [_pair(a, dtype) for a in (h, wg / 8, wu / 8, wd / 8)]
    want = jax.jit(JL.swiglu)(*(j for j, _ in pairs))
    _close(TL.swiglu(*(t for _, t in pairs)), want, dtype)


# --- prefill and decode on reduced tinyllama ------------------------------------

def _bundles(dtype, kv_bits=16):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_arch("tinyllama-1.1b").reduced(),
                               kv_cache_bits=kv_bits)
    tcfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                               kv_cache_bits=kv_bits)
    jb = japi.build(jcfg, make_host_mesh(), dtype=jdt)
    tb = tapi.build(tcfg, device="cpu", dtype=tdt)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["blocks"]["wq"].dtype == tdt     # bf16 stays bf16 (via f32)
    return jb, jp, tb, tp


def _prefill_decode(dtype, kv_bits=16, n_steps=8, max_len=64):
    """Prefill B=2 prompts of 16 tokens, then greedy-decode ``n_steps``
    tokens, in both packages (the reference jitted). For 8-bit KV the
    prefill cache is quantized with each package's ``_kv_quant``. Returns
    per step (JAX logits, port logits, JAX tokens, port tokens) and the two
    prefill caches."""
    jb, jp, tb, tp = _bundles(dtype, kv_bits)
    tokens = np.random.default_rng(9).integers(0, 256, (2, 16)).astype(
        np.int32)
    jl, jcache = jax.jit(lambda p, b: jb.prefill(p, b, max_len))(
        jp, {"tokens": jnp.asarray(tokens)})
    tl, tcache = tb.prefill(tp, {"tokens": torch.from_numpy(tokens)}, max_len)
    out = [(jl, tl, None, None)]
    caches = (jcache, TL.KVCache(tcache.k.clone(), tcache.v.clone(),
                                 tcache.length))
    if kv_bits == 8:
        q = jax.jit(JL._kv_quant)
        (jk, jks), (jv, jvs) = q(jcache.k), q(jcache.v)
        jcache = JL.KVCacheQ(jk, jv, jks, jvs, jcache.length)
        (tk, tks), (tv, tvs) = TL._kv_quant(tcache.k), TL._kv_quant(tcache.v)
        tcache = TL.KVCacheQ(tk, tv, tks, tvs, tcache.length)
    jstep = jax.jit(lambda p, s, b, n: jb.serve_step(p, s, b, length=n))
    jtok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
    ttok = tl[..., :256].argmax(-1).to(torch.int32)
    for i in range(n_steps):
        n = 16 + i
        jl, jcache = jstep(jp, jcache, {"token": jnp.asarray(jtok)},
                           jnp.int32(n))
        tl, tcache = tb.serve_step(tp, tcache, {"token": ttok}, length=n)
        out.append((jl, tl, jtok, ttok.numpy()))
        jtok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
        ttok = tl[..., :256].argmax(-1).to(torch.int32)
    return out, caches


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_prefill_then_decode_matches_jax_f32(kv_bits):
    out, (jc, tc) = _prefill_decode("float32", kv_bits)
    assert tc.k.shape == jc.k.shape == (2, 2, 64, 1, 16)
    assert tc.length == int(jc.length) == 16
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert not tc.k[:, :, 16:].any()              # padded to max_len
    for jl, tl, jtok, ttok in out:
        assert tl.shape == jl.shape == (2, 1, 256) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
        if jtok is not None:
            np.testing.assert_array_equal(ttok, jtok)


def test_prefill_then_decode_matches_jax_bf16():
    out, (jc, tc) = _prefill_decode("bfloat16", n_steps=4)
    assert tc.k.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tc.k), _f32(jc.k), rtol=3e-2, atol=3e-2)
    for jl, tl, _, _ in out:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                                   atol=3e-2)


def test_steps_and_state_shapes():
    """launch.steps' closures, the zero decode state and the inputs of a
    cell, on reduced tinyllama (bf16 weights, int8 cache too)."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    tb = tapi.build(cfg, device="cpu")
    params = tb.init(torch.Generator().manual_seed(0))
    assert params["blocks"]["wq"].dtype == torch.bfloat16
    shape = ShapeConfig("p", 32, 2, "prefill")
    batch = tb.make_inputs(shape, torch.Generator().manual_seed(1))
    assert batch["tokens"].shape == (2, 32) and batch["tokens"].max() < 256
    logits, cache = steps.make_prefill_step(tb, shape)(params, batch)
    assert logits.shape == (2, 1, tb.vocab_padded) and cache.length == 32
    dshape = ShapeConfig("d", 32, 2, "decode")
    state = tb.serve_state_shape(dshape)
    assert isinstance(state, TL.KVCache) and state.k.shape == (2, 2, 32, 1, 16)
    dbatch = tb.make_inputs(dshape, torch.Generator().manual_seed(2))
    logits, state = steps.make_serve_step(tb, dshape)(params, cache, dbatch)
    assert state.length == 32 and torch.isfinite(logits).all()
    assert cache.k[:, :, 31].any()               # written at seq_len - 1
    q8 = tapi.build(dataclasses.replace(cfg, kv_cache_bits=8), device="cpu")
    s8 = q8.serve_state_shape(dshape)
    assert isinstance(s8, TL.KVCacheQ) and s8.k.dtype == torch.int8
    assert s8.k_scale.shape == (2, 2, 32, 1)


# --- specs at full width, no allocation ---------------------------------------

def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], prefix + (k,))
    else:
        yield prefix, tuple(tree.shape)


def _dtypes(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _dtypes(tree[k], prefix + (k,))
    else:
        d = tree.dtype
        yield prefix, (str(d).split(".")[-1] if isinstance(d, torch.dtype)
                       else np.dtype(d).name)


@pytest.mark.parametrize("arch", DENSE + ("granite-moe-3b-a800m",
                                          "qwen3-moe-235b-a22b",
                                          "qwen2-vl-7b"))
def test_param_specs_at_full_width_match_jax(arch):
    jb = japi.build(j_get_arch(arch), make_host_mesh())
    tb = tapi.build(get_arch(arch), device="cpu")
    assert tb.vocab_padded == jb.vocab_padded
    assert list(_shapes(tb.param_specs())) == list(_shapes(jb.param_specs()))
    assert tb.n_params() == jb.n_params()
    tdt, jdt = dict(_dtypes(tb.param_specs())), dict(_dtypes(jb.param_specs()))
    assert tdt == jdt           # an MoE router is f32 in both
    for shape in (JShape("p", 4096, 2, "prefill"), JShape("d", 4096, 2,
                                                          "decode")):
        t = tb.input_specs(ShapeConfig(*dataclasses.astuple(shape)))
        j = jb.input_specs(shape)
        assert {k: v.shape for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}


def test_tinyllama_is_1_1b_in_bf16():
    tb = tapi.build(get_arch("tinyllama-1.1b"), device="cpu")
    assert tb.n_params() == 1_100_048_384
    assert tb.vocab_padded == 32_000
    from repro_torch.models.common import param_bytes
    assert param_bytes(tb.param_specs()) == 2 * tb.n_params()


PORTED = {"ssm": "mamba2-130m", "moe": "granite-moe-3b-a800m",
          "hybrid": "jamba-v0.1-52b", "audio": "whisper-tiny",
          "vlm": "qwen2-vl-7b"}


@pytest.mark.parametrize("family", ["ssm", "moe", "hybrid", "audio", "vlm"])
def test_build_refuses_families_not_ported(family):
    """Every family of the reference builds at its reduced config (the
    port has all six); a family the reference has no model for is refused
    by name, as the reference refuses it."""
    tb = tapi.build(get_arch(PORTED[family]).reduced(), device="cpu")
    assert tb.cfg.family == family and tb.n_params() > 0
    assert family in tapi.PORTED_FAMILIES
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              family=f"not-{family}")
    with pytest.raises(ValueError, match="no LM model for family"):
        tapi.build(cfg, device="cpu")


def test_every_reference_arch_builds_in_its_order():
    """The port registers the reference's ten LM archs in its order, and
    each builds at its published width on the CPU (specs only, nothing
    allocated) with the reference's parameter count."""
    from repro.configs.base import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs.base import ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        tb = tapi.build(get_arch(arch), device="cpu")
        jb = japi.build(j_get_arch(arch), make_host_mesh())
        assert tb.n_params() == jb.n_params(), arch


def test_flash_ref_gqa_equals_expanded_kv():
    """The plain version reads KV head h // G; expanding K/V by
    ``repeat_interleave`` gives the same numbers."""
    q, k, v = (torch.from_numpy(a) for a in _np(10, (2, 20, 8, 16),
                                                (2, 20, 2, 16), (2, 20, 2, 16)))
    got = tref.flash_attention_ref(q, k, v, q_offset=3)
    want = tref.flash_attention_ref(q, k.repeat_interleave(4, 2),
                                    v.repeat_interleave(4, 2), q_offset=3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
