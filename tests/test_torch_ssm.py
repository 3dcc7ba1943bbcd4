"""The port's SSM family (``repro_torch.models.mamba2``, the causal conv of
``models.layers``, reduced mamba2-130m: 2 layers, d 64, state 16, heads
of 16, chunk 32) against the JAX reference.

Inputs are made with numpy from a seed; the model's weights come from the
reference's ``bundle.init(PRNGKey(0))`` through
``models.interop.lm_params_from_numpy``, and the reference runs jitted.
The module-scoped ``runs`` fixture keeps one reference run per dtype.

Tolerances:
* f32 layers: rtol = atol = 1e-6; bf16 layers: within 2 bf16 ulps at the
  tensor's largest magnitude.
* ``ssd_chunked`` (the chunk scan is a decay matrix here, an associative
  scan there) and the model's logits and SSM state in f32: relative L2
  1e-5; the loss rtol 1e-5; every gradient: relative L2 1e-4 a leaf.
  bf16 logits: rtol = atol = 3e-2 (``tests/test_torch_lm.py``'s).
* Decode against the full forward pass in bf16: the reference's own rule
  (``tests/test_model_invariants.py``: rtol 5e-2, atol 5e-1, argmax
  agreement above 0.95).

On a card (``cuda`` marker; skipped without one; the card has no JAX, so
the reference is imported only inside fixtures):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_ssm.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models.common import leaves
from repro_torch.models.interop import lm_params_from_numpy

ARCH = "mamba2-130m"
PROMPT, GREEDY = 16, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's mamba2 and layers, jitted where they run."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    from repro.models import layers as JL
    from repro.models import mamba2 as JM
    mesh = make_host_mesh()
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, JM=JM, japi=japi, JShape=JShape,
        j_get_arch=j_get_arch, mesh=mesh,
        rules=japi.build(j_get_arch(ARCH).reduced(), mesh).rules,
        ssd=jax.jit(JM.ssd_chunked, static_argnums=4),
        ssd_ref=jax.jit(JM.ssd_ref), ssd_decode=jax.jit(JM.ssd_decode))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _pair(jx, a, dtype):
    """One numpy array as (jnp, torch) of ``dtype`` holding equal values."""
    jdt = jx.jnp.float32 if dtype == "float32" else jx.jnp.bfloat16
    j = jx.jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jx.jnp.float32)))
    return j, t.to(torch.float32 if dtype == "float32" else torch.bfloat16)


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ssd_inputs(seed, b, l, h, p, n):
    xdt, a, B, C = _np(seed, (b, l, h, p), (b, l, h), (b, l, n), (b, l, n),
                       scale=0.5)
    return xdt, -np.abs(a), B, C


# --- the causal conv ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(jx, dtype):
    x, w = _np(0, (2, 24, 32), (4, 32))
    (jxx, tx), (jw, tw) = _pair(jx, x, dtype), _pair(jx, w, dtype)
    want = jx.jax.jit(jx.JL.causal_conv1d)(jxx, jw)
    got = TL.causal_conv1d(tx, tw)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_update_matches_jax(jx, dtype):
    st, xn, w = _np(1, (2, 3, 32), (2, 1, 32), (4, 32))
    (js, ts), (jn, tn), (jw, tw) = (_pair(jx, a, dtype) for a in (st, xn, w))
    jst, jo = jx.jax.jit(jx.JL.causal_conv1d_update)(js, jn, jw)
    tst, to = TL.causal_conv1d_update(ts, tn, tw)
    np.testing.assert_array_equal(_f32(tst), _f32(jst))
    _close(to, jo, dtype)


def test_causal_conv1d_update_steps_equal_the_conv():
    """Feeding x one position at a time from a zero window gives the
    full-sequence conv (f32)."""
    x, w = (torch.from_numpy(a) for a in _np(2, (2, 10, 8), (4, 8)))
    state = torch.zeros(2, 3, 8)
    outs = []
    for t in range(10):
        state, o = TL.causal_conv1d_update(state, x[:, t:t + 1], w)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), TL.causal_conv1d(x, w),
                               rtol=1e-6, atol=1e-6)


# --- the SSD scan -------------------------------------------------------------

@pytest.mark.parametrize("l,chunk", [(64, 16), (64, 64), (128, 32), (40, 16)])
def test_ssd_chunked_matches_jax(jx, l, chunk):
    """Several chunks, one chunk, and a ragged length: 40 is no multiple of
    16, so both packages take the whole sequence as one chunk."""
    xdt, a, B, C = _ssd_inputs(3, 2, l, 3, 8, 16)
    jy, js = jx.ssd(xdt, a, B, C, chunk)
    ty, ts = TM.ssd_chunked(*map(torch.from_numpy, (xdt, a, B, C)), chunk)
    assert ty.dtype == ts.dtype == torch.float32
    assert ts.shape == (2, 3, 8, 16)
    assert _rel_l2(ty, jy) <= 1e-5
    assert _rel_l2(ts, js) <= 1e-5


def test_ssd_ragged_length_takes_the_one_chunk_branch(jx):
    """At l % chunk != 0 the result is the quadratic dual over the whole
    sequence (the branch under test), and equals chunk = l."""
    xdt, a, B, C = map(torch.from_numpy, _ssd_inputs(4, 2, 40, 3, 8, 16))
    assert 40 % 16
    ragged, s1 = TM.ssd_chunked(xdt, a, B, C, 16)
    whole, s2 = TM.ssd_chunked(xdt, a, B, C, 40)
    assert torch.equal(ragged, whole) and torch.equal(s1, s2)
    assert _rel_l2(ragged, TM.ssd_ref(xdt, a, B, C)) <= 1e-5


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_ssd_chunked_matches_the_quadratic_dual(jx, seed):
    """The port's chunked scan and its ``ssd_ref`` against each other and
    against the reference's ``ssd_ref`` (the reference's invariant)."""
    xdt, a, B, C = _ssd_inputs(seed, 2, 64, 3, 8, 16)
    ty, _ = TM.ssd_chunked(*map(torch.from_numpy, (xdt, a, B, C)), 16)
    tq = TM.ssd_ref(*map(torch.from_numpy, (xdt, a, B, C)))
    jq = jx.ssd_ref(xdt, a, B, C)
    assert _rel_l2(tq, jq) <= 1e-5
    assert _rel_l2(ty, tq) <= 1e-5


def test_ssd_decode_matches_jax_and_the_scan(jx):
    """The one-token recurrence step by step against the reference's, and
    its outputs and final state against the chunked scan."""
    xdt, a, B, C = _ssd_inputs(8, 2, 32, 2, 4, 8)
    js = jx.jnp.zeros((2, 2, 4, 8))
    ts = torch.zeros(2, 2, 4, 8)
    ys = []
    for t in range(32):
        js, jy = jx.ssd_decode(js, xdt[:, t], a[:, t], B[:, t], C[:, t])
        ts, ty = TM.ssd_decode(ts, *(torch.from_numpy(v[:, t])
                                     for v in (xdt, a, B, C)))
        np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_f32(ts), _f32(js), rtol=1e-6, atol=1e-6)
        ys.append(ty)
    yc, sc = TM.ssd_chunked(*map(torch.from_numpy, (xdt, a, B, C)), 8)
    assert _rel_l2(torch.stack(ys, 1), yc) <= 1e-5
    assert _rel_l2(ts, sc) <= 1e-5


def test_segsum_matches_jax(jx):
    a, = _np(9, (3, 12))
    want = jx.jax.jit(jx.JM.segsum)(a)
    got = TM.segsum(torch.from_numpy(a))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


# --- the mixer ------------------------------------------------------------------

def _mixer_params(jx, dtype, seed=10):
    """One layer's mixer weights (reduced mamba2's shapes, at the
    reference's init scales but with dt_bias, A_log and D drawn so that
    they matter) as (jnp dict, torch dict)."""
    cfg = get_arch(ARCH).reduced()
    specs = TM.mixer_specs(cfg, 1, torch.float32)
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for k, s in specs.items():
        shape = s.shape[1:]
        a = rng.normal(size=shape).astype(np.float32)
        a = a * (0.02 if s.init == "small" else 0.3 if s.init != "normal"
                 else shape[0] ** -0.5)
        if k in ("ln", "norm", "D"):
            a = 1.0 + a
        kd = "float32" if k in ("dt_bias", "A_log", "D") else dtype
        jp[k], tp[k] = _pair(jx, a, kd)
    return cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_forward_matches_jax(jx, dtype):
    cfg, jp, tp = _mixer_params(jx, dtype)
    jcfg = jx.j_get_arch(ARCH).reduced()
    x, = _np(11, (2, 64, 64))
    jxx, tx = _pair(jx, x, dtype)
    want = jx.jax.jit(lambda p, x: jx.JM.mixer_forward(
        jcfg, jx.mesh, jx.rules, p, x))(jp, jxx)
    got = TM.mixer_forward(cfg, tp, tx)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        assert _rel_l2(got, want) <= 1e-5
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_decode_matches_jax(jx, dtype):
    """Eight decode steps from a random state: every output and every part
    of the new state."""
    cfg, jp, tp = _mixer_params(jx, dtype)
    jcfg = jx.j_get_arch(ARCH).reduced()
    z = TM.mixer_init_state(cfg, 2, dtype=tp["w_x"].dtype)
    parts = _np(12, *(t.shape for t in z), scale=0.5)
    jst, tst = [], []
    for i, a in enumerate(parts):
        j, t = _pair(jx, a, "float32" if i == 3 else dtype)
        jst.append(j)
        tst.append(t)
    jst, tst = jx.JM.SSMState(*jst), TM.SSMState(*tst)
    step = jx.jax.jit(lambda p, x, s: jx.JM.mixer_decode(
        jcfg, jx.mesh, jx.rules, p, x, s))
    xs, = _np(13, (8, 2, 1, 64))
    for t in range(8):
        jxx, tx = _pair(jx, xs[t], dtype)
        jo, jst = step(jp, jxx, jst)
        to, tst = TM.mixer_decode(cfg, tp, tx, tst)
        _close(to, jo, dtype)
        assert tst.h.dtype == torch.float32
        for g, w in zip(tst, jst):        # h f32 with bf16's noise in bf16
            _close(g, w, dtype)


# --- the model: reduced mamba2-130m ----------------------------------------------

def _inputs():
    rng = np.random.default_rng(14)
    return (rng.integers(0, 256, (2, PROMPT)).astype(np.int32),
            rng.integers(0, 256, (2, PROMPT)).astype(np.int32))


def _ref_run(jx, dtype):
    """The reference on reduced mamba2 (remat on): its weights, the
    prefill's logits, the full forward's logits at every position, decode
    from the zero state over the prompt and GREEDY greedy tokens after it,
    and the loss with every gradient."""
    jax, jnp = jx.jax, jx.jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = dataclasses.replace(jx.j_get_arch(ARCH).reduced(), remat=True)
    jb = jx.japi.build(jcfg, jx.mesh, dtype=jdt)
    jp = jb.init(jax.random.PRNGKey(0))
    tokens, targets = _inputs()
    out = types.SimpleNamespace(params=jax.tree.map(np.asarray, jp))
    out.prefill, _ = jax.jit(lambda p, b: jb.prefill(p, b, PROMPT))(
        jp, {"tokens": jnp.asarray(tokens)})
    out.full = jax.jit(lambda p, t: (jx.JM.forward_hidden(
        jcfg, jx.mesh, jb.rules, p, {"tokens": t})[0]
        @ p["embed"].T).astype(jnp.float32))(jp, jnp.asarray(tokens))
    state = jb.serve_state_shape(jx.JShape("s", PROMPT + GREEDY, 2, "decode"))
    step = jax.jit(lambda p, s, b: jb.serve_step(p, s, b, length=0))
    out.fed, out.steps = [], []
    for t in range(PROMPT + GREEDY):
        tok = (tokens[:, t:t + 1] if t < PROMPT else
               np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32))
        jl, state = step(jp, state, {"token": jnp.asarray(tok)})
        out.fed.append(tok)
        out.steps.append(jl)
    out.state = state
    out.loss = jax.jit(jax.value_and_grad(jb.loss))(
        jp, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
    return out


def _port_run(ref, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), remat=True)
    tb = tapi.build(cfg, device="cpu", dtype=tdt)
    tp = lm_params_from_numpy(ref.params, device="cpu")
    tokens, targets = _inputs()
    out = types.SimpleNamespace(tb=tb, tp=tp, steps=[])
    with torch.no_grad():
        out.prefill, out.prefill_state = tb.prefill(
            tp, {"tokens": torch.from_numpy(tokens)}, PROMPT)
        out.full = (TM.forward_hidden(cfg, tp, {"tokens": torch.from_numpy(
            tokens)})[0] @ tp["embed"].T).float()
        state = tb.serve_state_shape(ShapeConfig("s", PROMPT + GREEDY, 2,
                                                 "decode"))
        for tok in ref.fed:
            lg, state = tb.serve_step(tp, state,
                                      {"token": torch.from_numpy(tok)},
                                      length=0)
            out.steps.append(lg)
        out.state = state
    out.loss = steps.value_and_grad(
        tb, tp, {"tokens": torch.from_numpy(tokens),
                 "targets": torch.from_numpy(targets)})
    return out


@pytest.fixture(scope="module")
def runs(jx):
    memo = {}

    def get(dtype):
        if dtype not in memo:
            ref = _ref_run(jx, dtype)
            memo[dtype] = (ref, _port_run(ref, dtype))
        return memo[dtype]
    return get


def test_mamba2_prefill_decode_loss_and_grads_f32(runs):
    """Prefill logits, the full forward's logits at every position, every
    decode step's logits (the prompt fed, then greedy tokens) and the final
    SSM state, the loss and every gradient, against the reference."""
    ref, got = runs("float32")
    assert got.prefill.shape == (2, 1, 256)
    assert got.prefill.dtype == torch.float32
    assert got.prefill_state is None
    assert _rel_l2(got.prefill, ref.prefill) <= 1e-5
    assert _rel_l2(got.full, ref.full) <= 1e-5
    for tl, jl in zip(got.steps, ref.steps):
        assert _rel_l2(tl, jl) <= 1e-5
    for g, w in zip(got.state, ref.state):
        assert _rel_l2(g, w) <= 1e-5
    (jloss, jg), (tloss, tg) = ref.loss, got.loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _hold_grads(got.tp, tg, jg)


def _hold_grads(params, tg, jg):
    """Every gradient leaf in its param's dtype, within relative L2 1e-4 of
    the reference's."""
    for path, t in leaves(tg):
        w, p = jg, params
        for k in path:
            w, p = w[k], p[k]
        assert t.dtype == p.dtype, path
        assert _rel_l2(t, w) <= 1e-4, path


def test_mamba2_prefill_decode_bf16(runs):
    """bf16 weights (dt_bias, A_log and D f32): the logits at 3e-2, the
    greedy tokens the reference's, the loss at rtol 1e-3."""
    ref, got = runs("bfloat16")
    assert got.tp["blocks"]["A_log"].dtype == torch.float32
    assert got.tp["blocks"]["w_x"].dtype == torch.bfloat16
    tol = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_f32(got.prefill), _f32(ref.prefill), **tol)
    np.testing.assert_allclose(_f32(got.full), _f32(ref.full), **tol)
    for tl, jl in zip(got.steps, ref.steps):
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    np.testing.assert_allclose(float(got.loss[0]), float(ref.loss[0]),
                               rtol=1e-3)


def test_mamba2_decode_matches_full_forward_bf16(runs):
    """The port's decode from the zero state over the prompt against its
    full forward pass: the reference's own rule (rtol 5e-2, atol 5e-1,
    argmax agreement above 0.95)."""
    _, got = runs("bfloat16")
    dec = torch.cat(got.steps[:PROMPT], dim=1)
    np.testing.assert_allclose(_f32(dec), _f32(got.full), rtol=5e-2,
                               atol=5e-1)
    agree = float((dec.argmax(-1) == got.full.argmax(-1)).float().mean())
    assert agree > 0.95, agree


def test_mamba2_engine_tokens_equal_the_reference(jx, runs):
    """``ServingEngine`` (3 slots, 5 requests of 3-token prompts, 5 new
    tokens each) in f32 on the reference's weights, token for token."""
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng
    ref, got = runs("float32")
    jcfg = jx.j_get_arch(ARCH).reduced()
    jb = jx.japi.build(jcfg, jx.mesh, dtype=jx.jnp.float32)
    jp = jx.jax.tree.map(jx.jnp.asarray, ref.params)
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(5)]

    def run(mod, bundle, params):
        eng = mod.ServingEngine(bundle, params, slots=3, max_len=32)
        return eng.run([mod.Request(rid=i, prompt=p, max_new=5)
                        for i, p in enumerate(prompts)], max_steps=64)
    tb = tapi.build(get_arch(ARCH).reduced(), device="cpu",
                    dtype=torch.float32)
    ops.reset_launch_counts()
    assert run(teng, tb, got.tp) == run(jeng, jb, jp)
    assert sum(ops.launch_counts().values()) == 0


def test_mamba2_specs_shapes_and_counts_like_the_reference(jx):
    """Full-width specs (no allocation): every leaf's path, shape and dtype,
    the parameter count, the inputs of each shape kind, and the serve
    state's shapes and dtypes at a small batch."""
    jb = jx.japi.build(jx.j_get_arch(ARCH), jx.mesh)
    tb = tapi.build(get_arch(ARCH), device="cpu")
    assert tb.n_params() == jb.n_params() == 129_057_216
    jspecs = dict(_ref_leaves(jx, jb.param_specs()))
    tspecs = {p: (s.shape, s.dtype) for p, s in leaves(tb.param_specs())}
    assert set(tspecs) == set(jspecs)
    for p, (shape, dt) in tspecs.items():
        assert shape == jspecs[p][0], p
        assert str(dt).split(".")[-1] == jspecs[p][1], p
    _hold_inputs_and_state(jx, jb, tb)


def _ref_leaves(jx, specs, prefix=()):
    """(path, (shape, dtype name)) of the reference's Spec tree."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _ref_leaves(jx, v, prefix + (k,))
    else:
        yield prefix, (tuple(specs.shape), jx.jnp.dtype(specs.dtype).name)


def _hold_inputs_and_state(jx, jb, tb):
    for kind in ("train", "prefill", "decode"):
        t = tb.input_specs(ShapeConfig("x", 64, 2, kind))
        j = jb.input_specs(jx.JShape("x", 64, 2, kind))
        assert {k: v.shape for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
    shape = ShapeConfig("s", 16, 1, "decode")
    t = tb.serve_state_shape(shape)
    j = jx.jax.eval_shape(lambda: jb.serve_state_shape(
        jx.JShape("s", 16, 1, "decode")))
    tl = [x for _, x in leaves(_as_dict(t))]
    jl = jx.jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == jx.jnp.dtype(b.dtype).name
        assert a.device.type == "cpu" and not bool(a.any())


def _as_dict(state):
    """A decode state (tuples and dicts of tensors) as a nested dict, in
    the order of ``jax.tree.leaves`` (dict keys sorted)."""
    if isinstance(state, dict):
        return {k: _as_dict(state[k]) for k in sorted(state)}
    if isinstance(state, tuple):
        return {f"{i:03d}": _as_dict(v) for i, v in enumerate(state)}
    return state


def test_mamba2_model_flops_match_reference():
    from repro.analysis.model_flops import model_flops as ref_flops
    from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
    from repro.configs.base import get_arch as ref_arch
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs.base import SHAPES_BY_NAME
    for shape in SHAPES_BY_NAME:
        got = model_flops(get_arch(ARCH), SHAPES_BY_NAME[shape])
        assert got == ref_flops(ref_arch(ARCH), REF_SHAPES[shape]) > 0, shape


def test_mamba2_train_steps_keep_the_f32_leaves(tmp_path):
    """Two adamw steps of reduced mamba2 in bf16 through ``launch.train``'s
    path: finite losses; dt_bias, A_log and D stay f32 and train."""
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ckpt")
    train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len",
                "64", "--device", "cpu", "--ckpt-dir", ckpt])
    from repro_torch.ckpt.manager import CheckpointManager
    tb = tapi.build(get_arch(ARCH).reduced(), device="cpu")
    from repro_torch.train import optim
    params = tb.init(torch.Generator().manual_seed(0))
    opt_state = optim.adamw(3e-4).init(params)
    mgr = CheckpointManager(ckpt)
    (p2, _), manifest = mgr.restore((params, opt_state))
    assert manifest["step"] == 1 and np.isfinite(mgr.restore_extra()["loss"])
    for k in ("dt_bias", "A_log", "D"):
        assert p2["blocks"][k].dtype == torch.float32
        assert not torch.equal(p2["blocks"][k], params["blocks"][k]), k


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_mamba2_matches_cpu(cuda):
    """Reduced mamba2 in f32 on CUDA against the CPU: the prefill, decode
    over the prompt and the loss (no port kernel: mamba2 has no attention)."""
    cfg = get_arch(ARCH).reduced()
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32)
    params = tb.init(torch.Generator().manual_seed(0))
    tokens, targets = (torch.from_numpy(a) for a in _inputs())
    gb = tapi.build(cfg, device=cuda, dtype=torch.float32)
    gp = {k: (v.to(cuda) if torch.is_tensor(v) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in params.items()}
    ops.reset_launch_counts()
    with torch.no_grad():
        want, _ = tb.prefill(params, {"tokens": tokens}, PROMPT)
        got, _ = gb.prefill(gp, {"tokens": tokens.to(cuda)}, PROMPT)
        assert _rel_l2(got, want) <= 1e-5
        sc = tb.serve_state_shape(ShapeConfig("s", PROMPT, 2, "decode"))
        sg = gb.serve_state_shape(ShapeConfig("s", PROMPT, 2, "decode"))
        for t in range(PROMPT):
            wl, sc = tb.serve_step(params, sc, {"token": tokens[:, t:t + 1]},
                                   length=t)
            gl, sg = gb.serve_step(gp, sg, {"token": tokens[:, t:t + 1].to(
                cuda)}, length=t)
            assert _rel_l2(gl, wl) <= 1e-5
    loss = gb.loss(gp, {"tokens": tokens.to(cuda),
                        "targets": targets.to(cuda)})
    np.testing.assert_allclose(float(loss), float(tb.loss(
        params, {"tokens": tokens, "targets": targets})), rtol=1e-5)
    assert sum(ops.launch_counts().values()) == 0
