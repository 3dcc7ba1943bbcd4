"""The port's audio family (``repro_torch.models.whisper``: the encoder-
decoder with cross-attention; ``models.layers``' LayerNorm and GELU MLP)
against the JAX reference, at reduced whisper-tiny (2 encoder and 2
decoder layers, d 64, 4 heads, 32 frames).

Inputs (tokens and frames) are made with numpy from a seed; the weights
come from the reference's ``bundle.init(PRNGKey(0))`` through
``models.interop.lm_params_from_numpy``, and the reference runs jitted.
The module-scoped ``runs`` fixture keeps one reference run per dtype.

Tolerances: f32 layers rtol = atol = 1e-6, bf16 layers 2 bf16 ulps at the
tensor's largest magnitude; encoder output, cross K/V and logits in f32
relative L2 1e-5, the loss rtol 1e-5, every gradient relative L2 1e-4 a
leaf; bf16 logits rtol = atol = 3e-2 (``tests/test_torch_lm.py``'s);
decode against the full forward in bf16 by the reference's rule (rtol
5e-2, atol 5e-1, argmax agreement above 0.95).

On a card (``cuda`` marker; the reference is imported only inside
fixtures):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_audio.py
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
from repro_torch.models import whisper as TW
from repro_torch.models.common import leaves, tree_map
from repro_torch.models.interop import lm_params_from_numpy

ARCH = "whisper-tiny"
PROMPT, MAX_LEN, DECODE = 16, 32, 4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    from repro.models import layers as JL
    from repro.models import whisper as JW
    mesh = make_host_mesh()
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, JW=JW, japi=japi, JShape=JShape,
        j_get_arch=j_get_arch, mesh=mesh,
        rules=japi.build(j_get_arch(ARCH).reduced(), mesh).rules)


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


# --- the layers -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(jx, dtype):
    x, s, b = _np(0, (2, 8, 64), (64,), (64,))
    (jxx, tx), (js, ts), (jb, tb) = (_pair(jx, a, dtype)
                                     for a in (x * 3 + 1, 1 + s, b))
    want = jx.jax.jit(jx.JL.layer_norm)(jxx, js, jb)
    got = TL.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(jx, dtype):
    x, wu, bu, wd, bd = _np(1, (2, 8, 64), (64, 128), (128,), (128, 64),
                            (64,))
    args = [_pair(jx, a, dtype) for a in (x, wu * 64 ** -0.5, bu * 0.1,
                                          wd * 128 ** -0.5, bd * 0.1)]
    want = jx.jax.jit(jx.JL.gelu_mlp)(*(j for j, _ in args))
    got = TL.gelu_mlp(*(t for _, t in args))
    _close(got, want, dtype)


def test_sinusoidal_matches_jax(jx):
    np.testing.assert_allclose(TW.sinusoidal(448, 384).numpy(),
                               np.asarray(jx.JW.sinusoidal(448, 384)),
                               rtol=1e-6, atol=1e-6)


# --- the model: reduced whisper-tiny ----------------------------------------------

def _inputs(cfg_d=64, frames=32):
    rng = np.random.default_rng(31)
    return (rng.integers(0, 256, (2, PROMPT)).astype(np.int32),
            rng.integers(0, 256, (2, PROMPT)).astype(np.int32),
            rng.normal(size=(2, frames, cfg_d)).astype(np.float32))


def _cfg(pkg_get_arch):
    return dataclasses.replace(pkg_get_arch(ARCH).reduced(), remat=True)


def _ref_run(jx, dtype):
    """The reference: its weights; the encoder's output; the prefill's
    logits; the full forward's logits at every position; the cross K/V;
    decode from ``precompute_cross``'s state over the prompt and DECODE
    greedy tokens; the loss and every gradient."""
    jax, jnp = jx.jax, jx.jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = _cfg(jx.j_get_arch)
    jb = jx.japi.build(jcfg, jx.mesh, dtype=jdt)
    jp = jb.init(jax.random.PRNGKey(0))
    tokens, targets, frames = _inputs()
    jf = jnp.asarray(frames).astype(jdt)
    JW, m, r = jx.JW, jx.mesh, jb.rules
    out = types.SimpleNamespace(params=jax.tree.map(np.asarray, jp),
                                frames=np.asarray(jf.astype(jnp.float32)))
    out.enc = jax.jit(lambda p, f: JW.encode(jcfg, m, r, p, f))(jp, jf)
    batch = {"tokens": jnp.asarray(tokens), "frames": jf}
    out.prefill, _ = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(jp, batch)
    out.full = jax.jit(lambda p, b: (JW.forward_hidden(jcfg, m, r, p, b)[0]
                                     @ p["embed"].T).astype(jnp.float32))(
        jp, batch)
    ck, cv = jax.jit(lambda p, f: JW.precompute_cross(jcfg, m, r, p, f))(
        jp, jf)
    out.cross = (ck, cv)
    state = dict(jb.serve_state_shape(jx.JShape("s", MAX_LEN, 2, "decode")),
                 cross_k=ck, cross_v=cv)
    step = jax.jit(lambda p, s, b, n: jb.serve_step(p, s, b, length=n))
    out.fed, out.steps = [], []
    for t in range(PROMPT + DECODE):
        tok = (tokens[:, t:t + 1] if t < PROMPT else
               np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32))
        jl, state = step(jp, state, {"token": jnp.asarray(tok)},
                         jnp.int32(t))
        out.fed.append(tok)
        out.steps.append(jl)
    out.state = state
    out.loss = jax.jit(jax.value_and_grad(jb.loss))(
        jp, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
             "frames": jf})
    return out


def _port_run(ref, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cfg = _cfg(get_arch)
    tb = tapi.build(cfg, device="cpu", dtype=tdt)
    tp = lm_params_from_numpy(ref.params, device="cpu")
    tokens, targets, _ = _inputs()
    tf = torch.from_numpy(ref.frames.copy()).to(tdt)
    out = types.SimpleNamespace(tb=tb, tp=tp, steps=[])
    batch = {"tokens": torch.from_numpy(tokens), "frames": tf}
    with torch.no_grad():
        out.enc = TW.encode(cfg, tp, tf)
        out.prefill, out.prefill_state = tb.prefill(tp, batch, MAX_LEN)
        out.full = (TW.forward_hidden(cfg, tp, batch)[0]
                    @ tp["embed"].T).float()
        out.cross = TW.precompute_cross(cfg, tp, tf)
        state = tb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        state["cross_k"].copy_(out.cross[0])
        state["cross_v"].copy_(out.cross[1])
        for t, tok in enumerate(ref.fed):
            lg, state = tb.serve_step(tp, state,
                                      {"token": torch.from_numpy(tok)},
                                      length=t)
            out.steps.append(lg)
        out.state = state
    out.loss = steps.value_and_grad(
        tb, tp, {"tokens": torch.from_numpy(tokens),
                 "targets": torch.from_numpy(targets), "frames": tf})
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


def test_whisper_encode_prefill_decode_loss_and_grads_f32(runs):
    """The encoder's output, prefill logits, the full forward's logits,
    the cross K/V, every decode step against the real cross K/V (the
    prompt, then greedy tokens) and the final self K/V, the loss and every
    gradient."""
    ref, got = runs("float32")
    assert _rel_l2(got.enc, ref.enc) <= 1e-5
    assert got.prefill.shape == (2, 1, 256) and got.prefill_state is None
    assert _rel_l2(got.prefill, ref.prefill) <= 1e-5
    assert _rel_l2(got.full, ref.full) <= 1e-5
    for g, w in zip(got.cross, ref.cross):
        assert g.shape == (2, 2, 32, 4, 16)
        assert _rel_l2(g, w) <= 1e-5
    for tl, jl in zip(got.steps, ref.steps):
        assert _rel_l2(tl, jl) <= 1e-5
    for key in ("self_k", "self_v"):
        assert _rel_l2(got.state[key], ref.state[key]) <= 1e-5
    (jloss, jg), (tloss, tg) = ref.loss, got.loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    n = 0
    for path, t in leaves(tg):
        w, p = jg, got.tp
        for k in path:
            w, p = w[k], p[k]
        assert t.dtype == p.dtype, path
        assert _rel_l2(t, w) <= 1e-4, path
        n += 1
    assert n == len(list(leaves(got.tp)))


def test_whisper_prefill_decode_bf16(runs):
    """bf16: the encoder's output, the logits and the greedy tokens at 3e-2,
    the loss at rtol 1e-3."""
    ref, got = runs("bfloat16")
    tol = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_f32(got.enc), _f32(ref.enc), **tol)
    np.testing.assert_allclose(_f32(got.prefill), _f32(ref.prefill), **tol)
    np.testing.assert_allclose(_f32(got.full), _f32(ref.full), **tol)
    for tl, jl in zip(got.steps, ref.steps):
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    np.testing.assert_allclose(float(got.loss[0]), float(ref.loss[0]),
                               rtol=1e-3)


def test_whisper_decode_matches_full_forward_bf16(runs):
    """The port's decode over the prompt (against ``precompute_cross``'s
    K/V) against its full forward pass: the reference's own rule."""
    _, got = runs("bfloat16")
    dec = torch.cat(got.steps[:PROMPT], dim=1)
    np.testing.assert_allclose(_f32(dec), _f32(got.full), rtol=5e-2,
                               atol=5e-1)
    agree = float((dec.argmax(-1) == got.full.argmax(-1)).float().mean())
    assert agree > 0.95, agree


def test_whisper_decode_position_clamps_as_the_reference(jx, runs):
    """Decode at length = max_len: the reference reads the last row of the
    sinusoid table (JAX clamps the index) and writes the last K/V row (the
    update slice clamps its start); the port does the same, f32."""
    ref, got = runs("float32")
    jb = jx.japi.build(_cfg(jx.j_get_arch), jx.mesh, dtype=jx.jnp.float32)
    jp = jx.jax.tree.map(jx.jnp.asarray, ref.params)
    js = jb.serve_state_shape(jx.JShape("s", 8, 2, "decode"))
    tok = np.full((2, 1), 5, np.int32)
    jl, js = jx.jax.jit(lambda p, s, b: jb.serve_step(p, s, b, length=8))(
        jp, js, {"token": jx.jnp.asarray(tok)})
    ts = got.tb.serve_state_shape(ShapeConfig("s", 8, 2, "decode"))
    with torch.no_grad():
        tl, ts = got.tb.serve_step(got.tp, ts, {"token": torch.from_numpy(
            tok)}, length=8)
    assert _rel_l2(tl, jl) <= 1e-5
    assert _rel_l2(ts["self_k"], js["self_k"]) <= 1e-5
    assert bool(ts["self_k"][:, :, 7].any()) and not bool(
        ts["self_k"][:, :, :7].any())


def test_whisper_engine_tokens_equal_the_reference(jx, runs):
    """``ServingEngine`` (3 slots, 5 requests) in f32 on the reference's
    weights, token for token: both decode against zero cross K/V, as the
    reference's engine serves whisper (ROADMAP Queue 3)."""
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng
    ref, got = runs("float32")
    jb = jx.japi.build(_cfg(jx.j_get_arch), jx.mesh, dtype=jx.jnp.float32)
    jp = jx.jax.tree.map(jx.jnp.asarray, ref.params)
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(5)]

    def run(mod, bundle, params):
        eng = mod.ServingEngine(bundle, params, slots=3, max_len=32)
        return eng.run([mod.Request(rid=i, prompt=p, max_new=5)
                        for i, p in enumerate(prompts)], max_steps=64), eng
    ops.reset_launch_counts()
    got_toks, eng = run(teng, got.tb, got.tp)
    assert got_toks == run(jeng, jb, jp)[0]
    assert sum(ops.launch_counts().values()) == 0
    assert not bool(eng.state["cross_k"].any())


def test_whisper_inputs_state_and_counts_like_the_reference(jx):
    """Full-width specs (no allocation): every leaf's path, shape and
    dtype, the parameter count; the inputs of each kind (frames [B, 1500,
    384] in the bundle's dtype to train and prefill, drawn normal by
    ``make_inputs``); the serve state's shapes and dtypes."""
    jb = jx.japi.build(jx.j_get_arch(ARCH), jx.mesh)
    tb = tapi.build(get_arch(ARCH), device="cpu")
    assert tb.n_params() == jb.n_params()
    jspecs = {}

    def walk(s, prefix=()):
        if isinstance(s, dict):
            for k, v in s.items():
                walk(v, prefix + (k,))
        else:
            jspecs[prefix] = (tuple(s.shape), jx.jnp.dtype(s.dtype).name)
    walk(jb.param_specs())
    assert {p: (s.shape, str(s.dtype).split(".")[-1])
            for p, s in leaves(tb.param_specs())} == jspecs
    for kind in ("train", "prefill", "decode"):
        t = tb.input_specs(ShapeConfig("x", 448, 2, kind))
        j = jb.input_specs(jx.JShape("x", 448, 2, kind))
        assert {k: (v.shape, str(v.dtype).split(".")[-1])
                for k, v in t.items()} == \
            {k: (tuple(v.shape), jx.jnp.dtype(v.dtype).name)
             for k, v in j.items()}
    assert tb.input_specs(ShapeConfig("x", 448, 2, "train"))["frames"] \
        .shape == (2, 1500, 384)
    small = tapi.build(get_arch(ARCH).reduced(), device="cpu")
    ins = small.make_inputs(ShapeConfig("x", 16, 2, "train"),
                            torch.Generator().manual_seed(0))
    assert ins["frames"].dtype == torch.bfloat16
    assert ins["frames"].shape == (2, 32, 64)
    assert 0.5 < float(ins["frames"].float().std()) < 2.0
    t = tb.serve_state_shape(ShapeConfig("s", 8, 1, "decode"))
    j = jx.jax.eval_shape(lambda: jb.serve_state_shape(
        jx.JShape("s", 8, 1, "decode")))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in t.items()} == \
        {k: (tuple(v.shape), jx.jnp.dtype(v.dtype).name)
         for k, v in j.items()}


def test_whisper_model_flops_match_reference():
    from repro.analysis.model_flops import model_flops as ref_flops
    from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
    from repro.configs.base import get_arch as ref_arch
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs.base import SHAPES_BY_NAME
    for shape in SHAPES_BY_NAME:
        got = model_flops(get_arch(ARCH), SHAPES_BY_NAME[shape])
        assert got == ref_flops(ref_arch(ARCH), REF_SHAPES[shape]) > 0, shape


def test_whisper_train_step_on_make_inputs():
    """Two ``launch.steps.make_train_step`` steps of reduced whisper in f32
    on ``make_inputs`` batches (frames, tokens, targets): finite losses,
    every leaf moved (in bf16 adamw's first steps of 1e-3 round away on the
    LayerNorm scales of 1.0), dtypes kept."""
    from repro_torch.train import optim
    tb = tapi.build(_cfg(get_arch), device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = tb.init(gen)
    opt = optim.adamw(1e-3)
    state = opt.init(params)
    step = steps.make_train_step(tb, opt)
    p0 = tree_map(torch.clone, params)
    for _ in range(2):
        params, state, loss = step(params, state, tb.make_inputs(
            ShapeConfig("t", 16, 2, "train"), gen))
        assert np.isfinite(float(loss))
    for (path, a), (_, b) in zip(leaves(params), leaves(p0)):
        assert a.dtype == b.dtype and not torch.equal(a, b), path


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_whisper_prefill_launches_the_kernel_per_attention(cuda):
    """Reduced whisper in f32 on CUDA: the prefill launches flash_attention
    once per attention (2 encoder, 2 decoder self, 2 cross: 6, the cross
    ones at S 16 against T 32), matches the CPU's plain prefill; decode
    against ``precompute_cross`` (which launches 2) and the loss (no port
    kernel) match the CPU's."""
    cfg = _cfg(get_arch)
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32)
    params = tb.init(torch.Generator().manual_seed(0))
    gb = tapi.build(cfg, device=cuda, dtype=torch.float32)
    gp = tree_map(lambda t: t.to(cuda), params)
    tokens, targets, frames = (torch.from_numpy(a) for a in _inputs())
    batch = {"tokens": tokens, "frames": frames}
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    with torch.no_grad():
        want, _ = tb.prefill(params, batch, MAX_LEN)
        ops.reset_launch_counts()
        got, _ = gb.prefill(gp, gbatch, MAX_LEN)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 6
        assert _rel_l2(got, want) <= 1e-4
        ck, cv = TW.precompute_cross(cfg, params, frames)
        gk, gv = TW.precompute_cross(cfg, gp, frames.to(cuda),
                                     use_kernel=True)
        assert _rel_l2(gk, ck) <= 1e-4
        sc = tb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        sg = gb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        sc.update(cross_k=ck, cross_v=cv)
        sg.update(cross_k=gk, cross_v=gv)
        for t in range(PROMPT):
            wl, sc = tb.serve_step(params, sc, {"token": tokens[:, t:t + 1]},
                                   length=t)
            gl, sg = gb.serve_step(gp, sg, {"token": tokens[:, t:t + 1].to(
                cuda)}, length=t)
            assert _rel_l2(gl, wl) <= 1e-4
    ops.reset_launch_counts()
    loss = gb.loss(gp, {**gbatch, "targets": targets.to(cuda)})
    assert sum(ops.launch_counts().values()) == 0
    np.testing.assert_allclose(float(loss), float(tb.loss(
        params, {**batch, "targets": targets})), rtol=1e-5)
