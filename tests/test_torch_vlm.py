"""The port's VLM backbone (reduced qwen2-vl-7b: 2 layers, d 64, head_dim
32, M-RoPE sections (4, 6, 6)) and ``models.layers.apply_mrope`` against
the JAX reference.

Inputs are made with numpy from a seed; the model's weights come from the
reference's ``bundle.init(PRNGKey(0))`` through
``models.interop.lm_params_from_numpy``, and the reference runs jitted
(one bundle per dtype for the file, in the module-scoped ``runs``
fixture). The 3-D positions are the caller's, as in the reference (its
patch frontend is a stub): a text prefix with t = h = w = its index, then
an image block whose t is fixed and whose h, w walk a grid, then text
again from the largest position + 1.

Tolerances (as ``tests/test_torch_lm.py``'s): ``apply_mrope`` f32 rtol
1e-5, atol 1e-5 of the largest magnitude, bf16 within 2 bf16 ulps; the
prefill and decode logits and K/V f32 rtol 1e-4, atol 1e-5, bf16 3e-2;
the f32 loss rtol 1e-4 and every gradient rtol 1e-4, atol 1e-5 × the
leaf's largest magnitude. M-RoPE with t = h = w against RoPE: atol 1e-5
(the reference invariant's), the model's logits rtol 1e-5.
"""
import dataclasses
import types

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
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.interop import lm_params_from_numpy

ARCH = "qwen2-vl-7b"
PROMPT, MAX_LEN, DECODE = 16, 32, 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def vlm_positions(B, n_text, grid):
    """[B, n_text + grid² + n_text, 3] int32: text with t = h = w = index, an
    image block of grid × grid patches at t = n_text (h, w from n_text
    over the grid), then text from the largest position + 1."""
    text = np.arange(n_text)
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    image = np.stack([np.full(grid * grid, n_text), n_text + hh.ravel(),
                      n_text + ww.ravel()], -1)
    tail = n_text + grid + np.arange(n_text)
    pos = np.concatenate([np.repeat(text[:, None], 3, 1), image,
                          np.repeat(tail[:, None], 3, 1)])
    return np.broadcast_to(pos, (B,) + pos.shape).astype(np.int32)


# --- apply_mrope ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["prefill", "decode"])
@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 10_000.0),
                                            ((16, 24, 24), 1_000_000.0)])
def test_apply_mrope_matches_jax(dtype, where, sections, theta):
    D = 2 * sum(sections)
    S = 16 if where == "prefill" else 1
    x, = _np(1, (2, S, 4, D), scale=2.0)
    pos = np.random.default_rng(2).integers(0, 40, (2, S, 3)).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    want = jax.jit(JL.apply_mrope, static_argnums=(2, 3))(
        jx, jnp.asarray(pos), sections, theta)
    got = TL.apply_mrope(tx, torch.from_numpy(pos), sections, theta)
    assert got.dtype == tdt
    _close(got, want, dtype)


def test_mrope_reduces_to_rope_when_positions_equal():
    """The reference invariant on the port: with t = h = w M-RoPE is RoPE."""
    x, = _np(11, (1, 8, 2, 32))
    x = torch.from_numpy(x)
    pos = torch.arange(8)[None, :]
    y1 = TL.apply_rope(x, pos, 10_000.0)
    y2 = TL.apply_mrope(x, pos[..., None].expand(1, 8, 3), (4, 6, 6),
                        10_000.0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


# --- reduced qwen2-vl ------------------------------------------------------------

def _run(dtype):
    """Both packages: a prefill of B 2 × PROMPT tokens at
    ``vlm_positions(2, 4, 2)`` + 4 more text, then DECODE steps fed the
    reference's greedy tokens at the next text positions; in f32 also the
    loss and its gradients."""
    jdt, tdt = DTYPES[dtype]
    jb = japi.build(dataclasses.replace(j_get_arch(ARCH).reduced(),
                                        remat=True), make_host_mesh(),
                    dtype=jdt)
    tb = tapi.build(dataclasses.replace(get_arch(ARCH).reduced(),
                                        remat=True), device="cpu", dtype=tdt)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, PROMPT)).astype(np.int32)
    targets = rng.integers(0, 256, (2, PROMPT)).astype(np.int32)
    pos = vlm_positions(2, 4, 2)
    pos = np.concatenate([pos, pos[:, -1:] + 1 + np.arange(4)[:, None]], 1)
    assert pos.shape == (2, PROMPT, 3)
    jbatch = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "positions": torch.from_numpy(pos)}
    out = types.SimpleNamespace(tb=tb, tp=tp, pos=pos, tokens=tokens,
                                steps=[])
    jl, jc = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(jp, jbatch)
    with torch.no_grad():
        tl, tc = tb.prefill(tp, tbatch, MAX_LEN)
    out.prefill = (jl, tl)
    out.cache = (jc.k, jc.v, tc.k.clone(), tc.v.clone())   # decode writes tc
    jstep = jax.jit(lambda p, s, b, n: jb.serve_step(p, s, b, length=n))
    tok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
    for i in range(DECODE):
        p1 = np.broadcast_to(pos[:, -1:] + 1 + i, (2, 1, 3)).astype(np.int32)
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "positions": jnp.asarray(p1)},
                       jnp.int32(PROMPT + i))
        with torch.no_grad():
            tl, tc = tb.serve_step(tp, tc, {"token": torch.from_numpy(tok),
                                            "positions": torch.from_numpy(p1)},
                                   length=PROMPT + i)
        out.steps.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
    if dtype == "float32":
        jbatch["targets"] = jnp.asarray(targets)
        tbatch["targets"] = torch.from_numpy(targets)
        out.loss = (jax.jit(jax.value_and_grad(jb.loss))(jp, jbatch),
                    steps.value_and_grad(tb, tp, tbatch))
    return out


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(dtype):
        if dtype not in memo:
            memo[dtype] = _run(dtype)
        return memo[dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_then_decode_matches_jax(runs, dtype):
    """3-D positions through prefill and decode: logits, K/V (after M-RoPE)
    and greedy tokens."""
    r = runs(dtype)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-2))
    jl, tl = r.prefill
    assert tl.shape == (2, 1, 256) and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    jk, jv, tk, tv = r.cache
    assert tk.shape == (2, 2, MAX_LEN, 1, 32)
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)
    for jl, tl in r.steps:
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
        np.testing.assert_array_equal(tl[..., :256].argmax(-1).numpy(),
                                      np.asarray(jl[..., :256].argmax(-1)))


def test_vlm_loss_and_grads_match_jax(runs):
    (jloss, jg), (tloss, tg) = runs("float32").loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    leaves = [(tg["blocks"][k], jg["blocks"][k]) for k in tg["blocks"]]
    leaves += [(tg[k], jg[k]) for k in ("embed", "head", "ln_f")]
    for got, want in leaves:
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_vlm_mrope_with_equal_positions_is_the_rope_model(runs):
    """The same weights with ``mrope_sections=None`` (plain RoPE at the
    token index) give the logits of the M-RoPE model at t = h = w =
    index: chip_smoke.py's check of qwen2-vl, at reduced size."""
    r = runs("float32")
    S = PROMPT
    pos3 = torch.arange(S)[None, :, None].expand(2, S, 3).to(torch.int32)
    tokens = torch.from_numpy(r.tokens)
    rope = tapi.build(dataclasses.replace(r.tb.cfg, mrope_sections=None),
                      device="cpu", dtype=torch.float32)
    with torch.no_grad():
        want, wc = rope.prefill(r.tp, {"tokens": tokens}, S)
        got, gc = r.tb.prefill(r.tp, {"tokens": tokens, "positions": pos3}, S)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gc.k.numpy(), wc.k.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_vlm_decode_matches_full_forward(runs):
    """The reference invariant on the port: S tokens decoded one by one at
    positions (t, t, t) give the full forward's logits."""
    r = runs("float32")
    cfg, tp, S = r.tb.cfg, r.tp, 12
    tokens = torch.from_numpy(r.tokens[:, :S])
    pos3 = torch.arange(S)[None, :, None].expand(2, S, 3).to(torch.int32)
    with torch.no_grad():
        hidden, aux = TT.forward_hidden(cfg, tp, {"tokens": tokens,
                                                  "positions": pos3})
        full = (hidden @ TT._head_weight(cfg, tp)).float()
        cache = TL.KVCache.zeros(2, S, cfg.n_kv_heads, cfg.hd, torch.float32,
                                 layers=cfg.n_layers)
        outs = []
        for t in range(S):
            lg, cache = TT.decode_step(cfg, tp, cache, {
                "token": tokens[:, t:t + 1],
                "positions": pos3[:, t:t + 1]})
            outs.append(lg)
    assert aux == 0.0
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_vlm_inputs_and_specs_match_the_reference():
    """``input_specs`` adds [B,S,3] / [B,1,3] int32 positions;
    ``make_inputs`` draws them in [0, 16); the full-width specs are the
    reference's."""
    jb = japi.build(j_get_arch(ARCH), make_host_mesh())
    tb = tapi.build(get_arch(ARCH), device="cpu")
    assert tb.n_params() == jb.n_params()
    for kind in ("train", "prefill", "decode"):
        j = jb.input_specs(JShape("x", 64, 2, kind))
        t = tb.input_specs(ShapeConfig("x", 64, 2, kind))
        assert {k: v.shape for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
        assert t["positions"].dtype == torch.int32
    small = tapi.build(get_arch(ARCH).reduced(), device="cpu")
    batch = small.make_inputs(ShapeConfig("p", 64, 2, "prefill"),
                              torch.Generator().manual_seed(0))
    assert batch["positions"].shape == (2, 64, 3)
    assert int(batch["positions"].min()) >= 0
    assert int(batch["positions"].max()) < 16
    assert int(batch["tokens"].max()) < 256
