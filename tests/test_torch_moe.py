"""The port's mixture of experts (``repro_torch.models.layers``' router,
capacity, einsum and gather dispatch) and the MoE family of the
transformer (reduced granite-moe-3b-a800m and qwen3-moe-235b-a22b: 2
layers, d 64, 4 experts top-2) against the JAX reference.

Inputs are made with numpy from a seed; the models' weights come from the
reference's ``bundle.init(PRNGKey(0))`` through
``models.interop.lm_params_from_numpy``, and the reference runs jitted.
The reference's model functions are compiled once per file: the
module-scoped ``runs`` fixture keeps each (arch, dtype) run.

Tolerances (as ``tests/test_torch_lm.py``'s and ``test_torch_train.py``'s):
* router probabilities, weights and aux loss, f32: rtol 1e-5 (exp and
  sums in another order: a few ulps); picks, capacities and drop
  counts: equal.
* MoE outputs, f32: rtol 1e-5, atol 1e-5 of the tensor's largest
  magnitude; bf16: within 2 bf16 ulps at that magnitude.
* prefill and decode logits and K/V, f32: rtol 1e-4, atol 1e-5; bf16:
  3e-2. The loss, f32: rtol 1e-4; every leaf's gradient: rtol 1e-4, atol
  1e-5 × the leaf's largest magnitude.
* In bf16 the routing picks of every layer are held equal before the
  logits are compared.

Two faults of the reference's ``moe_gather`` are shown and not copied
(ROADMAP Queue 3): a dropped pick of the last expert reads past the slots
and turns the token's row into NaN, and a group of fewer tokens than the
capacity (every decode step) fails its reshape. The port's gather is
finite there and equals its einsum, so at model level it is held to the
reference's einsum model; to the reference's gather only where that is
finite (ample capacity).

On a card (``cuda`` marker; skipped without one; the card has no JAX, so
the reference is imported only inside fixtures):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_moe.py

both dispatches on CUDA equal the CPU's in f32, with dropped picks of the
last expert (on CUDA an index past the slots is a device-side assert).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models.interop import lm_params_from_numpy

MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
PROMPT, MAX_LEN, DECODE = 16, 32, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's MoE layers and model API, jitted where they run."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    from repro.models import layers as JL
    moe = jax.jit(JL.moe, static_argnames=("top_k", "capacity_factor",
                                          "impl", "group_size"))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, japi=japi, j_get_arch=j_get_arch,
        mesh=make_host_mesh(), moe=moe,
        router=jax.jit(JL._router, static_argnums=2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _moe_arrays(seed, d, E, f, x_shape, router_scale=None):
    """x and the four MoE weights (the reference invariants' scales; the
    router at 1/sqrt(d) unless given, so that loads are uneven and
    capacity drops picks)."""
    x, wr, wg, wu, wd = _np(seed, x_shape, (d, E), (E, d, f), (E, d, f),
                            (E, f, d))
    rs = router_scale if router_scale is not None else d ** -0.5
    return x, {"w_router": wr * rs, "w_gate_e": wg * d ** -0.5,
               "w_up_e": wu * d ** -0.5, "w_down_e": wd * f ** -0.5}


def _torch(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _pair(jx, x, params, dtype):
    """(jax x, jax params; torch x, torch params): x and the experts in
    ``dtype``, the router f32 in both, holding equal values."""
    jdt = jx.jnp.float32 if dtype == "float32" else jx.jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jxx = jx.jnp.asarray(x).astype(jdt)
    jp = {k: jx.jnp.asarray(v).astype(jx.jnp.float32 if k == "w_router"
                                      else jdt) for k, v in params.items()}
    tx = _torch(np.asarray(jxx.astype(jx.jnp.float32)), tdt)
    tp = {k: _torch(np.asarray(v.astype(jx.jnp.float32)),
                    torch.float32 if k == "w_router" else tdt)
          for k, v in jp.items()}
    return jxx, jp, tx, tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, dtype="float32", rows=None):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def _drops(x, params, top_k, factor, group_size=512):
    """(C, picks dropped, [B, S] mask of tokens whose pick of the last
    expert was dropped), from the port's routing of grouped x."""
    xg, _ = TL._group(x, group_size)
    E = params["w_router"].shape[-1]
    C = TL._capacity(xg.shape[1], top_k, E, factor)
    _, idx, _, _, kmask = TL._router(xg, params["w_router"], top_k)
    emask, pos = TL._arrivals(kmask)
    dropped = (emask > 0) & (pos >= C)
    return C, int(dropped.sum()), dropped[..., E - 1].reshape(x.shape[:2])


# --- router and capacity ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,E", [(16, 2, 4), (64, 8, 40), (32, 8, 128),
                                   (8, 1, 8)])
def test_router_matches_jax(jx, dtype, S, K, E):
    x, params = _moe_arrays(0, 64, E, 8, (2, S, 64))
    jxx, jp, tx, tp = _pair(jx, x, params, dtype)
    jprobs, jidx, jtop, jaux = jx.router(jxx, jp["w_router"], K)
    probs, idx, top, aux, _ = TL._router(tx, tp["w_router"], K)
    assert probs.dtype == top.dtype == aux.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-5)
    np.testing.assert_allclose(top.numpy(), np.asarray(jtop), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("S,K,E,factor", [
    (512, 8, 40, 1.0), (512, 8, 128, 1.0), (1, 8, 40, 1.0), (16, 2, 4, 1.0),
    (32, 2, 4, 0.25), (64, 2, 8, 4.0), (100, 3, 7, 1.5), (4096, 8, 128, 1.25)])
def test_capacity_matches_jax(jx, S, K, E, factor):
    assert TL._capacity(S, K, E, factor) == jx.JL._capacity(S, K, E, factor)


# --- the two dispatches against the reference -----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_moe_einsum_matches_jax(jx, dtype, factor):
    """With drops (capacity factor 1.0) and without (4.0)."""
    x, params = _moe_arrays(1, 64, 4, 32, (2, 32, 64))
    jxx, jp, tx, tp = _pair(jx, x, params, dtype)
    _, n_drop, _ = _drops(tx, tp, 2, factor)
    assert (n_drop > 0) == (factor == 1.0)
    jy, jaux = jx.moe(jxx, jp, top_k=2, capacity_factor=factor)
    y, aux = TL.moe_einsum(tx, tp, 2, factor)
    assert y.dtype == tx.dtype
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_matches_jax_on_its_finite_rows(jx, dtype):
    """Under drops the reference's gather is NaN on some rows; on every
    other row the port's gather equals it, and the port's has no NaN."""
    x, params = _moe_arrays(2, 64, 8, 32, (2, 64, 64))
    jxx, jp, tx, tp = _pair(jx, x, params, dtype)
    _, n_drop, last = _drops(tx, tp, 2, 1.0)
    assert n_drop > 0 and bool(last.any())
    jy, _ = jx.moe(jxx, jp, top_k=2, capacity_factor=1.0, impl="gather")
    y, _ = TL.moe_gather(tx, tp, 2, 1.0)
    finite = np.isfinite(_f32(jy)).all(axis=-1)
    assert 0 < finite.sum() < finite.size
    assert bool(torch.isfinite(y).all())
    _close(y, jy, dtype, rows=finite)


def test_reference_gather_nan_rows_are_dropped_last_expert_picks(jx):
    """d 64, 40 experts top-8, capacity factor 1.0, one group of 512 tokens
    (C 104): the reference's gather is NaN exactly on the tokens whose pick
    of the last expert was dropped (its slot index points past E·C). The
    port's rows there are finite, and its gather equals its einsum and the
    reference's einsum on every row."""
    x, params = _moe_arrays(3, 64, 40, 32, (1, 512, 64))
    jxx, jp, tx, tp = _pair(jx, x, params, "float32")
    C, n_drop, last = _drops(tx, tp, 8, 1.0)
    assert C == 104 and n_drop > 0 and bool(last.any())
    jy, _ = jx.moe(jxx, jp, top_k=8, capacity_factor=1.0, impl="gather")
    nan_rows = ~np.isfinite(_f32(jy)).all(axis=-1)
    np.testing.assert_array_equal(nan_rows, last.numpy())
    y_gather, _ = TL.moe_gather(tx, tp, 8, 1.0)
    y_einsum, _ = TL.moe_einsum(tx, tp, 8, 1.0)
    jy_einsum, _ = jx.moe(jxx, jp, top_k=8, capacity_factor=1.0)
    assert bool(torch.isfinite(y_gather).all())
    _close(y_gather, y_einsum)
    _close(y_gather, jy_einsum)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_equals_einsum_at_ample_capacity(jx, dtype):
    """No drops (factor 4.0): the port's gather equals its einsum and the
    reference's gather."""
    x, params = _moe_arrays(4, 16, 8, 32, (2, 64, 16))
    jxx, jp, tx, tp = _pair(jx, x, params, dtype)
    assert _drops(tx, tp, 2, 4.0)[1] == 0
    y_gather, _ = TL.moe(tx, tp, 2, 4.0, impl="gather")
    y_einsum, _ = TL.moe(tx, tp, 2, 4.0, impl="einsum")
    jy, _ = jx.moe(jxx, jp, top_k=2, capacity_factor=4.0, impl="gather")
    _close(y_gather, y_einsum, dtype)
    _close(y_gather, jy, dtype)


def test_gather_on_groups_smaller_than_capacity(jx):
    """A decode step groups one token (C is at least 8): the reference's
    gather fails its reshape there; the port's equals its einsum and the
    reference's einsum, at S 1 and S 6."""
    for S in (1, 6):
        x, params = _moe_arrays(5, 64, 4, 32, (2, S, 64))
        jxx, jp, tx, tp = _pair(jx, x, params, "float32")
        with pytest.raises(TypeError, match="reshape"):
            jx.moe(jxx, jp, top_k=2, impl="gather")
        y, _ = TL.moe_gather(tx, tp, 2)
        _close(y, TL.moe_einsum(tx, tp, 2)[0])
        _close(y, jx.moe(jxx, jp, top_k=2)[0])


# --- the reference's three MoE invariants, on the port ---------------------------

def test_moe_einsum_matches_gather():
    x, params = _moe_arrays(6, 16, 8, 32, (2, 64, 16), router_scale=0.02)
    tx, tp = _torch(x), {k: _torch(v) for k, v in params.items()}
    y1, _ = TL.moe(tx, tp, top_k=2, capacity_factor=4.0, impl="einsum")
    y2, _ = TL.moe(tx, tp, top_k=2, capacity_factor=4.0, impl="gather")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)


def test_moe_routing_mass_conservation():
    x, params = _moe_arrays(7, 8, 4, 16, (2, 32, 8), router_scale=0.02)
    _, idx, top, _, _ = TL._router(_torch(x), _torch(params["w_router"]),
                                   2)
    assert np.allclose(top.sum(-1).numpy(), 1.0, atol=1e-5)
    assert bool((top >= 0).all())
    assert bool((idx[..., 0] != idx[..., 1]).all())


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_capacity_drops_are_zero_not_garbage(impl):
    x, params = _moe_arrays(8, 8, 2, 16, (1, 64, 8), router_scale=0.02)
    tx, tp = _torch(x), {k: _torch(v) for k, v in params.items()}
    y_small, _ = TL.moe(tx, tp, top_k=2, capacity_factor=0.25, impl=impl)
    y_big, _ = TL.moe(tx, tp, top_k=2, capacity_factor=4.0, impl=impl)
    assert bool(torch.isfinite(y_small).all())
    assert float(y_small.norm()) <= float(y_big.norm()) + 1e-3


# --- the MoE family: reduced granite-moe and qwen3-moe ----------------------------

def _cfgs(jx, arch, factor=None):
    """The reference's and the port's reduced ``arch`` with remat on (and
    the capacity factor ``factor`` where given)."""
    out = []
    for cfg in (jx.j_get_arch(arch).reduced(), get_arch(arch).reduced()):
        kw = {"remat": True}
        if factor is not None:
            kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=factor)
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _routes(jx, fn):
    """Run ``fn`` with both packages' ``_router`` recording each call's
    picks; returns (fn's result, JAX picks, port picks) in call order."""
    JL, jax = jx.JL, jx.jax
    jpicks, tpicks = [], []
    jrouter, trouter = JL._router, TL._router

    def jrec(x, w, k):
        out = jrouter(x, w, k)
        jax.debug.callback(lambda i: jpicks.append(np.array(i)), out[1],
                           ordered=True)
        return out

    def trec(x, w, k):
        out = trouter(x, w, k)
        tpicks.append(out[1].numpy())
        return out
    JL._router, TL._router = jrec, trec
    try:
        res = fn()
        jax.effects_barrier()
    finally:
        JL._router, TL._router = jrouter, trouter
    return res, jpicks, tpicks


def _inputs():
    rng = np.random.default_rng(9)
    return (rng.integers(0, 256, (2, PROMPT)).astype(np.int32),
            rng.integers(0, 256, (2, PROMPT)).astype(np.int32))


def _ref_run(jx, arch, dtype, impl, factor):
    """The reference on reduced ``arch``: its weights, a prefill of B 2 ×
    PROMPT tokens (with every layer's picks), DECODE greedy decode steps
    from its cache, and the loss with every gradient (remat on). Decode
    runs the einsum dispatch: the reference's gather cannot decode."""
    jax, jnp = jx.jax, jx.jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = _cfgs(jx, arch, factor)[0]
    jb = jx.japi.build(jcfg, jx.mesh, moe_impl=impl, dtype=jdt)
    jp = jb.init(jax.random.PRNGKey(0))
    tokens, targets = _inputs()
    out = types.SimpleNamespace(params=jax.tree.map(np.asarray, jp),
                                steps=[])
    (jl, jc), out.picks, _ = _routes(jx, lambda: jax.jit(
        lambda p, b: jb.prefill(p, b, MAX_LEN))(
            jp, {"tokens": jnp.asarray(tokens)}))
    out.prefill, out.cache = jl, (jc.k, jc.v)
    jdec = jx.japi.build(jcfg, jx.mesh, moe_impl="einsum", dtype=jdt)
    jstep = jax.jit(lambda p, s, b, n: jdec.serve_step(p, s, b, length=n))
    tok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
    for i in range(DECODE):
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok)},
                       jnp.int32(PROMPT + i))
        out.steps.append((tok, jl))
        tok = np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32)
    out.loss = jax.jit(jax.value_and_grad(jb.loss))(
        jp, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
    return out


def _port_run(jx, ref, arch, dtype, impl, factor):
    """The port on the reference's weights and inputs: the prefill (with
    every layer's picks), decode fed the reference's tokens, the loss and
    every gradient."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tb = tapi.build(_cfgs(jx, arch, factor)[1], device="cpu", moe_impl=impl,
                    dtype=tdt)
    tp = lm_params_from_numpy(ref.params, device="cpu")
    tokens, targets = _inputs()
    out = types.SimpleNamespace(tp=tp, steps=[])
    with torch.no_grad():
        (tl, tc), _, out.picks = _routes(jx, lambda: tb.prefill(
            tp, {"tokens": torch.from_numpy(tokens)}, MAX_LEN))
        out.prefill = tl
        out.cache = (tc.k.clone(), tc.v.clone())     # decode writes tc
        for i, (tok, _) in enumerate(ref.steps):
            tl, tc = tb.serve_step(tp, tc, {"token": torch.from_numpy(tok)},
                                   length=PROMPT + i)
            out.steps.append(tl)
    out.loss = steps.value_and_grad(
        tb, tp, {"tokens": torch.from_numpy(tokens),
                 "targets": torch.from_numpy(targets)})
    return out


@pytest.fixture(scope="module")
def runs(jx):
    """(arch, dtype, impl, factor) -> (the reference's run, the port's).
    The reference runs its einsum dispatch unless ``factor`` makes its
    gather finite (``impl="gather"`` at ample capacity); the port runs
    ``impl``. Each reference run is made once for the file."""
    refs, memo = {}, {}

    def get(arch, dtype, impl, factor=None):
        rkey = (arch, dtype, impl if factor is not None else "einsum",
                factor)
        if rkey not in refs:
            refs[rkey] = _ref_run(jx, *rkey)
        key = (arch, dtype, impl, factor)
        if key not in memo:
            memo[key] = (refs[rkey],
                         _port_run(jx, refs[rkey], arch, dtype, impl, factor))
        return memo[key]
    return get


def _hold_model(run, dtype):
    """The port's routing picks of every layer first, then its prefill
    logits, K/V, decode logits and greedy tokens, against the reference's."""
    ref, got = run
    assert len(got.picks) == len(ref.picks) == 2        # one per layer
    for t, j in zip(got.picks, ref.picks):
        np.testing.assert_array_equal(t, j)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-2))
    assert got.prefill.shape == (2, 1, 256)
    assert got.prefill.dtype == torch.float32
    assert bool(torch.isfinite(got.prefill).all())
    np.testing.assert_allclose(_f32(got.prefill), _f32(ref.prefill), **tol)
    assert got.cache[0].shape == (2, 2, MAX_LEN, 1, 16)
    for a, b in zip(got.cache, ref.cache):
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)
    assert len(got.steps) == len(ref.steps) == DECODE
    for tl, (_, jl) in zip(got.steps, ref.steps):
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
        # the port's greedy token is the reference's
        np.testing.assert_array_equal(tl[..., :256].argmax(-1).numpy(),
                                      np.asarray(jl[..., :256].argmax(-1)))


def _hold_grads(run):
    (jloss, jg), (tloss, tg) = run[0].loss, run[1].loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tg["blocks"]["w_router"].dtype == torch.float32
    assert float(tg["blocks"]["w_router"].abs().max()) > 0
    for k in tg["blocks"]:
        want = _f32(jg["blocks"][k])
        np.testing.assert_allclose(_f32(tg["blocks"][k]), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=k)
    for k in ("embed", "head", "ln_f"):
        want = _f32(jg[k])
        np.testing.assert_allclose(_f32(tg[k]), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_prefill_decode_loss_and_grads_f32(runs, arch, impl):
    """Both dispatches against the reference's einsum model (capacity
    factor 1.0, picks dropped in the prefill): the routing picks of every
    layer, prefill logits, K/V, decode logits and greedy tokens, the loss
    with its aux term and every gradient, the router's too."""
    run = runs(arch, "float32", impl)
    _hold_model(run, "float32")
    _hold_grads(run)


def test_moe_model_picks_drop_at_the_configs_capacity(runs):
    """The reduced prefill drops picks at capacity factor 1.0 (one group of
    16 tokens a sequence, C 8), so the model tests above run drops."""
    _, got = runs("granite-moe-3b-a800m", "float32", "einsum")
    C = TL._capacity(PROMPT, 2, 4, 1.0)
    drops = 0
    for picks in got.picks:
        emask, pos = TL._arrivals(TL._one_hot(torch.from_numpy(picks), 4))
        drops += int(((emask > 0) & (pos >= C)).sum())
    assert C == 8 and drops > 0


def test_moe_gather_model_matches_the_reference_gather_at_ample_capacity(runs):
    """At capacity factor 4.0 nothing drops and the reference's gather is
    finite: the port's gather model equals it (its prefill, loss and
    gradients; both decode through the einsum dispatch's function)."""
    run = runs("granite-moe-3b-a800m", "float32", "gather", factor=4.0)
    _hold_model(run, "float32")
    _hold_grads(run)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_prefill_decode_bf16(runs, impl):
    """bf16 weights (the router f32): every layer's picks equal first, then
    the logits, K/V and greedy tokens at 3e-2; the loss at rtol 1e-3."""
    ref, got = runs("granite-moe-3b-a800m", "bfloat16", impl)
    assert got.tp["blocks"]["w_router"].dtype == torch.float32
    assert got.tp["blocks"]["wq"].dtype == torch.bfloat16
    _hold_model((ref, got), "bfloat16")
    (jloss, _), (tloss, tg) = ref.loss, got.loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    assert tg["blocks"]["w_router"].dtype == torch.float32


def test_moe_train_steps_and_checkpoint(tmp_path):
    """Two adamw steps of reduced granite-moe in bf16 with an f32 router,
    two microbatches: the f32 leaf keeps its dtype through the f32
    accumulator, adamw and a checkpoint round trip."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_accum_train_step
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced(),
                              remat=True)
    tb = tapi.build(cfg, device="cpu")
    params = tb.init(torch.Generator().manual_seed(0))
    opt = optim.adamw(1e-3)
    state = opt.init(params)
    step = make_accum_train_step(tb, opt, 2)
    pipe = TokenPipeline(cfg.vocab, 32, 4, device="cpu")
    router0 = params["blocks"]["w_router"].clone()
    losses = []
    for i in range(2):
        params, state, loss = step(params, state, pipe.batch(i))
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert params["blocks"]["w_router"].dtype == torch.float32
    assert params["blocks"]["w_gate_e"].dtype == torch.bfloat16
    assert not torch.equal(params["blocks"]["w_router"], router0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, state))
    (p2, s2), _ = mgr.restore((params, state))
    for k, t in params["blocks"].items():
        assert p2["blocks"][k].dtype == t.dtype and torch.equal(
            p2["blocks"][k], t)


def test_interop_keeps_the_router_f32(jx):
    """``lm_params_from_numpy`` with no ``dtype=`` (every caller's way) keeps
    each leaf's own dtype: the reference's f32 router among bf16 weights
    comes over f32, bit for bit, and matches the port's own spec."""
    arch = get_arch("granite-moe-3b-a800m").reduced()
    jb = jx.japi.build(jx.j_get_arch("granite-moe-3b-a800m").reduced(),
                       jx.mesh)
    tree = jx.jax.tree.map(np.asarray, jb.init(jx.jax.random.PRNGKey(0)))
    tp = lm_params_from_numpy(tree, device="cpu")
    specs = tapi.build(arch, device="cpu").param_specs()["blocks"]
    for k, t in tp["blocks"].items():
        assert t.dtype == specs[k].dtype, k
    assert tp["blocks"]["w_router"].dtype == torch.float32
    assert tp["blocks"]["w_gate_e"].dtype == tp["embed"].dtype == \
        torch.bfloat16
    np.testing.assert_array_equal(tp["blocks"]["w_router"].numpy(),
                                  tree["blocks"]["w_router"])


def test_moe_bundle_builds_and_counts_like_the_reference(jx):
    """Full-width specs of the two MoE configs (no allocation): the router
    f32, the experts bf16, the reference's parameter counts."""
    for arch in MOE_ARCHS:
        jb = jx.japi.build(jx.j_get_arch(arch), jx.mesh)
        tb = tapi.build(get_arch(arch), device="cpu")
        specs = tb.param_specs()["blocks"]
        assert specs["w_router"].dtype == torch.float32
        assert specs["w_router"].init == "small"
        assert specs["w_gate_e"].dtype == torch.bfloat16
        assert "w_gate" not in specs
        assert tb.n_params() == jb.n_params()


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("S,factor", [(512, 1.0), (512, 4.0), (1, 1.0)])
def test_cuda_moe_matches_cpu(cuda, impl, S, factor):
    """40 experts top-8 at d 64 on CUDA against the CPU in f32: one group
    of 512 tokens with dropped picks of the last expert, the same with
    ample capacity, and four decode-sized groups of one token."""
    x, params = _moe_arrays(3, 64, 40, 32, (1, S, 64) if S > 1 else
                            (4, 1, 64))
    tx, tp = _torch(x), {k: _torch(v) for k, v in params.items()}
    if S == 512 and factor == 1.0:     # test_reference_gather_nan_rows_...'s
        assert bool(_drops(tx, tp, 8, factor)[2].any())
    want, want_aux = TL.moe(tx, tp, 8, factor, impl=impl)
    ops.reset_launch_counts()
    got, aux = TL.moe(tx.to(cuda), {k: v.to(cuda) for k, v in tp.items()},
                      8, factor, impl=impl)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0     # no port kernel
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
