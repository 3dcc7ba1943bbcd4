"""The port's hybrid family (``repro_torch.models.jamba``: Mamba2 mixers and
NoPE attention 7:1, an MoE on every other layer) against the JAX
reference, at reduced jamba-v0.1-52b (d 64, 4 experts top-2, state 16):
one period (8 layers, ``reduced()``'s) and two (16 layers), since one
period would not exercise the stacking over periods.

Inputs are made with numpy from a seed; the weights come from the
reference's ``bundle.init(PRNGKey(0))`` through
``models.interop.lm_params_from_numpy`` (the routers, dt_bias, A_log and
D keep f32), and the reference runs jitted. The module-scoped ``runs``
fixture keeps one reference run per (periods, dtype).

Tolerances: logits and decode state in f32 relative L2 1e-5, the loss
rtol 1e-5, every gradient relative L2 1e-4 a leaf; bf16 logits rtol =
atol = 3e-2 (``tests/test_torch_lm.py``'s) after every MoE layer's picks
are held equal; decode against the full forward in bf16 by the
reference's rule (rtol 5e-2, atol 5e-1, argmax agreement above 0.95).
The reference's gather cannot decode (ROADMAP Queue 3): the port's gather
model is held to the reference's einsum model.

On a card (``cuda`` marker; the reference is imported only inside
fixtures):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_hybrid.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import jamba as TJ
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models.common import leaves, tree_map
from repro_torch.models.interop import lm_params_from_numpy

ARCH = "jamba-v0.1-52b"
PROMPT, MAX_LEN, DECODE = 16, 32, 4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    from repro.models import jamba as JJ
    from repro.models import layers as JL
    return types.SimpleNamespace(jax=jax, jnp=jnp, JJ=JJ, JL=JL, japi=japi,
                                 JShape=JShape, j_get_arch=j_get_arch,
                                 mesh=make_host_mesh())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfg(periods, pkg_get_arch):
    """Reduced jamba with remat on, at ``periods`` periods of 8 layers."""
    cfg = pkg_get_arch(ARCH).reduced()
    return dataclasses.replace(cfg, n_layers=8 * periods, remat=True)


def _inputs():
    rng = np.random.default_rng(21)
    return (rng.integers(0, 256, (2, PROMPT)).astype(np.int32),
            rng.integers(0, 256, (2, PROMPT)).astype(np.int32))


def _routes(jx, fn, pin=None):
    """Run ``fn`` with both packages' ``_router`` recording each call's
    picks; returns (fn's result, JAX picks, port picks) in call order. With
    ``pin`` (a list of picks, one a router call) the port's call i takes
    pin[i]'s picks instead, weighted by its own probabilities (as
    ``chip_smoke.route_log`` pins them); its own picks are still
    recorded."""
    JL, jax = jx.JL, jx.jax
    jpicks, tpicks = [], []
    jrouter, trouter = JL._router, TL._router
    pinned = iter(pin) if pin is not None else None

    def jrec(x, w, k):
        out = jrouter(x, w, k)
        jax.debug.callback(lambda i: jpicks.append(np.array(i)), out[1],
                           ordered=True)
        return out

    def trec(x, w, k):
        probs, idx, top, aux, kmask = trouter(x, w, k)
        tpicks.append(idx.numpy())
        if pinned is not None:
            idx = torch.from_numpy(next(pinned)).long()
            kmask = TL._one_hot(idx, w.shape[-1])
            top = probs.gather(-1, idx)
            top = top / top.sum(dim=-1, keepdim=True)
            ce = F.one_hot(idx[..., 0], w.shape[-1]).float().mean(dim=(0, 1))
            aux = w.shape[-1] * torch.sum(probs.mean(dim=(0, 1)) * ce)
        return probs, idx, top, aux, kmask
    JL._router, TL._router = jrec, trec
    try:
        res = fn()
        jax.effects_barrier()
    finally:
        JL._router, TL._router = jrouter, trouter
    return res, jpicks, tpicks


def _weights(jx, w2, jb, periods):
    """The reference's two-period f32 weights ``w2`` cut to ``periods`` and
    cast to ``jb``'s dtypes: its init draws f32 and casts each leaf to its
    spec's dtype, so at two periods this is what ``jb.init`` draws."""
    cut = dict(w2, blocks=jx.jax.tree.map(lambda t: t[:periods],
                                          w2["blocks"]))
    return jx.jax.tree.map(lambda t, s: t.astype(s.dtype), cut,
                           jb.param_specs())


def _ref_run(jx, w2, periods, dtype):
    """The reference: its weights; the prefill's logits and decode over the
    prompt from the zero state and DECODE greedy tokens after it (every
    router call's picks recorded, in that order); the loss, with every
    gradient in f32."""
    jax, jnp = jx.jax, jx.jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = _cfg(periods, jx.j_get_arch)
    jb = jx.japi.build(jcfg, jx.mesh, dtype=jdt)
    jp = _weights(jx, w2, jb, periods)
    tokens, targets = _inputs()
    out = types.SimpleNamespace(params=jax.tree.map(np.asarray, jp),
                                fed=[], steps=[])

    def serve():
        out.prefill, _ = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(
            jp, {"tokens": jnp.asarray(tokens)})
        state = jb.serve_state_shape(jx.JShape("s", MAX_LEN, 2, "decode"))
        step = jax.jit(lambda p, s, b, n: jb.serve_step(p, s, b, length=n))
        for t in range(PROMPT + DECODE):
            tok = (tokens[:, t:t + 1] if t < PROMPT else
                   np.asarray(jnp.argmax(jl[..., :256], -1)).astype(np.int32))
            jl, state = step(jp, state, {"token": jnp.asarray(tok)},
                             jnp.int32(t))
            out.fed.append(tok)
            out.steps.append(jl)
        out.state = jax.tree.leaves(state)   # dict keys sorted: pos0..pos7
    _, out.picks, _ = _routes(jx, serve)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    grads = periods == 2 and dtype == "float32"
    out.loss = (jax.jit(jax.value_and_grad(jb.loss))(jp, batch) if grads
                else (jax.jit(jb.loss)(jp, batch), None))
    return out


def _port_run(jx, ref, periods, dtype, impl="einsum", pin=False):
    """The port on the reference's weights and inputs, the same calls in
    the same order (the decode fed the reference's tokens); with ``pin``
    every router call takes the reference's picks of that call."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tb = tapi.build(_cfg(periods, get_arch), device="cpu", dtype=tdt,
                    moe_impl=impl)
    tp = lm_params_from_numpy(ref.params, device="cpu")
    tokens, targets = _inputs()
    out = types.SimpleNamespace(tb=tb, tp=tp, steps=[])

    def serve():
        out.prefill, out.prefill_state = tb.prefill(
            tp, {"tokens": torch.from_numpy(tokens)}, MAX_LEN)
        state = tb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        for t, tok in enumerate(ref.fed):
            lg, state = tb.serve_step(tp, state,
                                      {"token": torch.from_numpy(tok)},
                                      length=t)
            out.steps.append(lg)
        out.state = state
    with torch.no_grad():
        _, _, out.picks = _routes(jx, serve, ref.picks if pin else None)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    out.loss = (steps.value_and_grad(tb, tp, batch) if ref.loss[1]
                is not None else (tb.loss(tp, batch), None))
    return out


@pytest.fixture(scope="module")
def runs(jx):
    refs, memo = {}, {}
    w2 = jx.japi.build(_cfg(2, jx.j_get_arch), jx.mesh,
                       dtype=jx.jnp.float32).init(jx.jax.random.PRNGKey(0))

    def get(periods, dtype, impl="einsum", pin=False):
        if (periods, dtype) not in refs:
            refs[periods, dtype] = _ref_run(jx, w2, periods, dtype)
        key = (periods, dtype, impl, pin)
        if key not in memo:
            memo[key] = (refs[periods, dtype],
                         _port_run(jx, refs[periods, dtype], periods, dtype,
                                   impl, pin))
        return memo[key]
    return get


def _state_leaves(state):
    """A jamba decode state's tensors in ``jax.tree.leaves`` order."""
    return [t for k in sorted(state) for t in state[k]]


def _hold_f32(run, periods):
    ref, got = run
    # the prefill's and every decode step's MoE layers
    assert len(got.picks) == len(ref.picks) == \
        4 * periods * (1 + PROMPT + DECODE)
    for t, j in zip(got.picks, ref.picks):
        np.testing.assert_array_equal(t, j)
    assert got.prefill.shape == (2, 1, 256) and got.prefill_state is None
    assert _rel_l2(got.prefill, ref.prefill) <= 1e-5
    assert len(got.steps) == len(ref.steps) == PROMPT + DECODE
    for tl, jl in zip(got.steps, ref.steps):
        assert _rel_l2(tl, jl) <= 1e-5
    tl, jl = _state_leaves(got.state), ref.state
    assert len(tl) == len(jl)
    for g, w in zip(tl, jl):
        assert _rel_l2(g, w) <= 1e-5


def _hold_grads(run):
    (jloss, jg), (tloss, tg) = run[0].loss, run[1].loss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    n = 0
    for path, t in leaves(tg):
        w, p = jg, run[1].tp
        for k in path:
            w, p = w[k], p[k]
        assert t.dtype == p.dtype, path
        assert _rel_l2(t, w) <= 1e-4, path
        n += 1
    assert n == len(list(leaves(run[1].tp)))


@pytest.mark.parametrize("periods", [1, 2])
def test_jamba_prefill_decode_loss_and_grads_f32(runs, periods):
    """Every MoE layer's picks, prefill logits, every decode step (the
    prompt, then greedy tokens) and the final state of every position and
    period, the loss with its aux term; at two periods every gradient (the
    routers', dt_bias's, A_log's and D's f32)."""
    run = runs(periods, "float32")
    _hold_f32(run, periods)
    if periods == 2:
        _hold_grads(run)
    else:
        np.testing.assert_allclose(float(run[1].loss[0]),
                                   float(run[0].loss[0]), rtol=1e-5)


def test_jamba_gather_model_matches_the_reference_einsum_f32(runs):
    """The port's gather dispatch (which the reference cannot decode with)
    against the reference's einsum model at two periods, prefill, decode
    and loss with every gradient."""
    run = runs(2, "float32", "gather")
    _hold_f32(run, 2)
    _hold_grads(run)


def test_jamba_prefill_decode_bf16(runs):
    """bf16 weights (the routers, dt_bias, A_log and D f32). Unpinned, the
    port makes at least 98% of the reference's picks (as sets: a near-tie
    may swap inside the top 2; bf16 noise flips a few near-ties between
    the two packages' Mamba mixers). With every router call pinned to the
    reference's picks, the logits agree at 3e-2; the loss (unpinned) at
    rtol 1e-3."""
    ref, got = runs(2, "bfloat16", pin=True)
    blocks = got.tp["blocks"]
    assert blocks["pos1"]["moe"]["w_router"].dtype == torch.float32
    assert blocks["pos0"]["mamba"]["A_log"].dtype == torch.float32
    assert blocks["pos4"]["attn"]["wq"].dtype == torch.bfloat16
    assert len(got.picks) == len(ref.picks)
    same = [np.sort(t, -1) == np.sort(j, -1)
            for t, j in zip(got.picks, ref.picks)]
    assert float(np.mean([m.mean() for m in same])) >= 0.98
    tol = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_f32(got.prefill), _f32(ref.prefill), **tol)
    for tl, jl in zip(got.steps, ref.steps):
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    np.testing.assert_allclose(float(got.loss[0]), float(ref.loss[0]),
                               rtol=1e-3)


def _decode_vs_forward(jx, tp, cfg, dtype, pin: bool):
    """The port's logits at every prompt position from its full forward
    pass and from decode over the prompt (zero state), at ``cfg``; with
    ``pin`` each decode step's MoE layers take the forward pass's picks of
    that token. Returns (decode, forward, the share of (token, layer) pick
    sets the two paths made alike unpinned)."""
    tb = tapi.build(cfg, device="cpu", dtype=dtype)
    tokens = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        (h, _), _, fpicks = _routes(jx, lambda: TJ.forward_hidden(
            cfg, tp, {"tokens": tokens}))
        full = (h @ tp["head"]).float()
        per_step = [fp[:, t:t + 1] for t in range(PROMPT) for fp in fpicks]

        def run():
            state = tb.serve_state_shape(ShapeConfig("s", PROMPT, 2,
                                                     "decode"))
            return torch.cat([tb.serve_step(
                tp, state, {"token": tokens[:, t:t + 1]}, length=t)[0]
                for t in range(PROMPT)], dim=1)
        dec, _, dpicks = _routes(jx, run, per_step if pin else None)
    alike = np.mean([(np.sort(a, -1) == np.sort(b, -1)).all(-1).mean()
                     for a, b in zip(dpicks, per_step)])
    return dec, full, float(alike)


def _roomy(cfg):
    """``cfg`` at capacity factor 4.0: C 16 at the prompt's 16 tokens, so
    the forward pass drops no pick."""
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))


def _ref_agreement(jx, params, tokens):
    """The reference's own bf16 decode against its own full forward pass
    (roomy capacity): the share of positions whose argmax agree."""
    jax, jnp = jx.jax, jx.jnp
    cfg = _roomy(_cfg(2, jx.j_get_arch))
    jb = jx.japi.build(cfg, jx.mesh, dtype=jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, params)
    full = jax.jit(lambda p, t: (jx.JJ.forward_hidden(
        cfg, jx.mesh, jb.rules, p, {"tokens": t})[0] @ p["head"]))(
            jp, jnp.asarray(tokens))
    state = jb.serve_state_shape(jx.JShape("s", PROMPT, 2, "decode"))
    step = jax.jit(lambda p, s, b, n: jb.serve_step(p, s, b, length=n))
    dec = []
    for t in range(PROMPT):
        lg, state = step(jp, state, {"token": jnp.asarray(tokens[:, t:t + 1])},
                         jnp.int32(t))
        dec.append(lg)
    dec = jnp.concatenate(dec, axis=1)
    return float(jnp.mean(jnp.argmax(dec, -1) == jnp.argmax(full, -1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_decode_matches_full_forward(jx, runs, dtype):
    """The port's decode over the prompt against its full forward pass at
    two periods and capacity factor 4.0 (at the config's 1.0 the forward
    pass drops picks that decode, one token a group, never drops: another
    function). f32: the same function, relative L2 1e-5, every argmax and
    every pick set equal. bf16: the two paths' noise flips near-tied
    routes between them, so decode takes the forward pass's picks; then
    the reference's rule (rtol 5e-2, atol 5e-1), and argmax agreement at
    least the reference's own decode-against-forward agreement on the same
    weights and tokens (0.9375 here: the reference misses its 0.95 at this
    depth, its bf16 argmaxes tying within the paths' noise)."""
    _, got = runs(2, dtype)
    cfg = got.tb.cfg
    C = TL._capacity(PROMPT, cfg.moe.top_k, cfg.moe.num_experts, 1.0)
    assert C == 8 and any(
        int(((e > 0) & (p >= C)).sum())
        for e, p in (TL._arrivals(TL._one_hot(torch.from_numpy(i), 4))
                     for i in got.picks[:8]))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    dec, full, alike = _decode_vs_forward(jx, got.tp, _roomy(cfg), tdt,
                                          pin=dtype == "bfloat16")
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    if dtype == "float32":
        assert _rel_l2(dec, full) <= 1e-5 and agree == 1.0 and alike == 1.0
        return
    np.testing.assert_allclose(_f32(dec), _f32(full), rtol=5e-2, atol=5e-1)
    want = _ref_agreement(jx, runs(2, dtype)[0].params, _inputs()[0])
    assert agree >= want, (agree, want)
    assert alike >= 0.9, alike


def test_jamba_decode_writes_each_periods_view_in_place(runs):
    """One decode step writes row ``length`` of period j's K/V (no other
    row) and each period's SSM state, into the tensors it was given."""
    _, got = runs(2, "float32")
    tb, tp = got.tb, got.tp
    state = tb.serve_state_shape(ShapeConfig("s", 8, 2, "decode"))
    before = tree_map(torch.clone, {k: dict(enumerate(v))
                                    for k, v in state.items()})
    ptrs = [t.data_ptr() for k in state for t in state[k]]
    with torch.no_grad():
        _, out = tb.serve_step(tp, state, {"token": torch.ones(
            2, 1, dtype=torch.int32)}, length=3)
    assert out is state
    assert [t.data_ptr() for k in out for t in out[k]] == ptrs
    k, v = out["pos4"]
    assert k.shape == (2, 2, 8, 1, 16)
    for j in range(2):
        assert bool(k[j, :, 3].any()) and bool(v[j, :, 3].any())
        rest = [r for r in range(8) if r != 3]
        assert not bool(k[j][:, rest].any()) and not bool(v[j][:, rest].any())
        for i in (0, 7):
            for new, old in zip(out[f"pos{i}"], before[f"pos{i}"].values()):
                assert not torch.equal(new[j], old[j])


def test_jamba_engine_tokens_equal_the_reference(jx, runs):
    """``ServingEngine`` (3 slots, 5 requests) at one period in f32 on the
    reference's weights, token for token."""
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng
    ref, got = runs(1, "float32")
    jb = jx.japi.build(_cfg(1, jx.j_get_arch), jx.mesh, dtype=jx.jnp.float32)
    jp = jx.jax.tree.map(jx.jnp.asarray, ref.params)
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(5)]

    def run(mod, bundle, params):
        eng = mod.ServingEngine(bundle, params, slots=3, max_len=32)
        return eng.run([mod.Request(rid=i, prompt=p, max_new=5)
                        for i, p in enumerate(prompts)], max_steps=64)
    ops.reset_launch_counts()
    assert run(teng, got.tb, got.tp) == run(jeng, jb, jp)
    assert sum(ops.launch_counts().values()) == 0


def test_jamba_interop_keeps_every_leafs_dtype(runs):
    """``lm_params_from_numpy`` on the reference's nested tree: every
    leaf's path, shape and dtype equal the port's spec (the routers,
    dt_bias, A_log and D f32 among bf16 weights), bit for bit."""
    ref, got = runs(2, "bfloat16")
    specs = dict(leaves(got.tb.param_specs()))
    tp = dict(leaves(got.tp))
    assert set(tp) == set(specs)
    for path, t in tp.items():
        assert tuple(t.shape) == specs[path].shape, path
        assert t.dtype == specs[path].dtype, path
    w = ref.params["blocks"]["pos3"]["moe"]["w_router"]
    np.testing.assert_array_equal(
        got.tp["blocks"]["pos3"]["moe"]["w_router"].numpy(), w)


def test_jamba_specs_shapes_and_counts_like_the_reference(jx):
    """Full-width specs (no allocation): every leaf's path, shape and
    dtype, the parameter count, the inputs, and the serve state's shapes
    and dtypes at a small batch and length."""
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
    tspecs = {p: (s.shape, str(s.dtype).split(".")[-1])
              for p, s in leaves(tb.param_specs())}
    assert tspecs == jspecs
    for kind in ("train", "prefill", "decode"):
        t = tb.input_specs(ShapeConfig("x", 64, 2, kind))
        j = jb.input_specs(jx.JShape("x", 64, 2, kind))
        assert {k: v.shape for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
    t = tb.serve_state_shape(ShapeConfig("s", 8, 1, "decode"))
    j = jx.jax.eval_shape(lambda: jb.serve_state_shape(
        jx.JShape("s", 8, 1, "decode")))
    jl = jx.jax.tree.leaves(j)
    tl = _state_leaves(t)
    assert [tuple(a.shape) for a in tl] == [tuple(b.shape) for b in jl]
    assert [str(a.dtype).split(".")[-1] for a in tl] == \
        [jx.jnp.dtype(b.dtype).name for b in jl]
    assert all(isinstance(t[f"pos{i}"], TM.SSMState) for i in range(8)
               if i != 4)


def test_jamba_model_flops_match_reference():
    from repro.analysis.model_flops import model_flops as ref_flops
    from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
    from repro.configs.base import get_arch as ref_arch
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs.base import SHAPES_BY_NAME
    for shape in SHAPES_BY_NAME:
        got = model_flops(get_arch(ARCH), SHAPES_BY_NAME[shape])
        assert got == ref_flops(ref_arch(ARCH), REF_SHAPES[shape]) > 0, shape


def test_jamba_positions_match_the_reference(jx):
    cfg = get_arch(ARCH)
    assert TJ._positions(cfg) == jx.JJ._positions(jx.j_get_arch(ARCH))
    assert [m for m, _ in TJ._positions(cfg)].count("attn") == 1
    assert [f for _, f in TJ._positions(cfg)] == ["mlp", "moe"] * 4


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_jamba_prefill_launches_the_kernel_per_period(cuda):
    """Reduced jamba at two periods in f32 on CUDA: the prefill launches
    flash_attention once per period and matches the CPU's plain prefill;
    decode and the loss (the plain attention) match the CPU's."""
    cfg = _cfg(2, get_arch)
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32)
    params = tb.init(torch.Generator().manual_seed(0))
    gb = tapi.build(cfg, device=cuda, dtype=torch.float32)
    gp = tree_map(lambda t: t.to(cuda), params)
    tokens, targets = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        want, _ = tb.prefill(params, {"tokens": tokens}, MAX_LEN)
        ops.reset_launch_counts()
        got, _ = gb.prefill(gp, {"tokens": tokens.to(cuda)}, MAX_LEN)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 2
        assert _rel_l2(got, want) <= 1e-4
        sc = tb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        sg = gb.serve_state_shape(ShapeConfig("s", MAX_LEN, 2, "decode"))
        for t in range(PROMPT):
            wl, sc = tb.serve_step(params, sc, {"token": tokens[:, t:t + 1]},
                                   length=t)
            gl, sg = gb.serve_step(gp, sg, {"token": tokens[:, t:t + 1].to(
                cuda)}, length=t)
            assert _rel_l2(gl, wl) <= 1e-5
    ops.reset_launch_counts()
    loss = gb.loss(gp, {"tokens": tokens.to(cuda),
                        "targets": targets.to(cuda)})
    assert sum(ops.launch_counts().values()) == 0
    np.testing.assert_allclose(float(loss), float(tb.loss(
        params, {"tokens": tokens, "targets": targets})), rtol=1e-5)
