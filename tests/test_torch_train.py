"""The port's LM training path (``models.layers.attention`` under autograd,
``models.transformer.forward_hidden`` / ``chunked_ce_loss``,
``ModelBundle.loss``, ``launch.steps.make_train_step``,
``train.trainer.make_accum_train_step``) against the JAX reference.

Reduced tinyllama (2 layers, d 64, vocab 256; 4 layers for the remat
groups), S ≤ 64, on the CPU. The reference runs jitted and its weights
reach the port through ``models.interop.lm_params_from_numpy``; the
batches are ``repro.data.pipeline.TokenPipeline``'s, moved through numpy.

Tolerances:
* f32 attention output and gradients (S 64, chunk 16, GQA): rtol 1e-5,
  atol 1e-5 of the tensor's largest magnitude (sums in another order).
* f32 hidden states, CE loss values and gradients, ``ModelBundle.loss``
  and every leaf's gradient: rtol 1e-4, atol 1e-5 × the leaf's largest
  magnitude.
* bf16 ``ModelBundle.loss``: rtol 1e-3; every leaf's gradient within a
  relative L2 distance of 3e-2 and max |Δ| ≤ 4e-2 × the leaf's largest
  magnitude. XLA keeps some intermediates of the backward pass in f32
  where PyTorch rounds each op's output to bf16; measured 0.6–1.4e-2
  relative L2 and ≤ 1.7e-2 max (a few bf16 ulps).
* The port's remat on and off, groups of 1 and 2: the same bits (the
  recomputed forward pass is the same sequence of CPU ops).
* f32 training trajectories (3 adamw steps at lr 1e-3, microbatches 1
  and 2): losses rtol 1e-5; each parameter leaf within a relative L2
  distance of 1e-5 and max |Δ| ≤ 1e-4, a tenth of lr: Adam divides by
  √v, so an element whose gradient is rounding noise moves by up to ~lr
  in either package (one wq element of 8192 differs by 2.1e-5, the
  leaves' relative L2 ≤ 2e-6); the moments rtol 1e-4, atol 1e-5 × the
  leaf's largest magnitude.
* bf16 against f32 accumulation (the port alone, mirroring
  ``tests/test_memory_features.py::test_bf16_accum_close_to_f32``): loss
  rtol 1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as j_get_arch
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import optim as joptim
from repro.train.trainer import make_accum_train_step as j_accum_step
from repro_torch.ckpt.manager import flatten
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.interop import lm_params_from_numpy
from repro_torch.train import optim
from repro_torch.train.trainer import make_accum_train_step

ARCH = "tinyllama-1.1b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**kw):
    j = dataclasses.replace(j_get_arch(ARCH).reduced(), **kw)
    t = dataclasses.replace(get_arch(ARCH).reduced(), **kw)
    return j, t


def _bundles(dtype="float32", S=64, B=2, **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(**kw)
    jb = japi.build(jcfg, make_host_mesh(), JShape("t", S, B, "train"),
                    dtype=jdt)
    return jb, tapi.build(tcfg, device="cpu", dtype=tdt)


def _params(jb, key=0):
    """The reference's init and the same numbers as the port's params."""
    jp = jb.init(jax.random.PRNGKey(key))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _batch(vocab, S, B, seed=1, step=0):
    jbatch = JPipe(vocab, S, B, seed=seed).batch(step)
    return jbatch, {k: torch.from_numpy(np.array(v))
                    for k, v in jbatch.items()}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol=1e-4, atol=1e-5):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def _close_tree(got, want, rtol=1e-4, atol=1e-5):
    g, w = flatten(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, rtol, atol)


# --- attention under autograd ---------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_grad_matches_jax(causal):
    """S 64 in chunks of 16, 8 query heads over 2 KV heads, f32: the value
    and the gradients of q, k, v against ``jax.grad`` of the reference's
    ``attention`` (each chunk under ``jax.checkpoint``)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 64, 8, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    w = rng.normal(size=(2, 64, 8, 16)).astype(np.float32)

    def jloss(q, k, v):
        o = JL.attention(q, k, v, causal=causal, chunk=16)
        return jnp.sum(o * w), o
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = TL.attention(tq, tk, tv, causal=causal, chunk=16)
    torch.sum(tout * torch.from_numpy(w)).backward()
    _close(tout, jout, 1e-5, 1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad, j, 1e-5, 1e-5)


def test_attention_checkpoints_each_chunk_under_grad(monkeypatch):
    """Under grad mode each query chunk runs under a checkpoint (4 chunks,
    and 4 more recomputations in the backward pass); under no_grad none."""
    calls = []
    real = TL._attend_block
    monkeypatch.setattr(TL, "_attend_block",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    with torch.no_grad():
        want = TL.attention(q, k, v, chunk=16)
    assert len(calls) == 4
    q.requires_grad_()
    got = TL.attention(q, k, v, chunk=16)
    assert len(calls) == 8
    got.sum().backward()
    assert len(calls) == 12
    assert torch.equal(got.detach(), want)


def test_flash_kernel_refuses_autograd():
    """The CUDA wrapper has no backward: under grad mode it raises on q, k
    or v that require grad, before it looks at the device; under no_grad
    it goes on to its device check."""
    q = torch.zeros(1, 8, 2, 16)
    for i in range(3):
        args = [q.clone(), q.clone(), q.clone()]
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_flash.flash_attention(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            cuda_flash.flash_attention(*args)


def test_training_takes_the_plain_attention(monkeypatch):
    """With the kernel route forced open (as on a CUDA tensor), the loss
    and its backward never reach ``ops.flash_attention``."""
    def refuse(*a, **kw):
        raise AssertionError("the training path reached the flash kernel")
    monkeypatch.setattr(ops, "flash_attention", refuse)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    _, tb = _bundles()
    params = tb.init(torch.Generator().manual_seed(0))
    _, batch = _batch(256, 64, 2)
    loss, grads = steps.value_and_grad(tb, params, batch)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in flatten(grads))
    with pytest.raises(AssertionError, match="flash kernel"):
        TL.attention(*(torch.zeros(1, 8, 2, 16),) * 3)


# --- forward_hidden and the loss ---------------------------------------------------

@pytest.mark.parametrize("remat,group", [(False, 1), (True, 1), (True, 2),
                                         (False, 2)])
def test_forward_hidden_remat_matches_jax(remat, group):
    """4 layers, remat on and off, groups of 1 and 2: the hidden states, the
    loss and every gradient against the reference with the same config
    (mirrors ``test_grouped_remat_matches_ungrouped_loss``), and the same
    bits as the port without remat."""
    kw = dict(n_layers=4, remat=remat, remat_group=group)
    jb, tb = _bundles(S=32, **kw)
    jp, tp = _params(jb)
    jbatch, tbatch = _batch(256, 32, 2)
    jh, _ = jax.jit(lambda p, b: JT.forward_hidden(
        jb.cfg, jb.mesh, jb.rules, p, b))(jp, jbatch)
    with torch.no_grad():
        th, aux = TT.forward_hidden(tb.cfg, tp, tbatch)
    assert aux == 0.0
    _close(th, jh)
    jl, jg = jax.jit(jax.value_and_grad(jb.loss))(jp, jbatch)
    tl, tg = steps.value_and_grad(tb, tp, tbatch)
    _close(tl, jl)
    _close_tree(tg, jg)
    _, plain = _bundles(S=32, n_layers=4, remat=False, remat_group=1)
    pl, pg = steps.value_and_grad(plain, tp, tbatch)
    assert torch.equal(tl, pl)
    for a, b in zip(flatten(tg), flatten(pg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,chunk,vocab,width", [
    (64, 16, 256, 256),     # four chunks
    (40, 16, 256, 256),     # 40 % 16 != 0: one chunk of 40
    (64, 32, 200, 256),     # head wider than the vocab: columns masked
])
def test_chunked_ce_loss_matches_jax(S, chunk, vocab, width):
    """Value and gradients with respect to hidden and head, f32, with the
    pipeline's mask (last position 0)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, S, 64)).astype(np.float32)
    w = (rng.normal(size=(64, width)) * 0.3).astype(np.float32)
    jbatch, tbatch = _batch(vocab, S, 2)

    def jloss(h, w):
        return JT.chunked_ce_loss(jcfg, None, None, h, w, jbatch["targets"],
                                  jbatch["mask"], vocab, chunk=chunk)
    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(h, w)
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tl = TT.chunked_ce_loss(tcfg, th, tw, tbatch["targets"], tbatch["mask"],
                            vocab, chunk=chunk)
    tl.backward()
    _close(tl, jl)
    _close(th.grad, jgh)
    _close(tw.grad, jgw)
    if width > vocab:
        assert not tw.grad[:, vocab:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_loss_and_grads_match_jax(dtype):
    """``ModelBundle.loss`` and the gradient of every leaf, both bundles in
    ``dtype``, the same weights (bf16 goes over through f32)."""
    jb, tb = _bundles(dtype)
    jp, tp = _params(jb)
    jbatch, tbatch = _batch(256, 64, 2)
    jl, jg = jax.jit(jax.value_and_grad(jb.loss))(jp, jbatch)
    tl, tg = steps.value_and_grad(tb, tp, tbatch)
    assert tl.dtype == torch.float32
    assert [g.dtype for g in flatten(tg)] == [p.dtype for p in flatten(tp)]
    if dtype == "float32":
        _close(tl, jl)
        _close_tree(tg, jg)
        return
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for a, b in zip(flatten(tg), jax.tree.leaves(jg)):
        a, b = _np32(a), _np32(b)
        assert np.linalg.norm(a - b) <= 3e-2 * np.linalg.norm(b)
        assert np.abs(a - b).max() <= 4e-2 * np.abs(b).max()


def test_train_step_leaves_params_untouched():
    """``make_train_step`` returns new trees: the params it was given keep
    their values, carry no gradient and require none."""
    _, tb = _bundles()
    params = tb.init(torch.Generator().manual_seed(0))
    before = [p.clone() for p in flatten(params)]
    opt = optim.adamw(1e-3)
    _, batch = _batch(256, 64, 2)
    new, state, loss = steps.make_train_step(tb, opt)(params, opt.init(params),
                                                      batch)
    for p, b in zip(flatten(params), before):
        assert torch.equal(p, b) and p.grad is None and not p.requires_grad
    assert all(not p.requires_grad and p.grad_fn is None
               for p in flatten(new))
    assert int(state[2]) == 1 and loss.grad_fn is None


# --- accumulation ---------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_accum_train_step_matches_jax(microbatches):
    """3 adamw steps on the pipeline's batches, f32: the losses and the
    final parameters against the reference's jitted step."""
    jb, tb = _bundles(S=32, B=4)
    jp, tp = _params(jb)
    jopt, topt = joptim.adamw(1e-3), optim.adamw(1e-3)
    jstep = jax.jit(j_accum_step(jb, jopt, microbatches))
    tstep = make_accum_train_step(tb, topt, microbatches)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        jbatch, tbatch = _batch(256, 32, 4, seed=2, step=step)
        jp, js, jl = jstep(jp, js, jbatch)
        tp, ts, tl = tstep(tp, ts, tbatch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(flatten(tp), jax.tree.leaves(jp)):
        a, b = _np32(a), _np32(b)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
        assert np.abs(a - b).max() <= 1e-4
    _close_tree(ts, js)


def test_bf16_accum_close_to_f32():
    _, tb = _bundles(S=32, B=4)
    params = tb.init(torch.Generator().manual_seed(0))
    opt = optim.adamw(1e-3)
    _, batch = _batch(256, 32, 4)
    outs = {}
    for name, adt in (("f32", None), ("bf16", torch.bfloat16)):
        step = make_accum_train_step(tb, opt, 2, accum_dtype=adt)
        _, _, loss = step(params, opt.init(params), batch)
        outs[name] = float(loss)
    np.testing.assert_allclose(outs["f32"], outs["bf16"], rtol=1e-2)


def test_pipeline_batch_trains_as_the_port_pipeline():
    """The port's ``TokenPipeline`` feeds the step directly (int32 tokens
    and targets, f32 mask) and gives the reference pipeline's loss."""
    _, tb = _bundles()
    params = tb.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(256, 64, 2, seed=1, device="cpu").batch(0)
    _, want = _batch(256, 64, 2)
    with torch.no_grad():
        assert torch.equal(tb.loss(params, batch), tb.loss(params, want))
