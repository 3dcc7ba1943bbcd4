"""The port's optimizers and backprop baselines against the JAX reference.

* ``train.optim``: one and five updates of each of the six optimizers on the
  same f32 params and grads (numpy, from a seed; a tree of dicts, lists, a
  3-d leaf, a 1-d leaf and a scalar), the reference run eagerly. Params and
  moments at rtol 1e-6 of each element, or of the leaf's largest magnitude
  where an element is smaller: PyTorch's f32 ``sqrt`` on the CPU is not
  correctly rounded (a few values in a thousand are one ulp off XLA's), and
  a parameter that an Adadelta step nearly cancels carries that ulp of the
  step into a large relative error of a small result. Step counts and
  ``adamw8bit``'s int8 codes equal, its row scales at rtol 1e-6.
* ``core.gd_baseline``: ``train_gd`` for 20 epochs at dims [X, 16, 16, 16, C]
  on ``tiny()`` for each method, from the reference's ``init_mlp`` params
  handed over: the loss history at rtol 1e-4 against the live (jitted)
  reference, the test accuracy equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gd_baseline as JG
from repro.graph import datasets as jd
from repro.train import optim as JO
from repro_torch.core import gd_baseline as TG
from repro_torch.core.interop import mlp_params_from_numpy
from repro_torch.train import optim as TO

SHAPES = {"W": [(6, 5), (3, 4, 5)], "b": [(5,), ()]}
OPTIMIZERS = [("gd", (1e-1,)), ("adagrad", (1e-2,)), ("adadelta", (1.0,)),
              ("adam", (1e-3,)), ("adamw", (1e-3,)), ("adamw8bit", (1e-3,))]
GD_METHODS = [("gd", 1e-1), ("adadelta", 1.0), ("adagrad", 1e-2),
              ("adam", 1e-3)]


def _tree(rng):
    return {k: [rng.normal(size=s).astype(np.float32) for s in v]
            for k, v in SHAPES.items()}


def _torch(tree):
    return {k: [torch.from_numpy(x.copy()) for x in v] for k, v in tree.items()}


def _pairs(a, b, path=""):
    """(path, reference leaf, port leaf) over two trees of one structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), b.numpy()


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("name,args", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_updates_match_jax(name, args, n_steps):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(n_steps)]
    jo, to = getattr(JO, name)(*args), getattr(TO, name)(*args)
    pj = jax.tree.map(jnp.asarray, params)
    pt = _torch(params)
    sj, st = jo.init(pj), to.init(pt)
    for g in grads:
        pj, sj = jo.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = to.update(_torch(g), st, pt)
    n = 0
    for path, a, b in list(_pairs(pj, pt)) + list(_pairs(sj, st)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:
            scale = float(np.max(np.abs(a))) if a.size else 0.0
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=path)
        n += 1
    assert n >= 4


def test_adamw8bit_stores_int8_codes_and_row_scales():
    rng = np.random.default_rng(1)
    pt = _torch(_tree(rng))
    opt = TO.adamw8bit(1e-3)
    st = opt.init(pt)
    pt, st = opt.update(_torch(_tree(rng)), st, pt)
    m_q, v_q, t = st
    codes, scale = m_q["W"][1]
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (3, 4, 5)
    assert scale.dtype == torch.float32 and tuple(scale.shape) == (3, 4, 1)
    assert m_q["b"][0].dtype == torch.float32     # 1-d leaves stay f32
    assert int(t) == 1


@pytest.fixture(scope="module")
def tiny_problem():
    ds = jd.tiny()
    X = np.array(ds.augmented(2))
    dims = [X.shape[1], 16, 16, 16, ds.n_classes]
    masks = {k: np.array(m) for k, m in ds.masks.items()}
    return ds, X, np.array(ds.labels), masks, dims


@pytest.mark.parametrize("method,lr", GD_METHODS, ids=[m for m, _ in GD_METHODS])
def test_train_gd_tracks_jax(tiny_problem, method, lr):
    ds, X, labels, masks, dims = tiny_problem
    key = jax.random.PRNGKey(0)
    _, hj = JG.train_gd(key, jnp.asarray(X), jnp.asarray(labels),
                        {k: jnp.asarray(m) for k, m in masks.items()}, dims,
                        method, lr, 20)
    params = mlp_params_from_numpy(
        jax.tree.map(np.asarray, JG.init_mlp(key, dims)), device="cpu")
    _, ht = TG.train_gd(
        0, torch.from_numpy(X), torch.from_numpy(labels),
        {k: torch.from_numpy(m) for k, m in masks.items()}, dims, method, lr,
        20, device="cpu", params=params)
    assert len(ht["loss"]) == 20 and np.all(np.isfinite(ht["loss"]))
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-4)
    assert ht["test_acc"] == pytest.approx(hj["test_acc"], abs=1e-7)
    assert ht["val_acc"] == pytest.approx(hj["val_acc"], abs=1e-7)


def test_mlp_helpers_match_jax(tiny_problem):
    ds, X, labels, masks, dims = tiny_problem
    pj = JG.init_mlp(jax.random.PRNGKey(3), dims)
    pt = mlp_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    Xt, lt = torch.from_numpy(X), torch.from_numpy(labels)
    mt = torch.from_numpy(masks["train"])
    np.testing.assert_allclose(TG.mlp_logits(pt, Xt).numpy(),
                               np.asarray(JG.mlp_logits(pj, jnp.asarray(X))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(TG.masked_ce(pt, Xt, lt, mt)),
        float(JG.masked_ce(pj, jnp.asarray(X), jnp.asarray(labels),
                           jnp.asarray(masks["train"]))), rtol=1e-6)
    assert float(TG.accuracy(pt, Xt, lt, mt)) == pytest.approx(float(
        JG.accuracy(pj, jnp.asarray(X), jnp.asarray(labels),
                    jnp.asarray(masks["train"]))), abs=1e-7)


def test_init_mlp_is_he_normal_and_seeded():
    dims = [40, 30, 3]
    a = TG.init_mlp(0, dims, device="cpu")
    b = TG.init_mlp(0, dims, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a["W"], b["W"]))
    assert [tuple(w.shape) for w in a["W"]] == [(40, 30), (30, 3)]
    assert all(float(x.abs().sum()) == 0 for x in a["b"])
    assert float(a["W"][0].std()) == pytest.approx((2 / 40) ** 0.5, rel=0.2)
