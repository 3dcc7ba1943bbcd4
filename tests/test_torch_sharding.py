"""The port's sharding rules and specs (``parallel.sharding``,
``ModelBundle.param_pspecs`` / ``input_pspecs`` / ``serve_state_pspecs``,
``train.optim.make_opt_pspecs``) against the JAX reference's, exactly.

No process group and no device: both sides take the mesh as shapes alone
(the reference a ``jax.sharding.AbstractMesh``, the port the same
``{axis: size}`` dict) and build param specs only, never parameters.

The grid: all ten ``ARCH_IDS`` × the four shapes × the single (16, 16),
multi-pod (2, 16, 16), test (2, 4) and host (1, 1) meshes. Per (arch,
shape, mesh): the rules table, the padded vocab, the input and decode-
state specs and their shard shapes. Per (arch, mesh), since no param rule
reads the shape: the param specs, the ``adamw`` and ``adamw8bit`` state
specs, and every leaf's shard shape against ``NamedSharding.shard_shape``
(both raise, or both give the same shape). A JAX ``PartitionSpec`` is
compared as its entries with trailing ``None`` dropped, the port's
``PSpec`` trim (``make_opt_pspecs`` builds the 8-bit scale specs with a
trailing ``None`` in both packages).
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as j_get_arch
from repro.models import api as japi
from repro.parallel import sharding as jsh
from repro.train import optim as joptim
from repro_torch.configs.base import SHAPES_BY_NAME, get_arch
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import common
from repro_torch.parallel import sharding as sh
from repro_torch.train import optim

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "test": ((2, 4), ("data", "model")),
          "host": ((1, 1), ("data", "model"))}
SHAPES = [s.name for s in J_SHAPES]


@functools.lru_cache(maxsize=None)
def _amesh(name):
    return AbstractMesh(*MESHES[name])


def _tmesh(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _norm(spec):
    """A spec's entries, trailing ``None`` dropped (either package's)."""
    parts = list(tuple(spec))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _flat(tree, prefix=()):
    """{path: leaf} of a tree of specs or shapes: dicts by key, tuples and
    named tuples by index."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, (sh.PSpec,
                                                         common.TensorSpec)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _shape(x):
    """A JAX leaf's shape as a leaf of ``_flat``."""
    return common.TensorSpec(tuple(x.shape), None)


def _j_shard_shape(amesh, spec, shape):
    try:
        return tuple(NamedSharding(amesh, spec).shard_shape(tuple(shape)))
    except ValueError:
        return "raises"


def _t_shard_shape(tmesh, spec, shape):
    try:
        return sh.shard_shape(tuple(shape), spec, tmesh)
    except ValueError:
        return "raises"


def _bundles(arch, mesh, shape=None):
    jshape = None if shape is None else [s for s in J_SHAPES
                                         if s.name == shape][0]
    tshape = None if shape is None else SHAPES_BY_NAME[shape]
    jb = japi.build(j_get_arch(arch), _amesh(mesh), jshape)
    tb = tapi.build(get_arch(arch), _tmesh(mesh), tshape, device="cpu")
    return jb, tb, jshape, tshape


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_inputs_and_state_specs(arch, shape, mesh):
    """make_rules, padded_vocab, input and decode-state specs, and their
    shard shapes."""
    jb, tb, jshape, tshape = _bundles(arch, mesh, shape)
    want = {k: (tuple(v) if v else v) for k, v in jb.rules.items()}
    assert tb.rules == want
    assert tb.vocab_padded == jsh.padded_vocab(jb.cfg, _amesh(mesh))
    assert sh.padded_vocab(tb.cfg, _tmesh(mesh)) == tb.vocab_padded

    j_in = {k: _norm(v) for k, v in jb.input_pspecs(jshape).items()}
    t_in = tb.input_pspecs(tshape)
    assert {k: tuple(v) for k, v in t_in.items()} == j_in
    for k, s in tb.input_specs(tshape).items():
        assert _t_shard_shape(_tmesh(mesh), t_in[k], s.shape) == \
            _j_shard_shape(_amesh(mesh), jb.input_pspecs(jshape)[k], s.shape)

    j_st = _flat(jb.serve_state_pspecs(jshape))
    t_st = _flat(tb.serve_state_pspecs(tshape))
    assert {k: tuple(v) for k, v in t_st.items()} == \
        {k: _norm(v) for k, v in j_st.items()}
    j_shapes = _flat(jax.tree.map(_shape, jb.serve_state_specs(jshape)))
    t_shapes = _flat(tb.serve_state_specs(tshape))
    for k, spec in t_st.items():
        if not isinstance(t_shapes[k], common.TensorSpec):
            continue                      # a cache's length
        shp = t_shapes[k].shape
        assert shp == j_shapes[k].shape, k
        assert _t_shard_shape(_tmesh(mesh), spec, shp) == \
            _j_shard_shape(_amesh(mesh), j_st[k], shp), k


@functools.lru_cache(maxsize=None)
def _j_opt_shapes(arch, mesh, bits):
    jb = japi.build(j_get_arch(arch), _amesh(mesh))
    opt = joptim.adamw8bit(3e-4) if bits == 8 else joptim.adamw(3e-4)
    params = jb.abstract_params()
    opt_sds = jax.eval_shape(opt.init, params)
    return jb, params, opt_sds


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_optimizer_specs(arch, mesh):
    """param_pspecs and every leaf's shard shape; make_opt_pspecs for
    adamw and adamw8bit (the reference's shape matching, 8-bit scales
    included) and the state leaves' shard shapes."""
    jb, tb, _, _ = _bundles(arch, mesh)
    j_ps = _flat(jb.param_pspecs())
    t_ps = _flat(tb.param_pspecs())
    assert {k: tuple(v) for k, v in t_ps.items()} == \
        {k: _norm(v) for k, v in j_ps.items()}
    for k, s in _flat(tb.param_specs()).items():
        assert _t_shard_shape(_tmesh(mesh), t_ps[k], s.shape) == \
            _j_shard_shape(_amesh(mesh), j_ps[k], s.shape), k

    for bits in (32, 8):
        _, j_params, j_opt = _j_opt_shapes(arch, mesh, bits)
        want = _flat(joptim.make_opt_pspecs(j_opt, jb.param_pspecs(),
                                            j_params))
        opt = optim.adamw8bit(3e-4) if bits == 8 else optim.adamw(3e-4)
        p_ps, o_ps = steps.shardings_for_train(tb, opt)
        got = _flat(o_ps)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}
        shapes = _flat(jax.tree.map(_shape, j_opt))
        for k, spec in got.items():
            shp = shapes[k].shape
            assert _t_shard_shape(_tmesh(mesh), spec, shp) == \
                _j_shard_shape(_amesh(mesh), want[k], shp), k


def test_placements_and_pspec_rules():
    """PSpec trims like the reference's pspec; a tensor dim over
    ("pod", "data") is Shard on both mesh dims, pod first (``to_named`` of
    a tree alike); the duplicate-axis guard replicates a later use of an
    axis; a tuple out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    assert tuple(sh.PSpec("a", None, None)) == ("a",)
    rules = {"x": ("model",), "y": ("model",), "b": ("pod", "data")}
    assert sh.pspec(("b", "x", "y"), rules) == (("pod", "data"), "model")
    assert tuple(jsh.pspec(("b", "x", "y"), rules)) == \
        (("pod", "data"), "model")

    class Mesh3:                     # the placements only read names
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert sh.placements(Mesh3(), sh.PSpec(("pod", "data"), "model"), 3) \
        == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(Mesh3(), sh.PSpec(None, None), 2) == \
        (Replicate(),) * 3
    assert steps.to_named(Mesh3(), {"w": sh.PSpec(None, "model"),
                                    "s": sh.PSpec()}) == \
        {"w": (Replicate(), Replicate(), Shard(1)),
         "s": (Replicate(),) * 3}
    with pytest.raises(ValueError):
        sh.placements(Mesh3(), sh.PSpec(("data", "pod")), 1)
    assert sh.constrain(torch.ones(2), None, ("x",), rules).tolist() == \
        [1.0, 1.0]
    assert sh.on_mesh_of(torch.ones(2), torch.zeros(2)).tolist() == \
        [1.0, 1.0]
