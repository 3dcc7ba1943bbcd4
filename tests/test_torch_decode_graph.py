"""The LM decode step with its position on the device, and the engine's
compiled decode (``serve.engine.decode_program``).

The reference jits ``serve_step`` with ``length`` traced: its caches'
``length`` is a ``[] int32`` array. The port's ``serve_step`` takes an
int or a 0-d int tensor, and on a tensor reads the position on the device
only. On reduced configs of the six families and phi3-mini's int8
``KVCacheQ`` (f32, B 2, a cache of T 8 rows, the reference's weights
through ``lm_params_from_numpy``, tokens and whisper's cross K/V from a
numpy seed, steps at lengths 0, 1, 2, T − 1, T and T + 1, whisper's also
at −2):

* (a) the steps at a tensor length equal those at the int, bit for bit,
  in logits and state;
* (b) they equal the reference's ``serve_step`` at ``jnp.int32(length)``
  (jitted once a family, in one module fixture) at the family tests'
  tolerances: the transformer's logits and K/V (the int8 codes and
  scales too) rtol 1e-4, atol 1e-5 (``tests/test_torch_lm.py``); mamba2's,
  jamba's and whisper's logits and state relative L2 1e-5
  (``tests/test_torch_ssm.py``, ``_hybrid.py``, ``_audio.py``);
* (c) the tensor-length steps run under ``NoHostReads``, a torch function
  mode that raises on every read of a tensor's value by the host
  (``item``, ``__int__``, ``__index__``, ``__float__``, ``__bool__``,
  ``tolist``, ``numpy``, ``cpu``); the guard raises on a step that calls
  ``int(length)``;
* (d) the engine's program body (``graphs.on_cuda`` patched to true, so
  the CPU runs it eagerly) gives the tokens of the eager engine and of the
  reference's engine on ``tests/test_torch_serve.py``'s case, for reduced
  tinyllama and granite-moe, one body run a step;
* (e) an engine or a decode program on a ``DeviceMesh`` bundle raises on
  ``jit=True``.

The card cases (``-m cuda``): the captured decode against the eager step
bit for bit, tokens, logits and state, one replay a step, for each case
of (a) and through the engine. JAX is imported inside fixtures only, so
they run on a host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_decode_graph.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core import graphs
from repro_torch.models import api as tapi
from repro_torch.models.interop import lm_params_from_numpy
from repro_torch.serve import engine as teng

CASES = ("tinyllama-1.1b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
         "qwen2-vl-7b", "mamba2-130m", "jamba-v0.1-52b", "whisper-tiny")
B, T = 2, 8
LENGTHS = (0, 1, 2, T - 1, T, T + 1)
LENGTHS_BY_ARCH = {"whisper-tiny": (-2,) + LENGTHS}
TRANSFORMER = ("tinyllama-1.1b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
               "qwen2-vl-7b")
ENGINE_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m")


class NoHostReads(TorchFunctionMode):
    """Raises on any read of a tensor's value by the host."""

    READS = ("item", "__int__", "__index__", "__float__", "__bool__",
             "tolist", "numpy", "cpu")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise AssertionError(f"the decode step read a tensor on the "
                                 f"host ({name})")
        return func(*args, **(kwargs or {}))


def _lengths(arch):
    return LENGTHS_BY_ARCH.get(arch, LENGTHS)


def _inputs(arch):
    """Per step: the token [B, 1] int32 and, for the VLM, its 3-D positions
    [B, 1, 3] int32; whisper's cross K/V [L, B, F, H, hd] f32."""
    rng = np.random.default_rng(sum(map(ord, arch)))
    n = len(_lengths(arch))
    tokens = rng.integers(0, 256, (n, B, 1)).astype(np.int32)
    positions = rng.integers(0, 3 * T, (n, B, 1, 3)).astype(np.int32)
    cfg = get_arch(arch).reduced()
    cross = None
    if cfg.family == "audio":
        shp = (cfg.n_layers, B, cfg.encoder_seq, cfg.n_heads, cfg.hd)
        cross = [rng.normal(size=shp).astype(np.float32) for _ in range(2)]
    return tokens, (positions if cfg.mrope_sections else None), cross


def _flat(tree) -> list:
    """A state's arrays (not a cache's ``length``) as numpy, dict keys
    sorted, in both packages' trees."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [a for x in tree for a in _flat(x)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()] if tree.ndim else []
    if hasattr(tree, "shape") and len(tree.shape):
        return [np.asarray(tree)]
    return []


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def refs():
    """The reference's weights, and its jitted ``serve_step`` at
    ``jnp.int32(length)`` from its zero state over each case's steps: the
    logits of each step and the final state, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    mesh = make_host_mesh()
    out = {}
    for arch in CASES:
        jb = japi.build(j_get_arch(arch).reduced(), mesh, dtype=jnp.float32)
        jp = jb.init(jax.random.PRNGKey(0))
        state = jb.serve_state_shape(JShape("s", T, B, "decode"))
        tokens, positions, cross = _inputs(arch)
        if cross is not None:
            state = dict(state, cross_k=jnp.asarray(cross[0]),
                         cross_v=jnp.asarray(cross[1]))
        step = jax.jit(lambda p, s, b, n, jb=jb: jb.serve_step(p, s, b,
                                                               length=n))
        logits = []
        for i, n in enumerate(_lengths(arch)):
            batch = {"token": jnp.asarray(tokens[i])}
            if positions is not None:
                batch["positions"] = jnp.asarray(positions[i])
            lg, state = step(jp, state, batch, jnp.int32(n))
            logits.append(np.asarray(lg))
        out[arch] = types.SimpleNamespace(
            params=jax.tree.map(np.asarray, jp), logits=logits,
            state=_flat(state))
    return out


def _port(arch, params, device="cpu"):
    """(bundle, params, zero state with whisper's cross K/V) on ``device``."""
    tb = tapi.build(get_arch(arch).reduced(), device=device,
                    dtype=torch.float32)
    tp = lm_params_from_numpy(params, device=device)
    state = tb.serve_state_shape(ShapeConfig("s", T, B, "decode"))
    _, _, cross = _inputs(arch)
    if cross is not None:
        state["cross_k"].copy_(torch.from_numpy(cross[0]))
        state["cross_v"].copy_(torch.from_numpy(cross[1]))
    return tb, tp, state


def _steps(tb, tp, state, arch, as_tensor: bool, guard: bool = False):
    """The case's steps through ``serve_step`` from ``state`` (written in
    place), the length an int or a 0-d int32 tensor on the state's
    device. Returns (logits per step, the final state)."""
    tokens, positions, _ = _inputs(arch)
    dev = tb.device
    logits = []
    with torch.no_grad():
        for i, n in enumerate(_lengths(arch)):
            batch = {"token": torch.from_numpy(tokens[i]).to(dev)}
            if positions is not None:
                batch["positions"] = torch.from_numpy(positions[i]).to(dev)
            length = (torch.tensor(n, dtype=torch.int32, device=dev)
                      if as_tensor else n)
            if guard:
                with NoHostReads():
                    lg, state = tb.serve_step(tp, state, batch, length=length)
            else:
                lg, state = tb.serve_step(tp, state, batch, length=length)
            logits.append(lg)
    return logits, state


def _assert_same(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", CASES)
def test_tensor_length_decode_equals_int_and_the_reference(refs, arch):
    """(a), (b), (c) for one case."""
    ref = refs[arch]
    tb, tp, s_int = _port(arch, ref.params)
    _, _, s_dev = _port(arch, ref.params)
    l_int, s_int = _steps(tb, tp, s_int, arch, as_tensor=False)
    l_dev, s_dev = _steps(tb, tp, s_dev, arch, as_tensor=True, guard=True)
    for a, b in zip(l_dev, l_int, strict=True):
        assert torch.equal(a, b)
    _assert_same(_flat(s_dev), _flat(s_int))
    if arch in TRANSFORMER:
        assert isinstance(s_dev.length, torch.Tensor)
        assert int(s_dev.length) == _lengths(arch)[-1] + 1
        assert s_int.length == _lengths(arch)[-1] + 1
    got = _flat(s_dev)
    assert len(got) == len(ref.state)
    for i, (tl, jl) in enumerate(zip(l_dev, ref.logits, strict=True)):
        assert tl.shape == jl.shape
        if arch in TRANSFORMER:
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i}")
        else:
            assert _rel_l2(tl.numpy(), jl) <= 1e-5, f"step {i}"
    for a, b in zip(got, ref.state):
        assert a.shape == b.shape and a.dtype == b.dtype
        if arch in TRANSFORMER:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            assert _rel_l2(a, b) <= 1e-5


def test_the_guard_bites_on_a_host_read_of_the_length(refs):
    """(c): a step that reads the length on the host raises under the
    guard; the same step at an int passes it."""
    arch = "tinyllama-1.1b"
    tb, tp, state = _port(arch, refs[arch].params)
    batch = {"token": torch.zeros((B, 1), dtype=torch.int32)}
    length = torch.tensor(3, dtype=torch.int32)

    def host_step(length):
        return tb.serve_step(tp, state, batch, length=int(length))

    with torch.no_grad():
        with NoHostReads(), pytest.raises(AssertionError, match="__int__"):
            host_step(length)
        with NoHostReads():
            host_step(3)
        # the guard's reads, one by one
        for read in (lambda: length.item(), lambda: [0] * 8 * length,
                     lambda: range(8)[length], lambda: bool(length),
                     lambda: length.tolist(), lambda: float(length)):
            with NoHostReads(), pytest.raises(AssertionError):
                read()


def test_whisper_negative_length_wraps_on_the_device(refs):
    """whisper at a tensor length −2: the sinusoid's row T − 2 and the K/V
    row T − 2 (jax 0.9 counts a negative traced index, and a negative
    update start, from the end), the same bits as the int."""
    arch = "whisper-tiny"
    tb, tp, s_int = _port(arch, refs[arch].params)
    _, _, s_dev = _port(arch, refs[arch].params)
    batch = {"token": torch.full((B, 1), 7, dtype=torch.int32)}
    with torch.no_grad():
        li, s_int = tb.serve_step(tp, s_int, batch, length=-2)
        with NoHostReads():
            ld, s_dev = tb.serve_step(tp, s_dev, batch,
                                      length=torch.tensor(-2, dtype=torch.int32))
    assert torch.equal(li, ld)
    rows = s_dev["self_k"].abs().sum(dim=(0, 1, 3, 4))
    assert rows.nonzero().flatten().tolist() == [T - 2]
    _assert_same(_flat(s_dev), _flat(s_int))


# ---------------------------------------------------------------------------
# The engine's program
# ---------------------------------------------------------------------------

def _engine_case():
    return [[1 + i, 2 + i, 3 + i] for i in range(5)]


@pytest.fixture(scope="module")
def engine_refs():
    """The reference's engine on ``tests/test_torch_serve.py``'s case (3
    slots, ``max_len`` 64, 5 requests, 5 new tokens each) in f32, and its
    weights, per arch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as j_get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import api as japi
    from repro.serve import engine as jeng
    out = {}
    for arch in ENGINE_ARCHS:
        jb = japi.build(j_get_arch(arch).reduced(), make_host_mesh(),
                        JShape("serve", 64, 3, "decode"), dtype=jnp.float32)
        jp = jb.init(jax.random.PRNGKey(0))
        eng = jeng.ServingEngine(jb, jp, slots=3, max_len=64)
        reqs = [jeng.Request(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(_engine_case())]
        out[arch] = (jax.tree.map(np.asarray, jp), eng.run(reqs, 64))
    return out


def _serve(bundle, params, jit, calls):
    eng = teng.ServingEngine(bundle, params, slots=3, max_len=64, jit=jit)
    reqs = [teng.Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(_engine_case())]
    calls.clear()
    return eng.run(reqs, 64), eng, len(calls)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_program_body_gives_the_reference_tokens(engine_refs, arch,
                                                        monkeypatch):
    """(d): the engine's program body run eagerly (``graphs.on_cuda``
    patched) against the eager engine and the reference's engine, one body
    run (one ``serve_step``) a step."""
    params, want = engine_refs[arch]
    tb = tapi.build(get_arch(arch).reduced(), device="cpu",
                    dtype=torch.float32)
    tp = lm_params_from_numpy(params, device="cpu")
    calls = []
    real = tb.serve_step

    def counted(*a, **k):
        calls.append(k["length"])
        return real(*a, **k)
    monkeypatch.setattr(tb, "serve_step", counted)
    eager, e_eng, e_steps = _serve(tb, tp, False, calls)
    assert e_eng.program is None
    monkeypatch.setattr(graphs, "on_cuda", lambda state: True)
    got, g_eng, g_steps = _serve(tb, tp, None, calls)
    assert g_eng.program is not None and g_eng.program.program.graph is None
    assert got == eager == want
    assert g_steps == e_steps == g_eng.program.replays > 0
    assert all(isinstance(n, torch.Tensor) and n.ndim == 0 for n in calls)
    # the engine's state is the program's buffers, written in place
    assert graphs._same_view(g_eng.state.k, g_eng.program.state.k)
    _assert_same(_flat(g_eng.state), _flat(e_eng.state))


def test_decode_program_is_cached_and_takes_a_state_back(refs, monkeypatch):
    """One program for a bundle, params and shapes: the state it lent comes
    back without a copy; a state held elsewhere gets a program of its own,
    whose buffers are that state's tensors (adopted, not cloned)."""
    monkeypatch.setattr(graphs, "on_cuda", lambda state: True)
    arch = "tinyllama-1.1b"
    tb, tp, state = _port(arch, refs[arch].params)
    batch = {"token": torch.zeros((B, 1), dtype=torch.int32)}
    prog = teng.decode_program(tb, tp, state, batch)
    assert prog.program.buffers.bufs[0].data_ptr() == state.k.data_ptr()
    lent = prog.state
    assert teng.decode_program(tb, tp, lent, batch) is prog
    _, _, other = _port(arch, refs[arch].params)
    prog2 = teng.decode_program(tb, tp, other, batch)
    assert prog2 is not prog
    assert prog2.program.buffers.bufs[0].data_ptr() == other.k.data_ptr()
    toks = prog2.step(np.ones((B, 1), np.int32), 3)
    assert toks.shape == (B,) and toks.dtype == np.int64
    assert bool(other.k[:, :, 3].any()) and not bool(lent.k.any())
    assert torch.equal(prog2.logits[:, 0, :256].argmax(-1),
                       torch.from_numpy(toks))


def test_mesh_bundle_refuses_the_graph():
    """(e): a bundle on a ``DeviceMesh`` (a gloo world of one) keeps the
    eager step: ``jit=True`` and ``decode_program`` raise, naming the
    ROADMAP item."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    mesh = make_host_mesh("cpu")
    try:
        cfg = get_arch("tinyllama-1.1b").reduced()
        tb = tapi.build(cfg, mesh, device="cpu", dtype=torch.float32)
        assert tb.on_mesh
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teng.ServingEngine(tb, None, slots=2, max_len=8, jit=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teng.decode_program(tb, None, None, {})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _card_port(arch, cuda):
    """A bundle and seeded weights on the card, and the case's zero state
    (whisper's cross K/V from the seed)."""
    tb = tapi.build(get_arch(arch).reduced(), device=cuda,
                    dtype=torch.float32)
    params = tb.init(torch.Generator(device=cuda).manual_seed(0))
    state = tb.serve_state_shape(ShapeConfig("s", T, B, "decode"))
    _, _, cross = _inputs(arch)
    if cross is not None:
        state["cross_k"].copy_(torch.from_numpy(cross[0]))
        state["cross_v"].copy_(torch.from_numpy(cross[1]))
    return tb, params, state


def _tensors(state) -> list:
    """A state's arrays (not a cache's ``length``)."""
    return [x for x in pytree.tree_leaves(state)
            if isinstance(x, torch.Tensor) and x.ndim]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CASES)
def test_cuda_decode_graph_equals_eager_bitwise(cuda, arch):
    """Each case's steps as one replay each of the captured step against
    the eager tensor-length steps, from one copy of the state: logits,
    tokens and state bit for bit."""
    tb, params, s_eager = _card_port(arch, cuda)
    s_graph = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, s_eager)
    want, s_eager = _steps(tb, params, s_eager, arch, as_tensor=True)
    tokens, positions, _ = _inputs(arch)
    batch = {"token": torch.from_numpy(tokens[0])}
    if positions is not None:
        batch["positions"] = torch.from_numpy(positions[0])
    prog = teng.decode_program(tb, params, s_graph, batch)
    assert prog.program.graph is not None
    for i, n in enumerate(_lengths(arch)):
        toks = prog.step(tokens[i], n,
                         None if positions is None else positions[i])
        assert torch.equal(prog.logits, want[i]), f"step {i}"
        np.testing.assert_array_equal(
            toks, want[i][:, 0, :256].argmax(-1).cpu().numpy())
    assert prog.replays == len(_lengths(arch))
    for a, b in zip(_tensors(prog.state), _tensors(s_eager), strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_cuda_engine_graph_equals_eager(cuda, arch, monkeypatch):
    """The engine on the card: one capture when it is made, one replay a
    step (the eager engine's count of ``serve_step`` calls), the eager
    engine's tokens and state."""
    tb, params, _ = _card_port(arch, cuda)
    calls = []
    real = tb.serve_step

    def counted(*a, **k):
        calls.append(k["length"])
        return real(*a, **k)
    monkeypatch.setattr(tb, "serve_step", counted)
    want, e, n_eager = _serve(tb, params, False, calls)
    got, g, _ = _serve(tb, params, True, calls)
    assert e.program is None and g.program.program.graph is not None
    assert got == want
    assert g.program.replays == n_eager > 0
    for a, b in zip(_tensors(g.state), _tensors(e.state), strict=True):
        assert torch.equal(a, b)
