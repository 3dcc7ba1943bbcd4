"""The compiled ADMM driver (``core.graphs``; ``run_chunked(..., jit=True)``).

On the CPU ``run_chunked`` takes its eager loop whatever ``jit`` says;
the CPU cases call ``graphs.run`` itself, whose program body (static
buffers, copy-back, the metrics history row by row) runs eagerly there,
and hold that body:

* against the JAX reference's ``run_chunked`` (its ``lax.scan`` chunk,
  compiled in this process) at rtol 1e-3 on the objectives, for pdADMM-G
  and pdADMM-G-Q on the per-layer and the stacked paths, and bit for bit
  against ``jit=False``;
* from an ``init_state`` whose p[l+1] and q[l] are one tensor: buffers of
  distinct storage, the same trajectory;
* the cache: one program for a repeated step and signature, a new one for
  other dims; a state it returned is not overwritten by a later call on
  another state; steps over one state (``train_adaptive``'s schedules)
  share its buffers and switch without a copy;
* greedy growth's stages, one program each, against ``greedy_train``;
* the capture-delta bookkeeping: each replay adds the launches and ring
  bytes one captured iteration counted;
* pdADMM-G's ring step on a ``LocalRing`` (mesh (1, 2)), overlap off and
  on, against the reference's ``distributed_train`` on a (1, 1) mesh at
  ``tests/test_torch_stage_parallel.py``'s tolerances (objectives rtol
  1e-3, states atol 1e-4 + rtol 1e-3), and bit for bit against the
  port's ``distributed_train`` (its eager loop);
* ``distributed_train``'s per-iteration loops (the mixed-width ring over
  its widths table with 4 or 8 managed edges, the per-epoch controller,
  the sentinel loop with health, with detected faults and stale carries
  under overlap, with a fault plan that forces a rollback, and with a
  checkpoint and a resume) through one program body
  per step (``graphs.on_cuda`` patched to true, so the CPU runs the
  bodies eagerly), bit for bit against the eager loop: state, ``hist``
  (schedules, fault counts), ledger and ring bytes; one body run per
  iteration or tick, and no program made twice for a step.

The card cases (``-m cuda``): the graph equals the eager loop bit for bit
with the same launch counts and one replay per iteration (also for a
``train_adaptive`` whose schedules change width, all of them over one set
of buffers, and for each of ``distributed_train``'s per-iteration loops),
and a step that syncs the host makes the capture raise. JAX is imported inside the
fixtures only, so the card cases run on a host without it
(``pytest --noconftest -m cuda tests/test_torch_graphs.py``).
"""
import dataclasses
import functools
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core import greedy as tgr
from repro_torch.core import pdadmm as tpd
from repro_torch.core import quantize as tq
from repro_torch.core.interop import state_from_numpy
from repro_torch.graph import datasets as td
from repro_torch.kernels import ops
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import LocalRing, StageMesh

N_ITERS, CHUNK = 4, 3          # two chunks: 3 and the remainder 1
TAILS = {"per_layer": (32,), "stacked": (32, 32, 32)}
RING_L, RING_H, RING_EPOCHS = 4, 32, 4


def _cfg(m, gq):
    if not gq:
        return m.ADMMConfig(nu=1e-2, rho=1.0)
    grid = (tq if m is tpd else _jax()["jq"]).uniform_grid(8, -2.0, 6.0)
    return m.ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                        grid=grid)


def _jax():
    import jax
    from repro.core import pdadmm as jpd
    from repro.core import quantize as jq
    from repro.graph import datasets as jd
    return {"jax": jax, "jpd": jpd, "jq": jq, "jd": jd}


def _leaves(state):
    return [[np.asarray(x) for x in fam] for fam in state]


def _assert_same(a, b):
    la, lb = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _problem():
    ds = td.synthetic("citeseer", seed=0, scale=0.03, device="cpu")
    return ds, ds.augmented(2)


@pytest.mark.parametrize("gq", [False, True], ids=["G", "GQ"])
@pytest.mark.parametrize("path", list(TAILS))
def test_graph_body_tracks_jax_run_chunked_and_equals_eager(path, gq):
    J = _jax()
    jpd = J["jpd"]
    ds, X = _problem()
    args = (X, ds.labels, ds.masks["train"])
    dims = [X.shape[1], *TAILS[path], ds.n_classes]
    key = J["jax"].random.PRNGKey(0)
    cfg_j = _cfg(jpd, gq)
    args_j = tuple(J["jax"].numpy.asarray(t.numpy()) for t in args)
    s0j = jpd.init_state(key, args_j[0], dims, cfg_j)
    _, want = jpd.run_chunked(functools.partial(jpd.iterate, config=cfg_j),
                              s0j, args_j, N_ITERS, chunk=N_ITERS)
    step = functools.partial(tpd.iterate, config=_cfg(tpd, gq))

    def s0():
        return state_from_numpy(_leaves(s0j), device="cpu")
    # on the CPU run_chunked's jit=True is the eager loop: no program
    s_c, m_c = tpd.run_chunked(step, s0(), args, N_ITERS, chunk=CHUNK)
    assert graphs.programs(step) == []
    runs = [graphs.run(step, s0(), args, N_ITERS, CHUNK),
            tpd.run_chunked(step, s0(), args, N_ITERS, chunk=CHUNK,
                            jit=False)]
    (s_g, m_g), (s_e, m_e) = runs
    np.testing.assert_array_equal(m_c["objective"], m_e["objective"])
    _assert_same(s_c, s_e)
    assert m_g.keys() == m_e.keys()
    for k in m_g:
        np.testing.assert_array_equal(m_g[k], m_e[k], err_msg=k)
    _assert_same(s_g, s_e)
    np.testing.assert_allclose(m_g["objective"], want["objective"],
                               rtol=1e-3)
    (prog,) = graphs.programs(step)
    assert prog.graph is None and prog.replays == N_ITERS
    assert tpd._stackable(s_g, *tpd._default_grids(
        step.keywords["config"], len(dims) - 1, None, None)) == \
        (path == "stacked")


@pytest.mark.parametrize("gq", [False, True], ids=["G", "GQ"])
def test_aliased_init_gets_distinct_buffers_and_the_same_trajectory(gq):
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    cfg = _cfg(tpd, gq)
    dims = [X.shape[1], 16, 16, 16, ds.n_classes]
    s0 = tpd.init_state(0, X, dims, cfg, device="cpu")
    assert s0.p[1] is s0.q[0] and s0.p[0] is X
    step = functools.partial(tpd.iterate, config=cfg)
    args = (X, ds.labels, ds.masks["train"])
    s_g, m_g = graphs.run(step, s0, args, 3, 3)
    s_e, m_e = tpd.run_chunked(step, s0, args, 3, jit=False)
    (prog,) = graphs.programs(step)
    ptrs = [b.untyped_storage().data_ptr() for b in prog.buffers.bufs]
    assert len(set(ptrs)) == len(ptrs)
    assert X.untyped_storage().data_ptr() not in ptrs
    np.testing.assert_array_equal(m_g["objective"], m_e["objective"])
    _assert_same(s_g, s_e)
    assert torch.equal(s0.p[1], s0.q[0])      # the caller's state unchanged


def test_cache_hits_misses_and_keeps_a_held_state():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    cfg = _cfg(tpd, False)
    dims = [X.shape[1], 16, 16, ds.n_classes]
    args = (X, ds.labels, ds.masks["train"])
    step = functools.partial(tpd.iterate, config=cfg)
    s0 = tpd.init_state(0, X, dims, cfg, device="cpu")
    s1, _ = graphs.run(step, s0, args, 2, 2)
    (prog,) = graphs.programs(step)
    # the returned state passed back in: no copy, the same program
    assert prog.buffers.load(s1) == 0
    s2, _ = graphs.run(step, s1, args, 3, 3)
    assert graphs.programs(step) == [prog] and prog.replays == 5
    want, _ = tpd.run_chunked(step, s0, args, 5, jit=False)
    _assert_same(s2, want)
    # another state while s2 is held: new buffers and a new program; s2
    # is not touched
    keep = [t.clone() for t in torch.utils._pytree.tree_leaves(s2)]
    s3, _ = graphs.run(step, s0, args, 1, 1)
    (prog2,) = graphs.programs(step)
    assert prog2 is not prog and prog2.buffers is not prog.buffers
    for t, k in zip(torch.utils._pytree.tree_leaves(s2), keep):
        assert torch.equal(t, k)
    # a dropped state frees its program's buffers for reuse: a hit
    del s3
    gc.collect()
    graphs.run(step, s0, args, 1, 1)
    assert graphs.programs(step) == [prog2]
    # a greedy growth changes the dims: a second program
    g = torch.Generator().manual_seed(1)
    dims4 = [X.shape[1], 16, 16, 16, ds.n_classes]
    grown = tgr.grow(s2, X, dims4, cfg, [torch.randn((16, 16), generator=g)])
    graphs.run(step, grown, args, 1, 1)
    assert len(graphs.programs(step)) == 2
    graphs.release(step)
    assert graphs.programs(step) == []


def test_steps_over_one_state_share_its_buffers():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    cfg = _cfg(tpd, False)
    dims = [X.shape[1], 16, 16, ds.n_classes]
    args = (X, ds.labels, ds.masks["train"])
    # two schedules' steps, as train_adaptive caches them
    step_a = functools.partial(tpd.iterate, config=cfg)
    step_b = functools.partial(tpd.iterate,
                               config=dataclasses.replace(cfg, nu=2e-2))
    s0 = tpd.init_state(0, X, dims, cfg, device="cpu")
    sa, _ = graphs.run(step_a, s0, args, 2, 2)
    (pa,) = graphs.programs(step_a)
    sb, mb = graphs.run(step_b, sa, args, 2, 2)
    (pb,) = graphs.programs(step_b)
    assert pb.buffers is pa.buffers and pa.buffers.load(sb) == 0
    sc, mc = graphs.run(step_a, sb, args, 1, 1)
    assert graphs.programs(step_a) == [pa] and pa.replays == 3
    e, _ = tpd.run_chunked(step_a, s0, args, 2, jit=False)
    e, me_b = tpd.run_chunked(step_b, e, args, 2, jit=False)
    e, me_c = tpd.run_chunked(step_a, e, args, 1, jit=False)
    np.testing.assert_array_equal(mb["objective"], me_b["objective"])
    np.testing.assert_array_equal(mc["objective"], me_c["objective"])
    _assert_same(sc, e)


def test_greedy_train_graph_body_equals_eager():
    ds, X = _problem()
    cfg = _cfg(tpd, False)
    h, schedule, epochs = 16, (2, 4), 2
    g = torch.Generator().manual_seed(1)
    noise = [[torch.randn((h, h), generator=g) for _ in range(2)]]
    want = tgr.greedy_train(0, X, ds.labels, ds.masks, h, ds.n_classes,
                            schedule, epochs, cfg, device="cpu",
                            noise=noise, jit=False)
    # on the CPU jit=True is the same eager loop
    same = tgr.greedy_train(0, X, ds.labels, ds.masks, h, ds.n_classes,
                            schedule, epochs, cfg, device="cpu",
                            noise=noise)
    _assert_same(same[0], want[0])
    # the stages through the program body, one program a stage
    step = functools.partial(tpd.iterate, config=cfg)
    args = (X, ds.labels, ds.masks["train"])
    objs, state = [], None
    for si, L in enumerate(schedule):
        dims = [X.shape[1]] + [h] * (L - 1) + [ds.n_classes]
        state = (tpd.init_state(0, X, dims, cfg, device="cpu") if si == 0
                 else tgr.grow(state, X, dims, cfg, noise[si - 1]))
        state, ms = graphs.run(step, state, args, epochs, epochs)
        objs += ms["objective"].tolist()
    assert len(graphs.programs(step)) == 2
    np.testing.assert_array_equal(objs, want[1]["objective"])
    _assert_same(state, want[0])


class _Replayed:
    """A captured graph's stand-in: replays launch nothing here."""

    def replay(self):
        pass


def test_each_replay_adds_the_captured_counts():
    ds = td.tiny(device="cpu")
    X = ds.augmented(2)
    cfg = _cfg(tpd, False)
    dims = [X.shape[1], 16, 16, ds.n_classes]
    ring = LocalRing(StageMesh(1, 2), "cpu")
    saved = ops.launch_counts()
    try:
        ops.reset_launch_counts()
        before = graphs.counter_snapshot()
        # what one captured iteration's wrappers and shifts would count
        ops.add_launch_counts({"fused_linear": 3, "grid_encode": 2})
        ring.shifted_bytes += 100
        delta = graphs.counter_delta(before, graphs.counter_snapshot())
        assert delta[0] == {"fused_linear": 3, "grid_encode": 2}
        assert [(r(), n) for r, n in delta[1]] == [(ring, 100)]
        graphs.add_counts(delta, -1)            # a capture launches nothing
        assert ring.shifted_bytes == 0
        assert not any(ops.launch_counts().values())
        step = functools.partial(tpd.iterate, config=cfg)
        args = (X, ds.labels, ds.masks["train"])
        s0 = tpd.init_state(0, X, dims, cfg, device="cpu")
        s1, m1 = graphs.run(step, s0, args, 1, 2)
        (prog,) = graphs.programs(step)
        prog.graph, prog.delta = _Replayed(), delta
        _, m = graphs.run(step, s1, args, 5, 2)
        assert prog.replays == 6 and m["objective"].shape == (5,)
        counts = ops.launch_counts()
        assert counts["fused_linear"] == 15 and counts["grid_encode"] == 10
        assert sum(counts.values()) == 25
        assert ring.shifted_bytes == 500
    finally:
        ops.reset_launch_counts()
        ops.add_launch_counts(saved)


@pytest.fixture(scope="module")
def ring_ref():
    """The reference's pdADMM-G ``distributed_train`` on a (1, 1) mesh of
    this process's one CPU device: its projected features, initial stack,
    final stack and objectives."""
    J = _jax()
    import jax.numpy as jnp
    from repro.launch.mesh import compat_make_mesh
    from repro.parallel import stage_parallel as JSP
    ds = J["jd"].tiny(V=128)
    X = np.asarray(ds.augmented(4))
    P0 = (np.random.default_rng(0).standard_normal((X.shape[1], RING_H))
          .astype(np.float32) * np.float32(np.sqrt(2.0 / X.shape[1])))
    Xp = jnp.maximum(jnp.asarray(X) @ P0, 0)
    mesh = compat_make_mesh((1, 1), ("data", "model"),
                            devices=J["jax"].devices()[:1])
    key = J["jax"].random.PRNGKey(0)
    out = {"Xp": np.array(Xp), "labels": np.array(ds.labels),
           "train": np.array(ds.masks["train"]), "n_classes": ds.n_classes}
    cfg = _cfg(J["jpd"], False)
    st0 = JSP.init_stack(key, Xp, RING_L, cfg)
    st, hist = JSP.distributed_train(mesh, key, Xp, ds.labels, ds.masks,
                                     RING_L, ds.n_classes, cfg,
                                     epochs=RING_EPOCHS)
    out.update(init=[np.array(x) for x in st0],
               state=[np.array(x) for x in st],
               objective=np.asarray(hist["objective"]))
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_distributed_train_graph_body_tracks_reference(ring_ref, overlap):
    Xp, labels = (torch.from_numpy(ring_ref[k]) for k in ("Xp", "labels"))
    masks = {"train": torch.from_numpy(ring_ref["train"])}
    init = SP.StackState(*(torch.from_numpy(x) for x in ring_ref["init"]))
    mesh, cfg, C = StageMesh(1, 2), _cfg(tpd, False), ring_ref["n_classes"]
    st_e, hist_e = SP.distributed_train(mesh, None, Xp, labels, masks,
                                        RING_L, C, cfg, RING_EPOCHS,
                                        init=init, overlap=overlap)
    # distributed_train's no-controller step through the program body
    ring = LocalRing(mesh, "cpu")
    step, _ = SP.make_distributed_step(mesh, RING_L, C, cfg,
                                       overlap=overlap, ring=ring)
    data = tuple(ring.to_local(x, "rows") for x in (Xp, labels,
                                                     masks["train"]))
    carry = SP.shard_stack(init, ring)
    if overlap:
        carry = (carry, SP.make_overlap_primer(mesh, ring=ring)(carry.q,
                                                                 carry.u))
    carry, ms = graphs.run(step, carry, data, RING_EPOCHS, RING_EPOCHS)
    st = SP.gather_stack(carry[0] if overlap else carry, ring)
    hist = {"objective": ms["objective"].tolist()}
    np.testing.assert_array_equal(hist["objective"], hist_e["objective"])
    _assert_same(st, st_e)
    np.testing.assert_allclose(hist["objective"], ring_ref["objective"],
                               rtol=1e-3)
    for f, want in zip(SP.StackState._fields, ring_ref["state"]):
        np.testing.assert_allclose(getattr(st, f).numpy(), want, rtol=1e-3,
                                   atol=1e-4, err_msg=f)


UNIFORM_CTL = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16,
                   min_dwell=1, hysteresis=0.0, thresholds=((0.5, 4), (0.1, 8)))
MIXED_CTL = dict(UNIFORM_CTL, signal="per_edge")
# (kwargs of distributed_train, iterations): a fault plan's seed whose
# sneaky flips force a rollback on this problem (1 in 7 ticks at seed 8)
LOOPS = {
    "mixed": (dict(mixed_width=True), 4),
    "mixed_overlap_8_edges": (dict(mixed_width=True, overlap=True,
                                   edges=2), 4),
    "controller_overlap": (dict(overlap=True, uniform_controller=True), 4),
    "health_overlap": (dict(health=True, overlap=True), 3),
    "chaos_overlap": (dict(chaos=3, overlap=True), 4),
    "rollback": (dict(sneaky=8), 6),
    "ckpt_resume": (dict(health=True, ckpt=True), 3),
}


def _loop_run(kind, device, tmp, Xp, labels, masks, C, dims=(4, 16),
              jit=True):
    """One ``distributed_train`` of the ``LOOPS`` case on a LocalRing of
    mesh (1, 4): (global state, hist, ledger records, ring bytes)."""
    from repro_torch.comm import faults as FT
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig,
                                             stage_ring_edges)
    from repro_torch.comm.ledger import CommLedger
    kw, epochs = LOOPS[kind]
    kw = dict(kw)
    L, h = dims
    mesh = StageMesh(1, 4)
    grids = {b: tq.uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    if kw.get("mixed_width"):
        edges = stage_ring_edges(4, Xp.shape[0], h) * kw.pop("edges", 1)
        kw.update(grids_by_bits=grids, controller=BitWidthController(
            edges, ControllerConfig(**MIXED_CTL)))
    if kw.pop("uniform_controller", False):
        kw.update(grids_by_bits=grids, controller=BitWidthController(
            [2 * Xp.shape[0] * h], ControllerConfig(**UNIFORM_CTL)))
    if "chaos" in kw:       # detected flips and drops, stale carries
        kw["faults"] = FT.FaultPlan(seed=kw.pop("chaos"), flip_rate=0.2,
                                    drop_rate=0.1, delay_rate=0.1)
    if "sneaky" in kw:
        kw["faults"] = FT.FaultPlan(seed=kw.pop("sneaky"), sneaky_rate=0.1,
                                    flips_per_event=6)
    resume = kw.pop("ckpt", False)
    ring = LocalRing(mesh, device)
    led = CommLedger()
    run = functools.partial(SP.distributed_train, mesh, 3, Xp, labels, masks,
                            L, C, _cfg(tpd, False), ledger=led, ring=ring,
                            jit=jit, **kw)
    if resume:
        run(epochs, ckpt=str(tmp), ckpt_every=2)
        st, hist = run(epochs + 2, ckpt=str(tmp), resume=True)
    else:
        st, hist = run(epochs)
    return st, hist, [dataclasses.astuple(r) for r in led.records], \
        ring.shifted_bytes


def _same_loop(got, want):
    (sg, hg, lg, bg), (se, he, le, be) = got, want
    assert hg == he and lg == le and bg == be
    _assert_same(sg, se)


@pytest.mark.parametrize("kind", list(LOOPS))
def test_distributed_train_loop_bodies_equal_eager(kind, monkeypatch,
                                                   tmp_path):
    """The per-iteration loops through their program bodies (the replayed
    form's buffers, argument tensors rewritten in place, byte history read
    each iteration) equal the eager loop bit for bit."""
    Xp, ds = _tiny_ring()
    args = (Xp, ds.labels, ds.masks, ds.n_classes)
    want = _loop_run(kind, "cpu", tmp_path / "eager", *args)
    made, steps = [], [0]
    init, step = graphs.ChunkProgram.__init__, graphs.ChunkProgram.step

    def counted_init(self, step_fn, *a, **kw):
        made.append(step_fn)
        init(self, step_fn, *a, **kw)

    def counted_step(self, step_fn):
        steps[0] += 1
        step(self, step_fn)
    monkeypatch.setattr(graphs.ChunkProgram, "__init__", counted_init)
    monkeypatch.setattr(graphs.ChunkProgram, "step", counted_step)
    monkeypatch.setattr(graphs, "on_cuda", lambda state: True)
    got = _loop_run(kind, "cpu", tmp_path / "replayed", *args)
    _same_loop(got, want)
    hist = got[1]
    ticks = (hist["faults"]["ticks"] if "faults" in hist
             else len(hist["objective"]))
    if kind == "ckpt_resume":   # 3 ticks, a save at 2, a resume to 5
        ticks = 2 * LOOPS[kind][1]
    assert steps[0] == ticks and 0 < len(made) == len(set(made))
    if kind.startswith("mixed"):
        assert len(made) == hist["n_compiled_steps"] == 1
        assert len(set(hist["schedules"])) > 1
    if kind == "rollback":
        assert hist["faults"]["rolled_back"] >= 1
    if kind == "chaos_overlap":
        assert hist["faults"]["detected"] > 0


def _tiny_ring(device="cpu"):
    ds = td.tiny(V=64, device=device)
    X = ds.augmented(2)
    g = torch.Generator().manual_seed(0)
    P0 = torch.randn((X.shape[1], 16), generator=g) / np.sqrt(X.shape[1])
    return torch.relu(X @ P0.to(device)), ds


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gq", [False, True], ids=["G", "GQ"])
@pytest.mark.parametrize("path", list(TAILS))
def test_cuda_graph_equals_eager_bitwise(cuda, path, gq):
    ds = td.tiny(device=cuda)
    X = ds.augmented(2)
    cfg = _cfg(tpd, gq)
    dims = [X.shape[1], *[64] * len(TAILS[path]), ds.n_classes]
    s0 = tpd.init_state(0, X, dims, cfg, device=cuda)
    step = functools.partial(tpd.iterate, config=cfg)
    args = (X, ds.labels, ds.masks["train"])
    runs = []
    for jit in (True, False):
        ops.reset_launch_counts()
        runs.append(tpd.run_chunked(step, s0, args, 5, chunk=2, jit=jit)
                    + (ops.launch_counts(),))
    (s_g, m_g, c_g), (s_e, m_e, c_e) = runs
    assert c_g == c_e and c_g["fused_linear"] > 0
    for k in m_g:
        np.testing.assert_array_equal(m_g[k], m_e[k], err_msg=k)
    _assert_same(s_g, s_e)
    (prog,) = graphs.programs(step)
    assert prog.graph is not None and prog.replays == 5


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_ring_graph_equals_eager_bitwise(cuda, overlap):
    ds = td.tiny(V=128, device=cuda)
    X = ds.augmented(2)
    g = torch.Generator().manual_seed(0)
    Xp = torch.relu(X @ torch.randn((X.shape[1], RING_H), generator=g)
                    .to(cuda))
    cfg = _cfg(tpd, True)
    runs = []
    for jit in (True, False):
        ops.reset_launch_counts()
        s, h = SP.distributed_train(StageMesh(1, 2), 0, Xp, ds.labels,
                                    ds.masks, RING_L, ds.n_classes, cfg,
                                    RING_EPOCHS, overlap=overlap, jit=jit)
        runs.append((s, h, ops.launch_counts()))
    assert runs[0][2] == runs[1][2] and runs[0][2]["grid_encode"] > 0
    np.testing.assert_array_equal(runs[0][1]["objective"],
                                  runs[1][1]["objective"])
    _assert_same(runs[0][0], runs[1][0])


@pytest.mark.cuda
def test_cuda_train_adaptive_widths_share_one_state(cuda, monkeypatch):
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig, admm_edges,
                                             train_adaptive)
    from repro_torch.comm.ledger import CommLedger
    ds = td.tiny(device=cuda)
    X = ds.augmented(2)
    dims = [X.shape[1], 64, 64, 64, ds.n_classes]
    grids = {b: tq.uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    made = {"buffers": 0, "programs": 0}

    def counted(cls, key):
        init = cls.__init__

        def __init__(self, *a, **kw):
            made[key] += 1
            init(self, *a, **kw)
        monkeypatch.setattr(cls, "__init__", __init__)
    counted(graphs.StateBuffers, "buffers")
    counted(graphs.ChunkProgram, "programs")
    runs = []
    for jit in (True, False):
        ctl = BitWidthController(
            admm_edges(dims, X.shape[0])[:len(dims) - 2],
            ControllerConfig(allowed_bits=(4, 8, 16), min_bits=4,
                             max_bits=16, min_dwell=1, hysteresis=0.0,
                             signal="per_edge",
                             thresholds=((0.5, 4), (0.1, 8))))
        ops.reset_launch_counts()
        graphs.replays = 0
        s, h = train_adaptive(0, X, ds.labels, ds.masks, dims,
                              _cfg(tpd, False), 6, controller=ctl,
                              ledger=CommLedger(), grids_by_bits=grids,
                              control_interval=1, device=cuda, jit=jit)
        runs.append((s, h, ops.launch_counts(), graphs.replays))
    (s_g, h_g, c_g, r_g), (s_e, h_e, c_e, r_e) = runs
    schedules = set(h_g["schedules"])
    assert len(schedules) > 1 and h_g["schedules"] == h_e["schedules"]
    # one state's buffers under every schedule's graph
    assert made == {"buffers": 1, "programs": len(schedules)}
    assert (r_g, r_e) == (6, 0) and c_g == c_e
    np.testing.assert_array_equal(h_g["objective"], h_e["objective"])
    _assert_same(s_g, s_e)


@pytest.mark.cuda
def test_cuda_capture_of_a_host_sync_raises(cuda):
    x = torch.ones((4,), device=cuda)

    def syncing_step(s, a):
        return s + float(a.sum()), {"v": s.sum()}

    with pytest.raises(RuntimeError, match="CUDA graph warm-up of .*"
                                           "syncing_step failed at"):
        tpd.run_chunked(syncing_step, x, (x,), 3)

    def h2d_step(s, a):
        return s + torch.ones((4,)).to(a.device), {"v": s.sum()}

    with pytest.raises(RuntimeError, match="h2d_step failed at"):
        tpd.run_chunked(h2d_step, x, (x,), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(LOOPS))
def test_cuda_distributed_train_loops_replay_equal_eager(cuda, kind,
                                                         tmp_path):
    """Each per-iteration loop of ``distributed_train`` replays one graph
    per iteration (tick) on the card, bit for bit the eager loop's, with
    the same launch counts."""
    Xp, ds = _tiny_ring(cuda)
    args = (Xp, ds.labels, ds.masks, ds.n_classes)
    runs = []
    for jit in (True, False):
        ops.reset_launch_counts()
        graphs.replays = 0
        out = _loop_run(kind, cuda, tmp_path / str(jit), *args, jit=jit)
        runs.append((out, ops.launch_counts(), graphs.replays))
    (got, c_g, r_g), (want, c_e, r_e) = runs
    _same_loop(got, want)
    hist = got[1]
    ticks = (hist["faults"]["ticks"] if "faults" in hist
             else len(hist["objective"]))
    if kind == "ckpt_resume":   # 3 ticks, a save at 2, a resume to 5
        ticks = 2 * LOOPS[kind][1]
    assert c_g == c_e and c_g["fused_linear"] > 0
    assert (r_g, r_e) == (ticks, 0)
