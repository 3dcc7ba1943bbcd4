"""The port's bit-width controller against the reference's: host logic, so
every schedule, switch count, spend and state dict is equal exactly, for
one recorded residual trace under per-edge and global signals, with and
without a byte budget, across a ``force_widest`` window and a
``state_dict`` / ``load_state_dict`` restart."""
import numpy as np
import pytest

from repro.comm import controller as jcl
from repro_torch.comm import controller as tcl

N_EDGES, ITERS = 6, 60


def residual_trace(seed=0):
    """Per-edge residuals: a noisy decay, one edge that never activates
    and one that spikes late."""
    rng = np.random.default_rng(seed)
    t = np.arange(ITERS)[:, None]
    base = np.exp(-t / rng.uniform(5, 25, N_EDGES)) * rng.uniform(0.5, 3,
                                                                  N_EDGES)
    trace = base * (1 + 0.2 * rng.standard_normal((ITERS, N_EDGES)))
    trace[:, 1] = 0.0
    trace[40:45, 4] += 2.0
    return np.abs(trace).tolist()


CONFIGS = {
    "global": dict(),
    "per_edge": dict(signal="per_edge", min_dwell=1, hysteresis=0.0,
                     thresholds=((0.5, 4), (0.1, 8))),
    "budget": dict(signal="per_edge", min_dwell=2,
                   byte_budget=0.6 * ITERS * N_EDGES * 500 * 2,
                   total_iters=ITERS),
    "global_budget": dict(byte_budget=0.8 * ITERS * N_EDGES * 500 * 2,
                          total_iters=ITERS, min_bits=8),
}


def _pair(cfg, edges):
    return (jcl.BitWidthController(edges, jcl.ControllerConfig(**cfg)),
            tcl.BitWidthController(edges, tcl.ControllerConfig(**cfg)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedules_equal_reference(name):
    cfg = CONFIGS[name]
    cj, ct = _pair(cfg, [500] * N_EDGES)
    for it, res in enumerate(residual_trace()):
        if it == 30:
            cj.force_widest(it, 3)
            ct.force_widest(it, 3)
        assert ct.assign(res, it) == cj.assign(res, it), (name, it)
        assert ct.schedule == cj.schedule
    assert ct.n_switches == cj.n_switches > 0
    assert ct.spent_bytes == cj.spent_bytes
    assert ct.state_dict() == cj.state_dict()


def test_state_dict_restart_resumes_the_policy():
    trace = residual_trace(1)
    cfg = CONFIGS["per_edge"]
    cj, ct = _pair(cfg, [500] * N_EDGES)
    for it in range(20):
        cj.assign(trace[it], it)
        ct.assign(trace[it], it)
    _, resumed = _pair(cfg, [500] * N_EDGES)
    resumed.load_state_dict(ct.state_dict())
    for it in range(20, ITERS):
        want = cj.assign(trace[it], it)
        assert resumed.assign(trace[it], it) == want
        assert ct.assign(trace[it], it) == want


def test_edge_layouts_and_clamp_equal_reference():
    for n, V, h in ((4, 128, 32), (10, 2485, 1000)):
        for split in (False, True):
            assert tcl.stage_ring_edges(n, V, h, split) == \
                jcl.stage_ring_edges(n, V, h, split)
    dims = [5732, 1000, 500, 1000, 7]
    assert tcl.admm_edges(dims, 2485) == jcl.admm_edges(dims, 2485)
    for kw in (dict(), dict(min_bits=8), dict(allowed_bits=(2, 4, 8, 16),
                                              max_bits=8)):
        cj, ct = jcl.ControllerConfig(**kw), tcl.ControllerConfig(**kw)
        assert [ct.clamp(b) for b in range(1, 20)] == \
            [cj.clamp(b) for b in range(1, 20)]


def test_invalid_configs_raise_and_walltime_waits():
    with pytest.raises(ValueError, match="total_iters"):
        tcl.BitWidthController([1], tcl.ControllerConfig(byte_budget=10.0))
    with pytest.raises(ValueError, match="allowed_bits"):
        tcl.BitWidthController([1], tcl.ControllerConfig(min_bits=32,
                                                         max_bits=32))
    with pytest.raises(ValueError, match="objective"):
        tcl.BitWidthController([1], tcl.ControllerConfig(objective="speed"))
    # the walltime objective prices schedules with a replay cost model
    with pytest.raises(ValueError, match="cost_model"):
        tcl.BitWidthController([1], tcl.ControllerConfig(objective="walltime"))
    wt = tcl.BitWidthController([1], tcl.ControllerConfig(objective="walltime"),
                                cost_model=lambda schedule: 1.0)
    assert wt.assign([1.0], 0) == (16,)


# ---------------------------------------------------------------------------
# train_adaptive: the single-host adaptive loop, against the reference from
# the same initial state and grids (f32 on both sides).
# ---------------------------------------------------------------------------

def _adaptive_problem():
    import jax
    import torch
    from repro.core import pdadmm as jpd
    from repro.graph.datasets import tiny
    from repro_torch.core import quantize as tq
    ds = tiny()
    X = ds.augmented(4)
    dims = [X.shape[1], 32, 32, ds.n_classes]
    key = jax.random.PRNGKey(0)
    jgrids = {b: jpd.calibrate_grid(key, X, dims, b) for b in (4, 8, 16)}
    tgrids = {b: tq.QuantGrid(g.lo, g.step, g.n_levels)
              for b, g in jgrids.items()}
    t = lambda a: torch.from_numpy(np.array(a))
    tdata = (t(X), t(ds.labels), {k: t(v) for k, v in ds.masks.items()})
    return key, (X, ds.labels, ds.masks), tdata, dims, jgrids, tgrids


def _reference_init(key, X, dims, ctl, jgrids):
    """The reference's own train_adaptive init, handed over through numpy."""
    from repro.core import pdadmm as jpd
    from repro_torch.core.interop import state_from_numpy
    init_bits = max(ctl.schedule[0], min(8, max(jgrids)))
    grid = jgrids.get(init_bits, jgrids[max(jgrids)])
    s0 = jpd.init_state(key, X, dims, jpd.ADMMConfig(
        nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True, grid=grid))
    return state_from_numpy([[np.asarray(x) for x in fam] for fam in s0],
                            device="cpu")


LAYOUTS = {
    # controller over the p/q edges only (u flies fp32), under a budget
    "legacy_pq": lambda edges, n, epochs: (edges[:n], dict(
        byte_budget=sum(edges[:n]) * epochs, total_iters=epochs)),
    # every admm_edges edge managed (u on an affine wire)
    "managed_u": lambda edges, n, epochs: (edges, dict(
        allowed_bits=(8, 16), min_bits=8, max_bits=16,
        byte_budget=0.75 * epochs * sum(6 * e // 2 for e in edges[:n]),
        total_iters=epochs)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_adaptive_matches_reference(layout):
    from repro.comm.ledger import CommLedger as JLedger
    from repro.core.pdadmm import ADMMConfig as JConfig
    from repro_torch.comm.ledger import CommLedger as TLedger
    from repro_torch.core.pdadmm import ADMMConfig as TConfig
    key, jdata, tdata, dims, jgrids, tgrids = _adaptive_problem()
    epochs, V = 12, jdata[0].shape[0]
    n_bound = len(dims) - 2
    edges, kw = LAYOUTS[layout](jcl.admm_edges(dims, V), n_bound, epochs)
    grids_j = {b: g for b, g in jgrids.items()
               if b in kw.get("allowed_bits", (4, 8, 16))}
    grids_t = {b: tgrids[b] for b in grids_j}
    cj, ct = _pair(kw, edges)
    lj, lt = JLedger(), TLedger()
    _, hj = jcl.train_adaptive(key, *jdata, dims, JConfig(nu=1e-2, rho=1.0),
                               epochs, controller=cj, ledger=lj,
                               grids_by_bits=grids_j)
    init = _reference_init(key, jdata[0], dims, tcl.BitWidthController(
        edges, tcl.ControllerConfig(**kw)), jgrids)
    _, ht = tcl.train_adaptive(None, *tdata, dims, TConfig(nu=1e-2, rho=1.0),
                               epochs, controller=ct, ledger=lt,
                               grids_by_bits=grids_t, init=init,
                               device="cpu")
    assert ht["schedules"] == hj["schedules"]
    if layout == "legacy_pq":            # the budget makes it switch
        assert len(set(hj["schedules"])) > 1
    assert lt.per_edge() == lj.per_edge()
    assert lt.total_bytes() == lj.total_bytes()
    sj, st = cj.state_dict(), ct.state_dict()
    for k in ("bits", "last_switch", "emitted", "spent_bytes", "n_switches",
              "cooldown_until"):
        assert st[k] == sj[k], k
    # the peaks are residuals: f32 sums in another order
    np.testing.assert_allclose(st["peak"], sj["peak"], rtol=1e-5)
    np.testing.assert_allclose(ht["objective"], hj["objective"], rtol=1e-5)
    np.testing.assert_allclose(ht["test_acc"], hj["test_acc"], atol=0.02)


def test_train_adaptive_rollback_matches_clean_run(tmp_path):
    """A NaN poisoned into the state rolls back to the last checkpoint and
    the finished run's objectives EQUAL the clean run's; a resume from the
    same directory continues past the saved step. The reference's own
    problem (``tests/test_faults.py``), its data, grids and initial state
    handed over through numpy."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core import pdadmm as jpd
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.core import quantize as tq
    from repro_torch.core.pdadmm import ADMMConfig
    key = jax.random.PRNGKey(0)
    V, d, C = 48, 12, 3
    X = jax.random.normal(key, (V, d))
    labels = jax.random.randint(jax.random.PRNGKey(1), (V,), 0, C)
    dims = [d, 8, 8, C]
    jgrids = {b: jpd.calibrate_grid(key, X, dims, b) for b in (4, 8)}
    grids = {b: tq.QuantGrid(g.lo, g.step, g.n_levels)
             for b, g in jgrids.items()}
    t = lambda a: torch.from_numpy(np.array(a))
    data = (t(X), t(labels), {k: torch.ones(V) for k in ("train", "val",
                                                         "test")})
    cfg = ADMMConfig(nu=1e-2, rho=1.0, fista_iters=3)

    def mk_ctl():
        return tcl.BitWidthController(
            tcl.admm_edges(dims, V)[:len(dims) - 2],
            tcl.ControllerConfig(allowed_bits=(4, 8), min_bits=4,
                                 max_bits=8))
    init = _reference_init(key, X, dims, mk_ctl(), jgrids)
    kw = dict(grids_by_bits=grids, init=init, device="cpu")
    _, clean = tcl.train_adaptive(None, *data, dims, cfg, 8,
                                  controller=mk_ctl(), ledger=CommLedger(),
                                  **kw)
    poisoned = {"n": 0}

    def hook(e, state):
        if e == 5 and poisoned["n"] == 0:
            poisoned["n"] += 1
            W = list(state.W)
            W[0] = W[0].clone()
            W[0][0, 0] = float("nan")
            return state._replace(W=W)
        return state

    led = CommLedger()
    _, hist = tcl.train_adaptive(None, *data, dims, cfg, 8,
                                 controller=mk_ctl(), ledger=led,
                                 ckpt=str(tmp_path), ckpt_every=2,
                                 fault_hook=hook, **kw)
    assert poisoned["n"] == 1
    assert led.fault_counts()["step"]["rolled_back"] == 1
    assert hist["objective"] == clean["objective"]
    _, hist2 = tcl.train_adaptive(None, *data, dims, cfg, 12,
                                  controller=mk_ctl(), ledger=CommLedger(),
                                  ckpt=str(tmp_path), ckpt_every=4,
                                  resume=True, **kw)
    assert 0 < len(hist2["objective"]) < 12      # resumed, not restarted
    assert np.isfinite(hist2["objective"]).all()


def test_gamlp_paper_config_equals_reference():
    import dataclasses
    from repro.configs import base as jbase
    from repro.configs import gamlp_paper as jg
    from repro_torch.configs import base as tbase
    from repro_torch.configs import gamlp_paper as tg
    assert dataclasses.asdict(tg.GAMLP) == dataclasses.asdict(jg.GAMLP)
    assert tbase.get_arch("gamlp-paper") == tg.CONFIG
    assert dataclasses.asdict(tg.CONFIG) == dataclasses.asdict(
        jbase.get_arch("gamlp-paper"))


def test_train_gamlp_example_resumes_after_a_kill(tmp_path, capsys,
                                                  monkeypatch):
    """The example is stopped right after its first checkpoint, as a kill
    would stop it, and a second run resumes from that step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.examples import train_gamlp_admm as ex
    save = CheckpointManager.save

    def save_then_die(self, step, tree, extra=None):
        out = save(self, step, tree, extra)
        raise KeyboardInterrupt
    argv = ["--device", "cpu", "--scale", "0.05", "--epochs", "3",
            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(CheckpointManager, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        ex.main(argv)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0]
    monkeypatch.setattr(CheckpointManager, "save", save)
    ex.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 1" in out
    assert "final test accuracy" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2]
