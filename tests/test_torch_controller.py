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
    with pytest.raises(NotImplementedError, match="analysis"):
        tcl.BitWidthController([1], tcl.ControllerConfig(objective="walltime"))
