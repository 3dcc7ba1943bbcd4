"""The port's replay cost model against the JAX reference's.

The reference runs ONCE, in a subprocess (``REFERENCE``) with eight
simulated CPU devices: its ``replay`` on the toy DAG of
``tests/test_replay.py`` and on its own ``trace_step_dag`` output (V = 64,
h = 32, L = 4, mesh (2, 2); overlap off/on × the 8-bit codec wire / the
padded container), its ``step_program_plan`` edge events,
``choose_psum_mode`` over a grid of points, and its walltime controller's
schedules under fixed cost callables. Everything crosses as JSON (floats
round-trip exactly).

Held exactly: ``replay`` gives the same bits (step time, per-stage busy and
idle, the critical path's labels and durations) on the same DAG and table;
the port's own recorded DAG matches the reference's ppermute events on
(edge, wire dtype, per-link bytes, carried, work before the consumer > 0)
and its psum count. One named difference: the port's per-stage residual
is an ``all_gather`` over the stages then a psum over data, where the
reference psums a one-hot slot vector, so the port's DAG has one
all_gather the reference's has not.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.costs import CostTable
from repro_torch.analysis.replay import (CommEvent, Segment, StepDag,
                                         choose_psum_mode, replay)
from repro_torch.comm.codecs import AffineCodec, GridCodec
from repro_torch.comm.controller import (BitWidthController,
                                         ControllerConfig, stage_ring_edges)
from repro_torch.comm.transport import PaddedWire
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import StageMesh

ROOT = Path(__file__).resolve().parents[1]
V, H, L, C = 64, 32, 4, 4
VARIANTS = [(ov, w) for ov in (False, True) for w in ("codec", "container")]
BITS = (2, 4, 8, 16, 32)
WORLDS = (2, 4, 8, 16)
CTL = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16, min_dwell=1,
           hysteresis=0.0)
# residuals fed to the walltime controllers, one pair per iteration
RESIDUALS = [[1.0, 1.0], [0.5, 0.9], [0.2, 0.4], [0.05, 0.3], [0.01, 0.02],
             [0.005, 0.001]]

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import jax
from repro.launch.mesh import compat_make_mesh
from repro.core.pdadmm import ADMMConfig
from repro.core import quantize
from repro.comm.codecs import GridCodec, AffineCodec
from repro.comm.controller import BitWidthController, ControllerConfig
from repro.parallel import stage_parallel as SP
from repro.analysis.replay import (CommEvent, Segment, choose_psum_mode,
                                   replay)
from test_replay import _toy_dag, _costs

V, H, L, C = %(V)d, %(H)d, %(L)d, %(C)d
mesh = compat_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
out = {}

def result(r):
    return {"step": r.step_time_s, "total": r.total_time_s,
            "busy": r.per_stage_busy_s, "idle": r.per_stage_idle_s,
            "path": [list(x) for x in r.critical_path]}

def items(dag):
    return [dict(dataclasses.asdict(x), type=type(x).__name__)
            for x in dag.items]

tables = {"base": _costs(), "starved": _costs(**{"link:bandwidth": 1e6})}
out["tables"] = {k: t.entries for k, t in tables.items()}
toy = _toy_dag()
out["toy"] = {"items": items(toy), "n_stages": toy.n_stages,
              "n_rows": toy.n_rows, "replay": {}}
for name, t in tables.items():
    for nw in (None, 1, 3):
        for it in (4, 8):
            out["toy"]["replay"][f"{name}/{nw}/{it}"] = result(
                replay(toy, t, n_iterations=it, n_workers=nw))

grids = {b: quantize.uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
wire = SP.PaddedWire.from_grids(grids)
cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                 grid=quantize.uniform_grid(8, -2.0, 6.0))
out["traced"] = {}
for overlap in (False, True):
    for wname, w in (("codec", None), ("container", wire)):
        dag = SP.trace_step_dag(mesh, L, C, cfg, V=V, h=H, overlap=overlap,
                                wire=w)
        rec = {"items": items(dag), "counts": dag.counts(), "replay": {}}
        for name, t in tables.items():
            for nw in (None, 1):
                rec["replay"][f"{name}/{nw}"] = result(
                    replay(dag, t, n_workers=nw))
        out["traced"][f"{int(overlap)}/{wname}"] = rec

plans = {}
for overlap in (False, True):
    for wname, w in (("codec", None), ("container", wire)):
        for health in (False, True):
            p = SP.step_program_plan(mesh, L, C, cfg, V=V, h=H,
                                     overlap=overlap, wire=w, health=health)
            plans[f"{int(overlap)}/{wname}/{int(health)}"] = [
                list(e) for e in p.edge_events] + [p.n_carried,
                                                   p.min_work_to_consumer]
for bits in (4, 16):
    c = GridCodec(quantize.uniform_grid(bits, -2.0, 6.0))
    p = SP.step_program_plan(mesh, L, C, ADMMConfig(), V=V, h=H, p_codec=c,
                             q_codec=c)
    plans[f"grid{bits}"] = [list(e) for e in p.edge_events]
out["plans"] = plans

psum = {}
for bits in %(BITS)r:
    codecs = {"affine": AffineCodec(bits) if bits <= 16 else None,
              "grid": (GridCodec(quantize.uniform_grid(bits, -3.0, 3.0))
                       if bits <= 16 else None)}
    for cname, codec in codecs.items():
        if codec is None:
            from repro.comm.codecs import FP32
            codec = FP32
        for w in %(WORLDS)r:
            for tname, t in (("none", None),) + tuple(tables.items()):
                psum[f"{bits}/{cname}/{w}/{tname}"] = choose_psum_mode(
                    codec, (256, 32), w, t)
out["psum"] = psum

kw = %(CTL)r
costs_fns = {"flat": lambda s: 1.0, "priced": lambda s: float(sum(s))}
sched = {}
for name, fn in costs_fns.items():
    for budget in (None, 3 * 1024.0 * 10):
        extra = {} if budget is None else {"byte_budget": budget,
                                           "total_iters": 10}
        for obj in ("walltime", "bytes"):
            ctl = BitWidthController(
                [1024, 1024], ControllerConfig(objective=obj, **kw, **extra),
                cost_model=fn if obj == "walltime" else None)
            sched[f"{name}/{budget}/{obj}"] = [
                list(ctl.assign(r, i)) for i, r in enumerate(%(RES)r)] + [
                ctl.spent_bytes, ctl.n_switches]
out["schedules"] = sched
print(json.dumps(out))
""" % dict(V=V, H=H, L=L, C=C, BITS=BITS, WORLDS=WORLDS, CTL=CTL,
           RES=RESIDUALS)


@pytest.fixture(scope="module")
def ref():
    r = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _table(entries):
    c = CostTable()
    for k, v in entries.items():
        c.set(k, v)
    return c


def _dag(items, n_stages=2, n_rows=2):
    out = []
    for d in items:
        d = dict(d)
        kind = d.pop("type")
        out.append(Segment(**d) if kind == "Segment" else CommEvent(**d))
    return StepDag(out, n_stages, n_rows)


def _result(r):
    return {"step": r.step_time_s, "total": r.total_time_s,
            "busy": r.per_stage_busy_s, "idle": r.per_stage_idle_s,
            "path": [list(x) for x in r.critical_path]}


def _cfg():
    return ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                      grid=uniform_grid(8, -2.0, 6.0))


def _wire(name):
    if name == "codec":
        return None
    return PaddedWire.from_grids({b: uniform_grid(b, -2.0, 6.0)
                                  for b in (4, 8, 16)})


# ---------------------------------------------------------------------------
# (a) the event simulator: the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["base", "starved"])
def test_replay_toy_dag_bitwise(ref, table):
    toy = ref["toy"]
    dag = _dag(toy["items"], toy["n_stages"], toy["n_rows"])
    costs = _table(ref["tables"][table])
    for nw in (None, 1, 3):
        for it in (4, 8):
            got = _result(replay(dag, costs, n_iterations=it, n_workers=nw))
            assert got == toy["replay"][f"{table}/{nw}/{it}"], (nw, it)


@pytest.mark.parametrize("variant", [f"{int(o)}/{w}" for o, w in VARIANTS])
def test_replay_reference_traced_dags_bitwise(ref, variant):
    rec = ref["traced"][variant]
    dag = _dag(rec["items"])
    for key, want in rec["replay"].items():
        table, nw = key.split("/")
        got = replay(dag, _table(ref["tables"][table]),
                     n_workers=None if nw == "None" else int(nw))
        assert _result(got) == want, key


def test_replay_is_deterministic_and_binds_on_a_starved_link(ref):
    dag = _dag(ref["toy"]["items"])
    costs = _table(ref["tables"]["starved"])
    a, b = replay(dag, costs), replay(dag, costs)
    assert _result(a) == _result(b) and a.step_time_s > 0
    name = next(lbl for lbl, _ in a.critical_comm()
                if lbl in ("q_fwd", "p_bwd"))
    assert replay(dag.with_wire_bytes({name: 0}), costs).step_time_s \
        < a.step_time_s


# ---------------------------------------------------------------------------
# (b) the port's own recorded DAG against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap,wname", VARIANTS)
def test_traced_dag_matches_reference(ref, overlap, wname):
    want = ref["traced"][f"{int(overlap)}/{wname}"]
    dag = SP.trace_step_dag(StageMesh(2, 2), L, C, _cfg(), V=V, h=H,
                            overlap=overlap, wire=_wire(wname))
    assert dag.n_stages == 2 and dag.n_rows == 2

    def key(e):
        return (e["edge"], e["dtype"], e["wire_bytes"], e["carried"],
                e["work_to_consumer"] > 0)
    got = [key(vars(e)) for e in dag.comm_events if e.prim == "ppermute"]
    exp = [key(e) for e in want["items"] if e.get("prim") == "ppermute"]
    assert got == exp
    assert [e[0] for e in got] == (["p_bwd", "q_fwd", "u_fwd"] if overlap
                                   else ["q_fwd", "u_fwd", "p_bwd"])
    counts = dag.counts()
    assert counts["psum"] == want["counts"]["psum"]
    # the named difference: the per-stage residual's all_gather
    assert counts.get("all_gather", 0) == \
        want["counts"].get("all_gather", 0) + 1
    # every consumed event names the item that reads it
    for e in dag.comm_events:
        assert (e.consumer_index is None) == e.carried


# ---------------------------------------------------------------------------
# (c) the plan's edge events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap,wname", VARIANTS)
@pytest.mark.parametrize("health", [False, True])
def test_plan_edge_events_match_reference(ref, overlap, wname, health):
    p = SP.step_program_plan(StageMesh(2, 2), L, C, _cfg(), V=V, h=H,
                             overlap=overlap, wire=_wire(wname),
                             health=health, device="cpu")
    got = [list(e) for e in p.edge_events] + [p.n_carried,
                                              p.min_work_to_consumer]
    assert got == ref["plans"][f"{int(overlap)}/{wname}/{int(health)}"]


@pytest.mark.parametrize("bits", [4, 16])
def test_plan_codec_widths_match_reference(ref, bits):
    c = GridCodec(uniform_grid(bits, -2.0, 6.0))
    p = SP.step_program_plan(StageMesh(2, 2), L, C, ADMMConfig(), V=V, h=H,
                             p_codec=c, q_codec=c, device="cpu")
    assert [list(e) for e in p.edge_events] == ref["plans"][f"grid{bits}"]


# ---------------------------------------------------------------------------
# (d) the replay-priced psum choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_choose_psum_mode_matches_reference(ref, bits):
    from repro_torch.comm.codecs import FP32
    codecs = {"affine": AffineCodec(bits) if bits <= 16 else FP32,
              "grid": (GridCodec(uniform_grid(bits, -3.0, 3.0))
                       if bits <= 16 else FP32)}
    tables = {"none": None}
    tables.update({k: _table(v) for k, v in ref["tables"].items()})
    for cname, codec in codecs.items():
        for w in WORLDS:
            for tname, t in tables.items():
                assert choose_psum_mode(codec, (256, 32), w, t) == \
                    ref["psum"][f"{bits}/{cname}/{w}/{tname}"], \
                    (cname, w, tname)


# ---------------------------------------------------------------------------
# (e) the walltime controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn_name", ["flat", "priced"])
@pytest.mark.parametrize("budget", [None, 3 * 1024.0 * 10])
def test_walltime_schedules_match_reference(ref, fn_name, budget):
    fn = {"flat": lambda s: 1.0, "priced": lambda s: float(sum(s))}[fn_name]
    extra = {} if budget is None else {"byte_budget": budget,
                                       "total_iters": 10}
    for obj in ("walltime", "bytes"):
        ctl = BitWidthController(
            [1024, 1024], ControllerConfig(objective=obj, **CTL, **extra),
            cost_model=fn if obj == "walltime" else None)
        got = [list(ctl.assign(r, i)) for i, r in enumerate(RESIDUALS)] + [
            ctl.spent_bytes, ctl.n_switches]
        assert got == ref["schedules"][f"{fn_name}/{budget}/{obj}"], obj


def test_walltime_unit_cases():
    """The reference's four walltime cases (tests/test_replay.py)."""
    def ctl(objective, cost_model=None, **kw):
        return BitWidthController(
            [1024, 1024], ControllerConfig(objective=objective, **CTL, **kw),
            cost_model=cost_model)
    with pytest.raises(ValueError, match="cost_model"):
        ctl("walltime")
    flat = lambda schedule: 1.0                             # noqa: E731
    wt, by = ctl("walltime", flat), ctl("bytes")
    assert by.assign([1.0, 1.0], 0) == (4, 4)
    assert wt.assign([1.0, 1.0], 0) == (16, 16) and wt._bits == [4, 4]
    assert ctl("walltime", lambda s: sum(s)).assign([1.0, 1.0], 0) == (4, 4)
    wt = ctl("walltime", flat, byte_budget=3 * 1024.0 * 10, total_iters=10)
    assert wt.assign([1.0, 1.0], 0) == (16, 8)
    assert wt.spent_bytes == 1024 * 16 / 8 + 1024 * 8 / 8


def test_replay_searched_choices_on_real_step(ref):
    """As the reference's: the hand default without costs; with the
    synthetic table overlap is not predicted slower; the mixed-width cost
    model prices every schedule at the container's capacity, so the
    walltime controller promotes to (16, 16) where bytes keep (4, 4)."""
    mesh = StageMesh(2, 2)
    costs = _table({
        "step:dispatch": 1e-4, "collective:ppermute": 2e-4,
        "collective:psum": 5e-4, "collective:all_gather": 5e-4,
        "collective:ppermute:issue": 1e-5, "collective:psum:issue": 1e-5,
        "collective:all_gather:issue": 1e-5, "rate:dot_flops": 2e10,
        "rate:eltwise_bytes": 1e10, "rate:op_overhead": 5e-8,
        "link:latency": 1e-6, "link:bandwidth": 1e10})
    cfg = _cfg()
    assert SP.choose_overlap_for(mesh, L, C, cfg, V=V, h=H) is True
    assert SP.choose_overlap_for(mesh, L, C, cfg, V=V, h=H,
                                 costs=costs) is True
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    cm = SP.step_cost_model(mesh, L, C, cfg, costs, V=V, h=H,
                            grids_by_bits=grids, mixed_width=True)
    edges = stage_ring_edges(2, V, H)
    wt = BitWidthController(edges, ControllerConfig(objective="walltime",
                                                    **CTL), cost_model=cm)
    by = BitWidthController(edges, ControllerConfig(**CTL))
    sw, sb = wt.assign([1.0, 1.0], 0), by.assign([1.0, 1.0], 0)
    assert sw == (16, 16) and sb == (4, 4)
    assert cm(sw) <= cm(sb) * (1 + 1e-9)
    # the uniform-codec model prices the wider payload: never cheaper
    cu = SP.step_cost_model(mesh, L, C, cfg, costs, V=V, h=H,
                            grids_by_bits=grids, mixed_width=False)
    assert cu((16,)) >= cu((4,))
