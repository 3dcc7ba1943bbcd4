"""The port's program-contract linter (``analysis.contracts``, ``lint``,
``program_stats``) against the JAX reference's.

The reference runs ONCE, in a subprocess (``REFERENCE``) with eight
simulated CPU devices: for each of its 11 step specs the plan fields, its
jaxpr's ``collective_profile`` and ``_ppermute_moves``; for each of its 4
psum specs the plan and the payload ops; the error keys each of its
mutations fires; and its demo's collective-permute bytes per device from
compiled HLO (``examples/quantized_comm_demo.wire_bytes``). Everything
crosses as JSON.

Held exactly: the plans, the recorded per-tensor wire dtypes and bytes per
link, carried or not, the psum payload ops, and the set of error keys each
mutation fires. ``work_to_consumer`` is held by class: 0 (the exchange is
on the critical path) or at least the plan's floor (hidden behind solver
work). The counts themselves differ by construction: the reference counts
``dot_general`` and ``pallas_call`` equations, the port matmul and kernel
records, and the solver runs a different number of each.

The reference's own f64 test (``tests/test_contracts.py::
test_mutation_dtype_f64_leak``) fails under jax 0.9.0, where
``jax.experimental.enable_x64`` is gone, so it is no oracle here:
``dtype.no_f64`` is held to a port-only mutation (a ``wrap=`` that casts
an output to float64), as is ``dispatch.pallas_calls`` (a
``use_kernels=False`` recording against the kernel plan).

The ``cuda`` cases record on the card: every spec clean, and the kernel
wrappers' own counters over one call equal the plan (the ragged view's
too).
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import contracts as CT
from repro_torch.analysis import program_stats as PS
from repro_torch.analysis import torch_trace as tt
from repro_torch.comm.codecs import AffineCodec, GridCodec
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import StageMesh

ROOT = Path(__file__).resolve().parents[1]
STEP_NAMES = [s.name for s in CT.STEP_SPECS]
PSUM_NAMES = [s.name for s in CT.PSUM_SPECS]

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src"); sys.path.insert(0, "examples")
from repro.analysis import contracts as CT
from repro.comm.codecs import GridCodec, AffineCodec
from repro.core.quantize import uniform_grid
from repro.core.pdadmm import ADMMConfig
from repro.launch.mesh import compat_make_mesh

out = {"steps": {}, "psums": {}, "mutations": {},
       "contracts": {k: c.severity for k, c in CT.CONTRACTS.items()},
       "specs": {s.name: dataclasses.asdict(s)
                 for s in CT.STEP_SPECS + CT.PSUM_SPECS},
       "pinned": sorted(CT.PINNED_STEP_KWARGS)}
for s in CT.STEP_SPECS:
    v = CT.ProgramView(s)
    p = v.plan
    out["steps"][s.name] = {
        "edge_events": [list(e) for e in p.edge_events],
        "n_carried": p.n_carried,
        "min_work_to_consumer": p.min_work_to_consumer,
        "expects_xor": p.expects_xor, "donate": p.donate,
        "profile": v.profile, "moves": [list(m) for m in v.ppermute_moves]}
for s in CT.PSUM_SPECS:
    v = CT.PsumView(s)
    p = v.plan
    out["psums"][s.name] = {
        "plan": [p.mode, p.collective, p.operand_dtype, p.operand_bytes,
                 p.handshake],
        "payload_ops": [list(o) for o in v.payload_ops()]}

def keys(f):
    return sorted({x.key for x in f if x.severity == "error"})

G = lambda b: GridCodec(uniform_grid(b, *CT.GRID_RANGE))
for name, (spec, ov) in {
        "donate": ("donate", {"donate": False}),
        "overlap": ("overlap", {"overlap": False}),
        "health": ("health", {"health": False, "faults": None}),
        "faults": ("faults", {"faults": None}),
        "int8_wire": ("int8_wire", {"q_codec": G(16)}),
        "psum_affine16": ("psum_int4_w4", {"codec": AffineCodec(16)}),
        "psum_affine8": ("psum_int4_w4", {"codec": AffineCodec(8)})}.items():
    out["mutations"][name] = keys(CT.check_contracts(spec, overrides=ov))
out["mutations"]["cache_phantom"] = keys(CT.check_contracts(
    "baseline", families=["cache"],
    pinned=sorted(CT.PINNED_STEP_KWARGS) + ["phantom_kwarg"]))
out["mutations"]["cache_identity"] = keys(CT.check_contracts(
    "baseline", families=["cache"], variants={"overlap": {}}))

import quantized_comm_demo as demo
mesh = compat_make_mesh((2, 4), ("data", "model"))
out["demo"] = {
    "fp32": demo.wire_bytes(mesh, ADMMConfig(nu=1e-2, rho=1.0)),
    "grid8": demo.wire_bytes(mesh, ADMMConfig(
        nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
        grid=uniform_grid(8, -2.0, 6.0)))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    r = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _error_keys(findings):
    return sorted({f.key for f in findings if f.severity == "error"})


def _grid(bits):
    return GridCodec(uniform_grid(bits, *CT.GRID_RANGE))


# the mutations of tests/test_contracts.py: (spec, check_contracts kwargs)
MUTATIONS = {
    "donate": ("donate", dict(overrides={"donate": False})),
    "overlap": ("overlap", dict(overrides={"overlap": False})),
    "health": ("health", dict(overrides={"health": False, "faults": None})),
    "faults": ("faults", dict(overrides={"faults": None})),
    "int8_wire": ("int8_wire", dict(overrides={"q_codec": _grid(16)})),
    "psum_affine16": ("psum_int4_w4",
                      dict(overrides={"codec": AffineCodec(16)})),
    "psum_affine8": ("psum_int4_w4",
                     dict(overrides={"codec": AffineCodec(8)})),
    "cache_phantom": ("baseline", dict(
        families=["cache"],
        pinned=sorted(CT.PINNED_STEP_KWARGS) + ["phantom_kwarg"])),
    "cache_identity": ("baseline", dict(families=["cache"],
                                        variants={"overlap": {}})),
}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_the_reference(ref):
    """The same 17 contract keys and severities, the same 11 + 4 specs
    with the same fields, the same pinned kwargs; ``ring`` is placement,
    outside the pinned set."""
    assert {k: c.severity for k, c in CT.CONTRACTS.items()} == \
        ref["contracts"]
    assert len(CT.CONTRACTS) == 17
    import dataclasses
    got = {s.name: dataclasses.asdict(s) for s in CT.STEP_SPECS +
           CT.PSUM_SPECS}
    want = {k: {f: (tuple(v) if isinstance(v, list) else v)
                for f, v in d.items()} for k, d in ref["specs"].items()}
    assert got == want
    assert sorted(CT.PINNED_STEP_KWARGS) == ref["pinned"]
    assert not CT.PINNED_STEP_KWARGS & CT.PLACEMENT_STEP_KWARGS
    with pytest.raises(KeyError, match="nope"):
        CT.get_spec("nope")
    from repro_torch.analysis import static_checks as SC
    assert SC.Finding is CT.Finding


# ---------------------------------------------------------------------------
# plans and recordings against the reference's jaxprs
# ---------------------------------------------------------------------------

def _work_class(row, floor):
    if row["carried"]:
        return "carried"
    return "fused" if row["work_to_consumer"] == 0 else (
        "hidden" if row["work_to_consumer"] >= max(floor, 1) else "short")


@pytest.mark.parametrize("name", STEP_NAMES)
def test_step_plan_and_recording_match_the_reference(ref, name):
    want = ref["steps"][name]
    view = CT.ProgramView(CT.get_spec(name), device="cpu")
    plan = view.plan
    assert [list(e) for e in plan.edge_events] == want["edge_events"]
    assert (plan.n_carried, plan.min_work_to_consumer, plan.expects_xor,
            plan.donate) == (want["n_carried"], want["min_work_to_consumer"],
                             want["expects_xor"], want["donate"])
    got = view.profile
    assert [(p["dtype"], p["carried"]) for p in got] == \
        [(p["dtype"], p["carried"]) for p in want["profile"]]
    floor = plan.min_work_to_consumer
    assert [_work_class(p, floor) for p in got] == \
        [_work_class(p, floor) for p in want["profile"]]
    assert [list(m) for m in view.ppermute_moves] == want["moves"]


@pytest.mark.parametrize("name", PSUM_NAMES)
def test_psum_plan_and_payload_ops_match_the_reference(ref, name):
    want = ref["psums"][name]
    view = CT.PsumView(CT.get_spec(name), device="cpu")
    p = view.plan
    assert [p.mode, p.collective, p.operand_dtype, p.operand_bytes,
            p.handshake] == want["plan"]
    assert [list(o) for o in view.payload_ops()] == want["payload_ops"]


# ---------------------------------------------------------------------------
# the clean run and the mutations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STEP_NAMES + PSUM_NAMES)
def test_registered_spec_is_clean(name):
    findings = CT.check_contracts(name, device="cpu")
    assert not [f.to_dict() for f in findings if f.severity == "error"]


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_mutation_fires_the_reference_keys(ref, mutation):
    spec, kw = MUTATIONS[mutation]
    findings = CT.check_contracts(spec, device="cpu", **kw)
    assert _error_keys(findings) == ref["mutations"][mutation]
    assert ref["mutations"][mutation]
    if mutation == "cache_identity":
        assert any("'overlap'" in f.message for f in findings)


def test_use_kernels_off_fires_dispatch():
    """The plan promises the card's launches; a step built with
    ``use_kernels=False`` records none of the solver's."""
    findings = CT.check_contracts("baseline", device="cpu",
                                  overrides={"use_kernels": False})
    assert _error_keys(findings) == ["dispatch.pallas_calls",
                                     "dispatch.ragged_fallback"]


def test_float64_output_fires_no_f64():
    """A wrap that casts the objective to float64: ``dtype.no_f64`` (an
    error) and ``dtype.weak_outputs`` (a warning: the metric is off its
    declared dtype). The reference's f64 mutation test cannot run under
    jax 0.9.0, so this is the port's own."""
    def wrap(step):
        def f(*args):
            carry, metrics = step(*args)
            return carry, dict(metrics,
                               objective=metrics["objective"].double())
        return f
    findings = CT.check_contracts("baseline", wrap=wrap, device="cpu",
                                  families=["dtype"])
    assert _error_keys(findings) == ["dtype.no_f64"]
    assert [f.key for f in findings if f.severity == "warn"] == \
        ["dtype.weak_outputs"]
    assert "metrics/objective" in findings[-1].message


def test_host_number_output_warns():
    """A metric read to the host each step is a Python number."""
    def wrap(step):
        def f(*args):
            carry, metrics = step(*args)
            return carry, dict(metrics, residual=float(metrics["residual"]))
        return f
    findings = CT.check_contracts("baseline", wrap=wrap, device="cpu",
                                  families=["dtype"])
    assert [(f.key, f.severity) for f in findings] == \
        [("dtype.weak_outputs", "warn")]
    assert "float" in findings[0].message


def test_crashed_check_is_an_error_finding():
    def wrap(step):
        def f(*args):
            raise RuntimeError("boom")
        return f
    findings = CT.check_contracts("overlap", wrap=wrap, device="cpu",
                                  families=["schedule"])
    assert findings and all(f.severity == "error" and f.details["crashed"]
                            for f in findings)
    assert "boom" in findings[0].message


# ---------------------------------------------------------------------------
# the recorder's moves and program_stats
# ---------------------------------------------------------------------------

def test_sentinel_shift_counts_one_event_per_tensor():
    """A sentinel shift carries payload and header in one call: two moves,
    each with its own consumer, in the plan's order."""
    mesh = StageMesh(2, 2)
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    prog = SP.trace_step_program(mesh, 4, 4, cfg, V=64, h=32, health=True)
    calls = prog.collectives("ppermute")
    assert len(calls) == 3 and [len(r.moves) for r in calls] == [2, 2, 2]
    assert tt.ppermute_moves(prog) == [("float32", 32 * 32 * 4),
                                       ("int32", 8)] * 3
    assert tt.count_primitives(prog, ["ppermute"]) == 3
    assert all(None not in r.move_consumers for r in calls)
    plan = SP.step_program_plan(mesh, 4, 4, cfg, V=64, h=32, health=True,
                                device="cpu")
    assert len(tt.collective_profile(prog)) == len(plan.edge_events)


@pytest.mark.parametrize("name,want", [("fp32", 98304), ("grid8", 49152)])
def test_demo_wire_bytes_equal_the_reference_hlo(ref, name, want):
    """program_stats' collective-permute payload per device of one
    recorded step: the reference's compiled-HLO number."""
    from repro_torch.examples.quantized_comm_demo import wire_bytes
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    if name == "grid8":
        cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                         grid=uniform_grid(8, -2.0, 6.0))
    got = wire_bytes(StageMesh(2, 4), cfg)
    assert got == ref["demo"][name] == want


def test_program_stats_kinds_and_payloads():
    """HLO's kind names; an all-gather's payload is the gathered tensor
    (group × operand), an all-reduce's its operand; matmul flops per
    device."""
    view = CT.PsumView(CT.get_spec("psum_int4_w4"), device="cpu")
    stats = PS.analyze(view.program)
    kinds = [(c.kind, c.payload_bytes, c.group_size)
             for c in stats.collectives]
    assert kinds == [("all-reduce", 4, 4), ("all-reduce", 4, 4),
                     ("all-gather", 4 * 64, 4)]
    s = stats.coll_summary()
    assert s["by_kind"]["all-gather"]["moved_bytes"] == 3 / 4 * 256
    assert s["total"]["count"] == 3
    prog = SP.trace_step_program(StageMesh(1, 2), 2, 4,
                                 ADMMConfig(use_kernels=False), V=8, h=4)
    st = PS.analyze(prog)
    assert st.flops > 0 and st.dot_bytes > 0 and st.bytes_written > 0
    coll, summ = PS.analyze_collectives(prog)
    assert summ["by_kind"]["collective-permute"]["payload_bytes"] == \
        3 * 8 * 4 * 4


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _lint(*argv, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                           *argv], capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout,
                          env={**__import__("os").environ,
                               "PYTHONPATH": "src"})


def test_lint_cli_list(ref):
    r = _lint("--list", timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert sorted(x.split()[1] for x in lines if x.startswith("step ")) == \
        sorted(n for n, s in ref["specs"].items() if "bits" not in s)
    assert sorted(x.split()[1] for x in lines if x.startswith("psum ")) == \
        sorted(n for n, s in ref["specs"].items() if "bits" in s)
    assert sorted(x.split()[1] for x in lines
                  if x.startswith("contract ")) == sorted(ref["contracts"])


def test_lint_cli_json_single_config_on_the_cpu():
    r = _lint("--config", "baseline", "--format", "json", "--device", "cpu",
              "--no-examples", "--no-deadcode")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    report = json.loads(r.stdout)
    assert report["configs"] == ["baseline"]
    assert report["device"] == "cpu"
    assert report["counts"]["error"] == 0
    assert isinstance(report["findings"], list)


def test_lint_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.analysis import lint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main(["--config", "baseline", "--no-examples", "--no-deadcode"])


def test_fault_plan_recording_needs_a_card_unless_told_cpu():
    """A fault plan's controls are data, so its step records real tensors:
    on the card unless the caller asks for the CPU, raising without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.comm import faults as FT
    plan = FT.FaultPlan(seed=1, flip_rate=0.5)
    args = (StageMesh(1, 2), 2, 4, ADMMConfig(nu=1e-2, rho=1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SP.trace_step_program(*args, V=8, h=4, faults=plan)
    prog = SP.trace_step_program(*args, V=8, h=4, faults=plan, device="cpu")
    assert tt.count_primitive(prog, "bitwise_xor") > 0


def test_lint_exits_one_on_an_error(monkeypatch, capsys):
    from repro_torch.analysis import lint
    monkeypatch.setattr(CT, "PINNED_STEP_KWARGS",
                        CT.PINNED_STEP_KWARGS | {"phantom_kwarg"})
    rc = lint.main(["--config", "baseline", "--families", "cache",
                    "--device", "cpu", "--no-examples", "--no-deadcode"])
    out = capsys.readouterr().out
    assert rc == 1 and "[cache.kwarg_set]" in out and "1 error(s)" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", STEP_NAMES + PSUM_NAMES)
def test_cuda_registered_spec_is_clean(cuda, name):
    findings = CT.check_contracts(name, device=cuda)
    assert not [f.to_dict() for f in findings if f.severity == "error"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["baseline", "quantized_solver",
                                  "int4_wire", "container"])
def test_cuda_wrapper_counters_equal_the_plan(cuda, name):
    view = CT.ProgramView(CT.get_spec(name), device=cuda)
    assert view.launches == view.plan.pallas_calls == view.pallas_counts
    ragged = view.ragged_view()
    assert ragged.launches == view.plan.pallas_calls
