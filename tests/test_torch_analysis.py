"""The port's analysis modules: the step recorder, the launch plan, the
cost table, calibration, ``psum_program_plan``, ``model_flops`` and the
static checks.

The reference's modules here need no device mesh, so they are imported
in-process (``repro.analysis.model_flops``, ``costs``, ``static_checks``,
``repro.comm.transport``) and held to the port's on the same inputs:
``model_flops`` exactly, a cost table saved by either package loads in the
other, ``psum_program_plan`` field for field, and the static checks report
the same findings on the same planted faults. Inside the port: the
recorder counts exactly the launches ``step_program_plan`` states (the
card's launches, recorded on the CPU through the plain versions) over
every ring variant, classifies consumption as the reference's
``collective_profile`` does on hand-made programs, and calibration fills
every key of the cost table on the CPU.
"""
import math
import os

import pytest
import torch

from repro_torch.analysis import torch_trace as tt
from repro_torch.analysis.costs import DEFAULT_ENTRIES, CostTable, timed
from repro_torch.analysis.replay import calibrate, extract_step_dag, replay
from repro_torch.comm.codecs import AffineCodec, GridCodec, codec_for_grid
from repro_torch.comm.transport import PaddedWire
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.kernels import ops
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import LocalRing, StageMesh

V, H, L, C = 64, 32, 4, 4
ARCHS = ("tinyllama-1.1b", "phi3-mini-3.8b", "granite-8b", "yi-9b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "qwen2-vl-7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _grids():
    return {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}


def _cfg(name):
    if name == "G":
        return ADMMConfig(nu=1e-2, rho=1.0)
    return ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                      grid=uniform_grid(8, -2.0, 6.0))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_recorder_classifies_consumption_like_collective_profile():
    """Three shifts: one read at once (blocking), one read after a matmul
    and a kernel (hidden), one never read (carried); psum of an
    all_gather's output makes the psum the all_gather's consumer."""
    mesh = StageMesh(1, 2)
    ring = LocalRing(mesh, "cpu")
    x = torch.ones((1, 2, 3, 4))
    w = torch.ones((4, 4))

    def fn(rr):
        a = rr.finish(rr.shift([x], +1, tag=0))[0]
        b = a + 1.0                                    # consumer of a
        h = rr.shift([b], -1, tag=2)
        y = b @ w                                      # work
        z = ops.relu_zupdate(y, y, y)                  # a kernel launch
        (c,) = rr.finish(h)
        d = c * z                                      # consumer of h
        rr.shift([d], +1, tag=1)                       # never finished
        g = rr.all_gather(d.sum(dim=(2, 3)), "model")
        return rr.psum(g, "data")

    with tt.StepRecorder(mesh.size) as rec:
        fn(tt.RecordingRing(ring, rec))
    prog = rec.program
    assert prog.collective_profile() == [
        {"dtype": "float32", "carried": False, "work_to_consumer": 0},
        {"dtype": "float32", "carried": False, "work_to_consumer": 2},
        {"dtype": "float32", "carried": True, "work_to_consumer": 0}]
    assert [r.edge for r in prog.collectives("ppermute")] == \
        ["q_fwd", "p_bwd", "u_fwd"]
    assert prog.launch_counts() == {"relu_zupdate": 1}
    gather, psum = prog.collectives("all_gather")[0], prog.collectives(
        "psum")[0]
    assert prog.records[gather.consumer] is psum and psum.carried
    dag = extract_step_dag(prog, n_stages=2)
    pp = [e for e in dag.comm_events if e.prim == "ppermute"]
    # per shard: a [3, 4] f32 slab; delta -1 on 2 stages is ring delta 1
    assert [e.wire_bytes for e in pp] == [48, 48, 48]
    assert [e.ring_delta for e in pp] == [1, 1, 1]
    assert [e.blocking for e in pp] == [True, False, False]


def test_kernel_scopes_count_launches_not_calls():
    """One scope is one launch; 8-bit codes are their own container (no
    launch), and a kernel's inner ops fold into its one record."""
    codes = torch.arange(12, dtype=torch.uint8).reshape(2, 6)
    with tt.StepRecorder() as rec:
        ops.pack_codes(codes, 8)
        ops.pack_codes(codes & 15, 4)
        ops.unpack_codes(ops.pack_codes(codes.to(torch.uint16), 16), 16, 6)
        ops.fused_linear(torch.ones(3, 4), torch.ones(4, 5),
                         torch.zeros(5), torch.ones(3, 5), mode="residual")
    prog = rec.program
    assert prog.launch_counts() == {"pack_codes": 2, "unpack_codes": 1,
                                    "fused_linear": 1}
    fl = [r for r in prog.records if r.name == "fused_linear"][0]
    assert fl.flops == 2.0 * 3 * 4 * 5 and fl.bytes > 0
    assert not ops._recorders


@pytest.mark.parametrize("cname", ["G", "GQ"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("wire", ["fp32", "grid4", "grid8", "grid16",
                                  "affine4", "mixed", "widest"])
def test_recorded_launches_equal_the_plan(cname, overlap, wire):
    """On every ring variant the recorder (CPU, plain versions) counts the
    launches ``step_program_plan`` states for the card."""
    mesh = StageMesh(2, 2)
    cfg = _cfg(cname)
    kw = dict(V=V, h=H, overlap=overlap)
    widths = None
    if wire in ("mixed", "widest"):
        kw["wire"] = PaddedWire.from_grids(_grids())
        if wire == "mixed":
            widths = [[0, 1], [2, 0]]
    elif wire != "fp32":
        bits = int(wire[-1] if wire[-2].isalpha() else wire[-2:])
        codec = (AffineCodec(bits) if wire.startswith("affine")
                 else GridCodec(uniform_grid(bits, -2.0, 6.0)))
        kw.update(p_codec=codec, q_codec=codec)
    prog = SP.trace_step_program(mesh, L, C, cfg, widths=widths, **kw)
    plan = SP.step_program_plan(mesh, L, C, cfg, device="cuda", **kw)
    assert prog.launch_counts() == plan.pallas_calls
    assert SP.step_program_plan(mesh, L, C, cfg, device="cpu",
                                **kw).pallas_calls == {}
    off = SP.step_program_plan(mesh, L, C, ADMMConfig(use_kernels=False),
                               device="cuda", **kw)
    assert off.pallas_calls == {}


@pytest.mark.parametrize("cname", ["G", "GQ"])
@pytest.mark.parametrize("overlap", [False, True])
def test_fault_plan_step_launches_equal_the_plan(cname, overlap):
    """A sentinel step under a fault plan (recorded with real tensors: its
    controls are data) launches the plain step's kernels."""
    from repro_torch.comm import faults as FT
    mesh = StageMesh(2, 2)
    cfg = _cfg(cname)
    plan = FT.FaultPlan(seed=1, flip_rate=0.5, drop_rate=0.2)
    inner = LocalRing(mesh, "cpu")
    rec = tt.StepRecorder(mesh.size)
    step, _ = SP.make_distributed_step(mesh, L, C, cfg, overlap=overlap,
                                       faults=plan,
                                       ring=tt.RecordingRing(inner, rec))
    g = torch.Generator().manual_seed(0)
    st = SP.shard_stack(SP.StackState(*(
        torch.randn(s, generator=g) for s in
        [(L, V, H), (L, H, H), (L, H), (L, V, H), (L, V, H), (L, V, H)])),
        inner)
    data = [inner.to_local(x, "rows") for x in
            (torch.randn(V, H), torch.zeros(V, dtype=torch.int32),
             torch.ones(V))]
    qc = codec_for_grid(cfg.grid if cfg.quantize_q else None)
    carry = (st, SP.make_sentinel_primer(mesh, qc, qc, ring=inner)(
        st.q, st.u, st.p))
    if overlap:
        carry = (carry, SP.make_overlap_primer(mesh, qc, sentinel=True,
                                               ring=inner)(st.q, st.u, -1))
    with rec:
        step(carry, *data, plan.controls(0, 2, prev_obj=float("inf"),
                                         device="cpu"))
    want = SP.step_program_plan(mesh, L, C, cfg, V=V, h=H, overlap=overlap,
                                faults=plan, device="cuda")
    assert rec.program.launch_counts() == want.pallas_calls
    assert [r.edge for r in rec.program.collectives("ppermute")] == \
        [e[0] for e in want.edge_events if not e[0].endswith(".header")]


@pytest.mark.parametrize("wire", [None, "container"])
def test_traced_wire_bytes_equal_the_ledgers(wire):
    """The DAG's per-link ppermute bytes × links are the ledger's physical
    bytes for one iteration of the same run, integer for integer."""
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.graph.datasets import tiny
    mesh = StageMesh(2, 2)
    ds = tiny(V=V, device="cpu")
    Xp = torch.relu(ds.augmented(1)[:, :H])
    cfg = _cfg("GQ")
    led = CommLedger()
    kw = {}
    if wire:
        from repro_torch.comm.controller import (BitWidthController,
                                                 ControllerConfig,
                                                 stage_ring_edges)
        kw = dict(mixed_width=True, grids_by_bits=_grids(),
                  controller=BitWidthController(
                      stage_ring_edges(2, V, Xp.shape[1]),
                      ControllerConfig(allowed_bits=(4, 8, 16))))
    SP.distributed_train(mesh, 0, Xp, ds.labels, ds.masks, L, ds.n_classes,
                         cfg, 1, ledger=led, ring=LocalRing(mesh, "cpu"),
                         **kw)
    dag = SP.trace_step_dag(mesh, L, ds.n_classes, cfg, V=V, h=Xp.shape[1],
                            wire=PaddedWire.from_grids(_grids())
                            if wire else None)
    links = mesh.size
    got = {e.edge: e.wire_bytes * links for e in dag.comm_events
           if e.prim == "ppermute"}
    want = {}
    for edge, b in led.per_edge_iteration_wire(0).items():
        base = edge.split("/")[0]
        want[base] = want.get(base, 0) + b
    assert got == want


# ---------------------------------------------------------------------------
# costs and calibration
# ---------------------------------------------------------------------------

def test_cost_tables_cross_between_packages(tmp_path):
    from repro.analysis.costs import CostTable as RefTable
    port = CostTable({"rate:dot_flops": 1.5e13, "link:latency": 3e-6},
                     {"device": "cpu", "mesh": {"data": 1, "model": 10}})
    port.save(tmp_path / "port.json")
    back = RefTable.load(tmp_path / "port.json")
    assert back.entries == port.entries and back.meta == port.meta
    ref = RefTable({"collective:psum": 2.5e-5}, {"backend": "cpu"})
    ref.save(tmp_path / "ref.json")
    got = CostTable.load(tmp_path / "ref.json")
    assert got.entries == ref.entries and got.meta == ref.meta
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    for k in DEFAULT_ENTRIES:
        assert got.get(k) == ref.get(k)
    assert got.link.transfer_time(1e6) == ref.link.transfer_time(1e6)
    with pytest.raises(KeyError):
        got.get("no:such")


def test_timed_needs_a_device_and_takes_the_median():
    calls = []
    t = timed(lambda: calls.append(1), iters=3, warmup=2, reps=5,
              device="cpu")
    assert t >= 0 and len(calls) == 2 + 3 * 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timed(lambda: None)


def test_calibrate_on_the_cpu_fills_the_table():
    mesh = StageMesh(2, 2)
    costs = calibrate(LocalRing(mesh, "cpu"), V=V, h=H, n_classes=C,
                      iters=2, reps=1, grid=uniform_grid(8, -2.0, 6.0))
    for k in DEFAULT_ENTRIES:
        assert k in costs.entries and math.isfinite(costs.get(k)) \
            and costs.get(k) > 0, k
    assert costs.get("collective:ppermute:issue") <= costs.get(
        "collective:ppermute")
    assert costs.meta["mesh"] == {"data": 2, "model": 2}
    assert costs.meta["world"] == 4 and costs.meta["device"] == "cpu"
    dag = SP.trace_step_dag(mesh, L, C, _cfg("GQ"), V=V, h=H)
    a, b = replay(dag, costs, n_workers=1), replay(dag, costs, n_workers=1)
    assert a.step_time_s == b.step_time_s > 0


def test_overlap_replay_resolves_to_the_replay_choice():
    from repro_torch.graph.datasets import tiny
    mesh = StageMesh(1, 2)
    ds = tiny(V=V, device="cpu")
    Xp = torch.relu(ds.augmented(1)[:, :H])
    cfg = _cfg("G")
    costs = CostTable({"collective:ppermute": 1.0,
                       "collective:ppermute:issue": 1e-9})
    want = SP.choose_overlap_for(mesh, L, ds.n_classes, cfg, V=V,
                                 h=Xp.shape[1], costs=costs)
    assert want is True                   # blocking shifts priced at 1 s
    _, hist = SP.distributed_train(mesh, 0, Xp, ds.labels, ds.masks, L,
                                   ds.n_classes, cfg, 2, overlap="replay",
                                   cost_table=costs,
                                   ring=LocalRing(mesh, "cpu"))
    assert hist["overlap"] is want
    _, plain = SP.distributed_train(mesh, 0, Xp, ds.labels, ds.masks, L,
                                    ds.n_classes, cfg, 2,
                                    ring=LocalRing(mesh, "cpu"))
    assert hist["objective"] == plain["objective"]


# ---------------------------------------------------------------------------
# psum_program_plan, model_flops, static checks: against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_psum_program_plan_matches_reference(bits):
    import dataclasses
    from repro.comm import codecs as rc, transport as rt
    from repro.core.quantize import uniform_grid as ref_grid
    from repro_torch.comm.transport import psum_program_plan
    pairs = [(AffineCodec(bits), rc.AffineCodec(bits)),
             (GridCodec(uniform_grid(bits, -3.0, 3.0)),
              rc.GridCodec(ref_grid(bits, -3.0, 3.0))),
             (codec_for_grid(None), rc.FP32)]
    for port, ref in pairs:
        for w in (2, 4, 8, 16):
            for mode in (None, "psum", "gather", "code_psum"):
                got = psum_program_plan(port, (37, 16), w, mode)
                want = rt.psum_program_plan(ref, (37, 16), w, mode)
                assert dataclasses.astuple(got) == \
                    dataclasses.astuple(want), (port, w, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    from repro.analysis.model_flops import model_flops as ref_flops
    from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
    from repro.configs.base import get_arch as ref_arch
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs.base import SHAPES_BY_NAME, get_arch
    for shape in SHAPES:
        got = model_flops(get_arch(arch), SHAPES_BY_NAME[shape])
        want = ref_flops(ref_arch(arch), REF_SHAPES[shape])
        assert got == want and got > 0, shape


def _plant(root, pkg):
    """An unused import and a broken example call, in ``pkg``'s layout."""
    src = os.path.join(root, "src", pkg)
    examples = (os.path.join(src, "examples") if pkg == "repro_torch"
                else os.path.join(root, "examples"))
    os.makedirs(examples)
    os.makedirs(src, exist_ok=True)
    with open(os.path.join(src, "mod.py"), "w") as fh:
        fh.write("import os\nimport json\nimport json\n"
                 "def f():\n    return 1\n    os.getcwd()\n"
                 "print(json.dumps([]))\nimport sys\n")
    with open(os.path.join(examples, "demo.py"), "w") as fh:
        fh.write(f"from {pkg}.core.quantize import uniform_grid\n"
                 f"from {pkg}.core.quantize import no_such_symbol\n"
                 "uniform_grid(8, -2.0, 6.0, phantom_kwarg=1)\n"
                 "comm_bytes_per_iteration = None\n")


def test_static_checks_report_what_the_reference_reports(tmp_path):
    from repro.analysis import static_checks as ref_sc
    from repro_torch.analysis import static_checks as sc
    _plant(str(tmp_path / "ref"), "repro")
    _plant(str(tmp_path / "port"), "repro_torch")

    def keyed(findings):
        return sorted((f.key, f.severity, f.details.get("line"),
                       f.details.get("name") or f.details.get("kwarg")
                       or f.details.get("target", "").split(".")[-1])
                      for f in findings)
    port_ex = sc.check_examples(str(tmp_path / "port"))
    ref_ex = ref_sc.check_examples(str(tmp_path / "ref"))
    assert keyed(port_ex) == keyed(ref_ex)
    assert {f.key for f in port_ex} == {"examples.import",
                                        "examples.stale_kwarg",
                                        "examples.deprecated_api"}
    # the port's examples live inside its package: compare mod.py alone
    port_dc = [f for f in sc.check_deadcode(str(tmp_path / "port"))
               if f.config.endswith("/mod.py")]
    ref_dc = ref_sc.check_deadcode(str(tmp_path / "ref"))
    assert keyed(port_dc) == keyed(ref_dc)
    assert {f.key for f in port_dc} == {"deadcode.unused_import",
                                        "deadcode.duplicate_import",
                                        "deadcode.unreachable"}
    assert all(f.config.startswith("src/repro_torch/") for f in port_dc)


def test_static_checks_find_nothing_in_the_port():
    from repro_torch.analysis import static_checks as sc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert [f.to_dict() for f in sc.check_deadcode(root)] == []
    assert [f.to_dict() for f in sc.check_examples(root)] == []
