"""Stage-parallel pdADMM-G with a quantized ring wire, on the port.

The PyTorch counterpart of the reference demo: the per-device shift
payload of one recorded ring step, fp32 against the 8-bit grid
(``analysis.program_stats``, where the reference reads compiled HLO);
pdADMM-G-Q trained as a ring of layer-stages
(``parallel.stage_parallel.distributed_train``) on a (data 2, model 4)
mesh of ``tiny(V=128)``, with every payload on the ``CommLedger``; the same
run with the boundary exchange double-buffered (the same bits); and the
padded-container wire, where a controller gives each ring boundary its own
width every iteration inside one step. Then the replay cost model:
calibrate a cost table from micro-runs on the ring, predict the step's
time from one recorded step of each overlap variant beside its measured
time, pick the overlap knob by prediction, and let the walltime objective
choose the mixed-width schedule. Then a chaos run (bit flips, a stage
blackout and sneaky corruption, checkpoints every 3 iterations), and last
the program-contract lint table of four registered configurations
(``analysis.contracts``), each recorded on ``--device``.

    python -m repro_torch.examples.quantized_comm_demo [--device cpu]

The ring is a ``LocalRing``: every shard in this process, on ``--device``
(default: the card).
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import contracts as CT
from repro_torch.analysis import program_stats as PS
from repro_torch.analysis.costs import timed
from repro_torch.analysis.replay import calibrate, replay
from repro_torch.comm import faults as FT
from repro_torch.comm.codecs import FP32, codec_for_grid
from repro_torch.comm.controller import (BitWidthController,
                                         ControllerConfig, stage_ring_edges)
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.graph.datasets import tiny
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import LocalRing, StageMesh

LINT_CONFIGS = ["baseline", "overlap", "int8_wire", "psum_int8_w4"]
MIXED = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16, min_dwell=1,
             hysteresis=0.0, signal="per_edge", thresholds=((0.5, 4), (0.1, 8)))


def wire_bytes(mesh, cfg, V=256, h=64, L=8, C=4) -> int:
    """Shift payload bytes per device of one recorded ring step
    (shape-only, on the CPU): the reference's compiled-HLO reading."""
    prog = SP.trace_step_program(mesh, L, C, cfg, V=V, h=h)
    return PS.analyze(prog).coll_summary()["by_kind"].get(
        "collective-permute", {"payload_bytes": 0})["payload_bytes"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--epochs", type=int, default=15)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh = StageMesh(data=2, model=4)
    L, h = 8, 64
    ds = tiny(V=128, device=device)
    X = ds.augmented(4)
    V = X.shape[0]
    g8 = uniform_grid(8, -2.0, 6.0)
    fp = SP.wire_bytes_per_iteration(mesh, L, V, h, FP32, FP32)
    q8 = SP.wire_bytes_per_iteration(mesh, L, V, h, codec_for_grid(g8),
                                     codec_for_grid(g8))
    fp_pq, q8_pq = fp["q_fwd"] + fp["p_bwd"], q8["q_fwd"] + q8["p_bwd"]
    print("ring bytes per iteration, q forward + p backward (ledger model):")
    print(f"  fp32 wire : {fp_pq:10d} bytes")
    print(f"  int8 wire : {q8_pq:10d} bytes  ({100 * (1 - q8_pq / fp_pq):.0f}%"
          " saved)")

    fp_dev = wire_bytes(mesh, ADMMConfig(nu=1e-2, rho=1.0))
    q8_dev = wire_bytes(mesh, ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True,
                                         quantize_q=True, grid=g8))
    print("collective-permute payload per iteration (per device, one "
          "recorded step):")
    print(f"  fp32 wire : {fp_dev:10d} bytes")
    print(f"  int8 wire : {q8_dev:10d} bytes  "
          f"({100 * (1 - q8_dev / fp_dev):.0f}% saved)")

    gen = torch.Generator().manual_seed(0)
    P0 = (torch.randn((X.shape[1], h), generator=gen)
          * float(np.sqrt(2.0 / X.shape[1]))).to(device)
    Xp = torch.relu(X @ P0)
    cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                     grid=g8)
    ledger = CommLedger()
    _, hist = SP.distributed_train(mesh, 0, Xp, ds.labels, ds.masks, L,
                                   ds.n_classes, cfg, args.epochs,
                                   ledger=ledger)
    print(f"quantized-wire objective: {hist['objective'][0]:.3f} -> "
          f"{hist['objective'][-1]:.3f} (residual "
          f"{hist['residual'][-1]:.1e})")
    s = ledger.summary()
    print(f"ledger: {s['total_bytes']} wire bytes over {s['iterations']} "
          f"iters ({100 * s['savings_vs_fp32']:.0f}% saved vs fp32)")

    # the boundary exchange double-buffered: the same trajectory, the same
    # consumed bytes, plus the q/u pair still in flight at the end
    led_ov = CommLedger()
    _, hist_ov = SP.distributed_train(mesh, 0, Xp, ds.labels, ds.masks, L,
                                      ds.n_classes, cfg, args.epochs,
                                      ledger=led_ov, overlap=True)
    assert hist_ov["objective"] == hist["objective"]
    consumed = {e: b for e, b in led_ov.per_edge().items()
                if not e.endswith("/inflight")}
    assert consumed == ledger.per_edge()
    tail = led_ov.total_bytes() - ledger.total_bytes()
    print(f"overlap=True: identical trajectory, identical per-iteration "
          f"wire bytes (+{tail} B tail pair left in flight at the end)")

    # per-boundary mixed widths through the padded-container wire
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    ctl = BitWidthController(stage_ring_edges(mesh.model, V, h),
                             ControllerConfig(**MIXED))
    led_mw = CommLedger()
    _, hist_mw = SP.distributed_train(
        mesh, 0, Xp, ds.labels, ds.masks, L, ds.n_classes,
        ADMMConfig(nu=1e-2, rho=1.0), args.epochs, controller=ctl,
        grids_by_bits=grids, ledger=led_mw, mixed_width=True)
    assert hist_mw["n_compiled_steps"] == 1
    print(f"mixed-width run: {len(set(hist_mw['schedules']))} distinct "
          f"per-boundary schedules (last: {hist_mw['schedules'][-1]}), "
          f"1 step built")
    s = led_mw.summary()
    print(f"  ledger: {s['total_bytes']} logical B (active codecs) vs "
          f"{s['wire_bytes']} physical B (padded containers on the link)")

    # the replay cost model: a cost table from micro-runs (never the step
    # under test), one recorded step per variant as a comm/compute DAG, and
    # its predicted time beside the measured one
    ring = LocalRing(mesh, device)
    costs = calibrate(ring, V=V, h=h, n_classes=ds.n_classes, iters=5)
    init = SP.shard_stack(SP.init_stack(0, Xp, L, cfg), ring)
    data = [ring.to_local(x, "rows")
            for x in (Xp, ds.labels, ds.masks["train"])]
    print("replay cost model: predicted vs measured step time")
    for overlap in (False, True):
        step, _ = SP.make_distributed_step(mesh, L, ds.n_classes, cfg,
                                           overlap=overlap, ring=ring)
        carry = init
        if overlap:
            primer = SP.make_overlap_primer(mesh, codec_for_grid(g8),
                                            ring=ring)
            carry = (init, primer(init.q, init.u))
        ms = timed(step, carry, *data, iters=5, device=device) * 1e3
        dag = SP.trace_step_dag(mesh, L, ds.n_classes, cfg, V=V, h=h,
                                overlap=overlap)
        pred = replay(dag, costs, n_workers=1).step_time_ms
        print(f"  overlap={str(overlap):5s}: measured {ms:7.2f} ms   "
              f"predicted {pred:7.2f} ms")
    choice = SP.choose_overlap_for(mesh, L, ds.n_classes, cfg, V=V, h=h,
                                   costs=costs, ring=ring)
    print(f"  replay-searched choice: overlap={choice}")

    # the same model drives the controller: objective="walltime" keeps the
    # residual-driven accuracy floor and promotes any boundary whose finer
    # width the replay predicts to cost no time; on the padded-container
    # wire every promotion is free (the link carries the capacity either
    # way), so the schedule rides at the widest legal width
    cm = SP.step_cost_model(mesh, L, ds.n_classes, cfg, costs, V=V, h=h,
                            grids_by_bits=grids, mixed_width=True, ring=ring)
    ctl_wt = BitWidthController(
        stage_ring_edges(mesh.model, V, h),
        ControllerConfig(objective="walltime", **MIXED), cost_model=cm)
    _, hist_wt = SP.distributed_train(
        mesh, 0, Xp, ds.labels, ds.masks, L, ds.n_classes,
        ADMMConfig(nu=1e-2, rho=1.0), args.epochs, controller=ctl_wt,
        grids_by_bits=grids, mixed_width=True)
    sb, sw = hist_mw["schedules"][-1], hist_wt["schedules"][-1]
    print(f"walltime objective: bytes floor {tuple(sb)} -> replay-chosen "
          f"{tuple(sw)} ({cm(sb) * 1e3:.2f} -> {cm(sw) * 1e3:.2f} ms "
          f"predicted), still 1 step built")

    # chaos on the wire: a blackout silences every slab stage 2 sends for
    # two iterations, bit flips corrupt payloads in flight, and sneaky
    # (pre-checksum) corruption can slip past the header. The checksum and
    # seqno header beside each payload catches the flips and the drops and
    # the step substitutes the last good slab; what the header cannot see
    # trips the finite/spike sentinels and rolls back to a checkpoint.
    plan = FT.FaultPlan(seed=11, flip_rate=0.05, sneaky_rate=0.04,
                        flips_per_event=6, blackouts=((2, 5, 2),))
    led_ft = CommLedger()
    with tempfile.TemporaryDirectory() as d_ck:
        _, hist_ft = SP.distributed_train(
            mesh, 0, Xp, ds.labels, ds.masks, L, ds.n_classes, cfg,
            args.epochs, faults=plan, ledger=led_ft, ckpt=d_ck,
            ckpt_every=3)
    f = hist_ft["faults"]
    sneaky = sum(1 for ev in plan.trace(f["ticks"], mesh.model)
                 if ev[3] == "sneaky")
    print(f"chaos run (flips + stage-2 blackout + sneaky corruption): "
          f"{f['injected']} faults injected, {f['detected']} wire-detected, "
          f"{f['recovered']} recovered in-step, {f['rolled_back']} "
          f"rollback(s) to checkpoint")
    if not f["rolled_back"]:
        why = ("none of them left the state non-finite or spiked the "
               "objective" if sneaky else "the header saw every fault")
        print(f"  no rollback: {sneaky} sneaky (pre-checksum) event(s) in "
              f"{f['ticks']} ticks; {why}")
    print(f"  objective {hist_ft['objective'][0]:.3f} -> "
          f"{hist_ft['objective'][-1]:.3f} under chaos (clean run reached "
          f"{hist['objective'][-1]:.3f}); per-edge faults: "
          f"{led_ft.fault_counts()}")

    # every claim above is also a standing contract: the linter checks
    # one recorded call of each registered configuration against the
    # program it promises (python -m repro_torch.analysis.lint --all)
    findings = CT.check_all(LINT_CONFIGS, device=device)
    print(f"\nprogram-contract lint (one recorded call each, on "
          f"{device.type}):")
    print(CT.summary_table(findings, LINT_CONFIGS))
    n_err = sum(1 for x in findings if x.severity == "error")
    print(f"  {n_err} error(s) across {len(LINT_CONFIGS)} configs")


if __name__ == "__main__":
    main()
