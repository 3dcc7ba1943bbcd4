"""Multi-pod dry run of the port: record one step of every (arch × shape)
cell per device on the production meshes, and its memory, flops and
collectives: the port of ``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single

The reference lowers and compiles each cell on 512 forced host devices and
reads the compiled HLO. The port runs the cell's step once as rank 0 of a
fake world of 256 (single) or 512 (multi-pod) ranks (``launch.mesh.
fake_world``): the params, optimizer state, inputs and decode state are
DTensors of fake local shards laid out by the cell's rules, nothing
computes, and ``analysis.torch_trace`` records what the rank runs —
matmuls on its shards, the collectives DTensor issues — with a live-bytes
high-water mark (``analysis.program_stats``). Every number is one rank's
of a mesh that does not exist here: a trace, not a measurement. A cell
takes seconds to tens of seconds of host time at full width; the whole
``--all`` belongs on a host with cores and memory to spare, not on a small
shared machine.

Every family runs on a mesh (dense, MoE, VLM, SSM, hybrid, audio); a
cell that raises records its error, as the reference records any cell's.
An argument that the step never reads (whisper's encoder weights and its
cross K/V projections in decode) counts in no byte total, as ``jax.jit``
drops unused arguments before XLA counts them.

The ``--admm`` cells record the paper's own step (stage-parallel
pdADMM-G, fp32 wire, or pdADMM-G-Q with 8/16-bit codes) shape-only on a
``LocalRing`` (``stage_parallel.record_step``): V 1,048,576 nodes, h 4096,
16 layers, 64 classes. The single mesh is ``StageMesh(16, 16)``; on the
multi-pod mesh the ring folds pod × data into one data axis,
``StageMesh(32, 16)``, the reference's ``dp_axes`` rows. The ring holds
every shard in one process, so its totals are divided by the shard count.

Output: ``artifacts/dryrun_torch/<mesh>/<arch>/<shape>.json`` with the
reference's keys. Where the port has no counterpart: ``compile_s`` is 0
(an eager step compiles nothing), ``xla_flops_per_device`` repeats the
recorded flops (a recorded step has no loop counted once), and
``hlo_chars`` is the number of records; ``trace_s`` is the recording's
host seconds.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import program_stats as PS
from repro_torch.analysis import torch_trace as tt
from repro_torch.configs.base import (ARCH_IDS, SHAPES_BY_NAME,
                                      arch_shape_cells, get_arch)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import common
from repro_torch.models.api import build
from repro_torch.parallel import sharding as sh
from repro_torch.train import optim

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _local(t):
    return getattr(t, "_local_tensor", t)


def _storages(tree) -> dict:
    """Storage -> bytes of ``tree``'s tensors (a DTensor's local shard),
    each storage once."""
    out = {}
    for t in tt._tensors(tree):
        st = _local(t).untyped_storage()
        out.setdefault(st._cdata, st.nbytes())
    return out


def _out_memory(program, args, out, donated=()) -> dict:
    """``memory_analysis`` of a recorded step: outputs written into an
    argument (a decode cache, a donated ring state) and outputs that
    replace ``donated`` arguments (the train step's params and optimizer
    state) alias."""
    arg_keys = set(_storages(args))
    outs = _storages(out)
    output = sum(outs.values())
    made = sum(b for k, b in outs.items() if k not in arg_keys)
    alias = (output - made) + sum(_storages(donated).values())
    return PS.memory_analysis(program, output, made, alias)


def trace_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
               moe_impl: str = "einsum", attn_chunk: int = 256,
               fsdp=None, donate: bool = True, microbatches=None):
    """Build and record one cell in a fake world; return (program, meta).

    Train: ``make_accum_train_step`` with ``adamw`` or ``adamw8bit`` (by
    ``cfg.opt_bits``), the state laid out by ``optim.make_opt_pspecs``;
    prefill: ``make_prefill_step``; decode: one step at a full cache
    (``make_serve_step``). ``donate`` counts the train step's params and
    optimizer state (the decode step writes its cache in place) as
    aliased, as the reference donates them."""
    from repro_torch.train.trainer import make_accum_train_step
    n = 512 if multi_pod else 256
    cfg = get_arch(arch_name)
    shape = SHAPES_BY_NAME[shape_name]
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod)
        bundle = build(cfg, mesh, shape, moe_impl=moe_impl,
                       attn_chunk=attn_chunk)
        if fsdp is not None:
            bundle.rules = sh.make_rules(mesh, cfg, shape, fsdp=fsdp)
        mb = cfg.microbatches if microbatches is None else microbatches
        params = bundle.abstract_params()
        batch = bundle.abstract_inputs(shape)
        donated = ()
        if shape.kind == "train":
            opt = (optim.adamw8bit(3e-4) if cfg.opt_bits == 8
                   else optim.adamw(3e-4))
            opt_shape = opt.init(params)
            o_ps = optim.make_opt_pspecs(opt_shape, bundle.param_pspecs(),
                                         params)
            opt_state = common.abstract_tree(opt_shape, o_ps, mesh)
            del opt_shape
            fn = make_accum_train_step(
                bundle, opt, mb,
                accum_dtype=torch.bfloat16 if cfg.accum_bf16 else None)
            args = (params, opt_state, batch)
            if donate:
                donated = (params, opt_state)
        elif shape.kind == "prefill":
            fn = make_prefill_step(bundle, shape)
            args = (params, batch)
        else:
            fn = make_serve_step(bundle, shape)
            args = (params, bundle.serve_state_shape(shape), batch)
        rec = tt.StepRecorder(memory=True)
        rec.hold(args)
        t0 = time.time()
        with rec:
            out = fn(*args)
        t1 = time.time()
        program = rec.program
        memory = _out_memory(program, args, out, donated)
        meta = {"trace_s": round(t1 - t0, 2), "lower_s": round(t1 - t0, 2),
                "compile_s": 0.0, "n_devices": mesh.size(),
                "mesh": sh.mesh_shape(mesh), "n_params": bundle.n_params(),
                "memory": memory}
    return program, meta


def cell_stats(program, meta, n_devices: int) -> dict:
    """The reference's stats keys from a recorded cell (per device)."""
    st = PS.analyze(program)
    stats = dict(meta)
    stats["n_devices"] = n_devices
    stats["xla_flops_per_device"] = st.flops
    stats["xla_bytes_per_device"] = st.dot_bytes + st.bytes_written
    stats["hlo_chars"] = len(program.records)
    stats["flops_per_device"] = st.flops
    stats["hbm_bytes_per_device"] = st.dot_bytes + st.bytes_written
    stats["dot_bytes_per_device"] = st.dot_bytes
    stats["collectives"] = st.coll_summary()
    return stats


def stage_mesh(multi_pod: bool):
    """The ADMM cells' ring: (16, 16), or (32, 16) with pod × data folded
    into the data axis."""
    from repro_torch.parallel.ring import StageMesh
    return StageMesh(32 if multi_pod else 16, 16)


def lower_admm_cell(multi_pod: bool, *, bits: int = 0, V: int = 1_048_576,
                    h: int = 4096, L: int = 16, n_classes: int = 64):
    """The paper's own technique at production scale: one stage-parallel
    pdADMM-G(-Q) step recorded shape-only on ``StageMesh(16, 16)``, or
    ``StageMesh(32, 16)`` for the multi-pod mesh (pod × data folded into
    the ring's data axis; ``stage_mesh``). bits=0: fp32 wire; 8/16:
    quantized. Returns (program, meta) with per-device memory."""
    from repro_torch.core import quantize
    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.parallel import stage_parallel as SP
    mesh = stage_mesh(multi_pod)
    grid = quantize.uniform_grid(bits, -2.0, 6.0) if bits else None
    cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=bits > 0,
                     quantize_q=bits > 0, grid=grid)
    t0 = time.time()
    rs = SP.record_step(mesh, L, n_classes, cfg, V=V, h=h, donate=True,
                        memory=True)
    t1 = time.time()
    program = rs.program
    n = mesh.size
    mem = _out_memory(program, (rs.carry, rs.args), rs.out)
    meta = {"trace_s": round(t1 - t0, 2), "lower_s": round(t1 - t0, 2),
            "compile_s": 0.0, "n_devices": n, "mesh": dict(mesh.shape),
            "n_params": L * h * h, "V": V, "h": h, "L": L,
            "wire_bits": bits,
            "memory": {k: v / n for k, v in mem.items()}}
    return program, meta


def _summary(stats: dict) -> str:
    mem = stats.get("memory", {})
    return (f"trace={stats['trace_s']}s "
            f"flops/dev={stats['flops_per_device']:.3e} "
            f"peak_bytes/dev={mem.get('peak_live_bytes', 0):.3e} "
            f"coll_moved={stats['collectives']['total']['moved_bytes']:.3e}")


def _error(e) -> dict:
    return {"status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def run_admm_cell(mesh_kind: str, bits: int, out_dir: Path, tag: str = ""):
    multi = mesh_kind == "multi"
    name = f"stage_v1m_b{bits or 32}{tag}"
    print(f"[RUN ] gamlp-admm x {name} x {mesh_kind} ...", flush=True)
    try:
        program, meta = lower_admm_cell(multi, bits=bits)
        stats = cell_stats(program, meta, meta["n_devices"])
        stats["status"] = "ok"
        print(f"   ok: {_summary(stats)}", flush=True)
    except Exception as e:
        stats = _error(e)
        print(f"   ERROR: {stats['error']}", flush=True)
    stats["arch"], stats["shape"], stats["mesh_kind"] = \
        "gamlp-admm", name, mesh_kind
    dest = out_dir / mesh_kind / "gamlp-admm"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{name}.json").write_text(json.dumps(stats, indent=1))
    return stats


def run_cell(arch: str, shape: str, mesh_kind: str, args) -> dict:
    multi = mesh_kind == "multi"
    try:
        program, meta = trace_cell(
            arch, shape, multi, moe_impl=args.moe_impl,
            attn_chunk=args.attn_chunk, donate=not args.no_donate,
            microbatches=args.microbatches)
        stats = cell_stats(program, meta, 512 if multi else 256)
        stats["status"] = "ok"
    except Exception as e:
        stats = _error(e)
    stats["arch"], stats["shape"], stats["mesh_kind"] = arch, shape, mesh_kind
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["einsum", "gather"])
    ap.add_argument("--attn-chunk", type=int, default=256)
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--admm", action="store_true",
                    help="run the stage-parallel pdADMM-G production cells")
    ap.add_argument("--admm-bits", type=int, default=None,
                    help="wire bits for --admm (0=fp32, 8, 16); default: all")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)

    archs = args.arch or (list(ARCH_IDS) if args.all else ["tinyllama-1.1b"])
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out)

    if args.admm:
        bit_list = [args.admm_bits] if args.admm_bits is not None else [0, 8]
        for mk in mesh_kinds:
            for bits in bit_list:
                run_admm_cell(mk, bits, out_dir, args.tag)
        return

    for arch in archs:
        cfg = get_arch(arch)
        for shape, skip in arch_shape_cells(cfg):
            if args.shape and shape.name not in args.shape:
                continue
            for mk in mesh_kinds:
                dest = out_dir / mk / arch
                dest.mkdir(parents=True, exist_ok=True)
                fname = dest / f"{shape.name}{args.tag}.json"
                if skip:
                    rec = {"status": "skip", "reason": skip, "arch": arch,
                           "shape": shape.name, "mesh_kind": mk}
                    print(f"[SKIP] {arch} x {shape.name} x {mk}: {skip}")
                else:
                    print(f"[RUN ] {arch} x {shape.name} x {mk} ...",
                          flush=True)
                    rec = run_cell(arch, shape.name, mk, args)
                    if rec["status"] == "ok":
                        print(f"   ok: {_summary(rec)}", flush=True)
                    else:
                        print(f"   ERROR: {rec['error']}", flush=True)
                fname.write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
