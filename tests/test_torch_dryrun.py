"""The port's dry run (``launch.dryrun``) and the dense LM on DTensors
against the JAX reference.

Three subprocesses start together when the module's fixture first runs:

* ``REFERENCE``: the reference's mini cells of ``tests/test_dryrun_mini.py``
  (8 forced host devices, reduced tinyllama with ``remat=True``,
  ``train_4k`` and ``decode_32k`` at 64 × 4 on (2, 4), ``train_4k`` on
  (2, 2, 2)), plus ``train_4k`` on (2, 4) with FSDP rules (``embed`` over
  the data axis, as granite-8b and yi-9b shard), and its stage-parallel ADMM cell at V 4096, h 64, L 8 on
  (2, 4) with fp32 and 8-bit wires, lowered and compiled; their stats as
  JSON.
* ``PORT``: the same cells through the port's ``trace_cell`` in a fake
  world of 8 ranks, and its ``lower_admm_cell`` on ``StageMesh(2, 4)``.
* ``WORKER`` × 4: a gloo world of 4 on the CPU, a (2, 2) mesh: reduced
  tinyllama in f32 on DTensors (weights and tokens drawn with numpy from a
  seed, each rank keeping its shards): the loss, every gradient, one
  ``adamw`` step over 2 microbatches (the port splits each data shard's
  rows, the reference the batch in blocks: the same mean), a prefill of 10 tokens into a 24-row cache and 4 decode
  steps on it (the cache sharded by sequence over the model axis, so the
  steps write both shards), and the first step again on the prefill's
  layout (heads local: decode attention per rank under ``local_map``);
  then the loss, gradients, ``adamw`` step and prefill again under FSDP
  rules (``use_fsdp=True``: weights sharded over the data axis too, the
  gradients reduce-scattered onto them); all gathered whole on rank 0.

The MoE and VLM families ride in the same processes: ``REFERENCE`` and
``PORT`` also run the mini cells of ``FAMILY_CELLS`` (reduced granite-moe's
``train_4k`` and ``decode_32k`` and reduced qwen2-vl's ``train_4k`` on
(2, 4), the experts over the model axis; and granite-moe with 6 experts,
which 4 does not divide, so the experts' f is split instead, the layout
full-width granite-moe takes on (16, 16)), and each ``WORKER`` runs the
``FAMILIES`` after tinyllama on the same (2, 2) mesh: reduced granite-moe
with the einsum and the gather dispatch, reduced qwen2-vl (its prompt
text, a 2 × 2 image block at 3-D positions, then text) and granite-moe
with 3 experts (f split over the model axis) with both dispatches, each
with the same loss,
gradients, adamw step, prefill and decode steps, and the router's picks
of every call on every rank; and it checks that a mesh bundle of the SSM,
hybrid and audio families still raises (in this process, in a fake
world).

Held: (a) each cell's ``memory.argument_bytes`` equal to the reference's,
its per-device flops at a port/reference ratio in [0.9, 1.1] (or, for a
cell of ``FLOPS_OUTSIDE_BAND``, at the ratio recorded there, with the
reason read from the reference's HLO), and a gradient all-reduce or
reduce-scatter in the train cells; both collective totals are printed.
(b) The ADMM cells' collective-permute moved bytes per device equal to
the reference's compiled HLO. (c) The 4-rank values within
an f32 relative L2 distance of 1e-5 of the plain port path (one process,
no mesh) and of the jitted reference (the gather dispatch against the
reference's einsum, whose gather has faults the port does not copy), and
every rank's picks equal to the plain path's. (d) The kv heads that a rank's
local q heads read (``layers.select_kv_heads``), on the plain route: each
rank's local attention equals its heads of the whole attention.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as j_get_arch
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import api as japi
from repro.models import transformer as JT
from repro.train import optim as joptim
from repro.train.trainer import make_accum_train_step as j_accum_step
from repro_torch.configs.base import get_arch
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import common
from repro_torch.models import layers as TL
from repro_torch.models.interop import lm_params_from_numpy
from repro_torch.train import optim
from repro_torch.train.trainer import make_accum_train_step

ROOT = Path(__file__).resolve().parents[1]
# (shape, multi-pod, fsdp): fsdp None keeps the config's rules
CELLS = (("train_4k", False, None), ("decode_32k", False, None),
         ("train_4k", True, None), ("train_4k", False, True))


def key(shape, multi, fsdp):
    return f"{shape}/{int(multi)}" + ("/fsdp" if fsdp else "")

ADMM = dict(V=4096, h=64, L=8)
TRAIN = (4, 32)                     # batch, sequence
PROMPT, MAX_LEN, N_DECODE = 10, 24, 4
# the MoE and VLM mini cells: (arch, experts or None for the config's, shape)
FAMILY_CELLS = (("granite-moe-3b-a800m", None, "train_4k"),
                ("granite-moe-3b-a800m", None, "decode_32k"),
                ("qwen2-vl-7b", None, "train_4k"),
                ("granite-moe-3b-a800m", 6, "train_4k"))
CONFIG_MODULES = {"tinyllama-1.1b": "tinyllama",
                  "granite-moe-3b-a800m": "granite_moe",
                  "qwen2-vl-7b": "qwen2_vl"}


def fkey(arch, experts, shape):
    return f"{arch}{f'/E{experts}' if experts else ''}/{shape}/0"


def kv_contractions(hlo: str) -> list:
    """The sizes contracted by the dots that a compiled reference program
    (``hlo``, with its stack frames) attributes to the k and v projections
    of ``repro.models.transformer.block_forward``."""
    import inspect
    import math
    import re

    from repro.analysis import hlo as H
    from repro.models import transformer
    src, first = inspect.getsourcelines(transformer.block_forward)
    lines = {first + i for i, line in enumerate(src)
             if 'p["wk"]' in line or 'p["wv"]' in line}
    tab, sec = {}, None
    for line in hlo.splitlines():
        if line in ("FileNames", "FileLocations", "StackFrames"):
            sec = tab.setdefault(line, {})
        elif sec is not None and re.match(r"\d+ ", line):
            i, v = line.split(" ", 1)
            sec[i] = v
        else:
            sec = None

    def where(frame):
        loc = re.search(r"file_location_id=(\d+)", tab["StackFrames"][frame])
        m = re.search(r"file_name_id=(\d+) .*line=(\d+)",
                      tab["FileLocations"][loc[1]])
        return tab["FileNames"][m[1]].strip('"'), int(m[2])

    out = set()
    for comp in H._split_computations(hlo).values():
        for op in comp.ops:
            frame = re.search(r"stack_frame_id=(\d+)", op.line)
            if op.kind != "dot" or not frame:
                continue
            path, line = where(frame[1])
            if path.endswith("models/transformer.py") and line in lines:
                lhs = comp.symbols[H._OPERAND_RE.findall(op.args)[0]][0][1]
                dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                 op.line)[1]
                out.add(math.prod(lhs[int(i)] for i in dims.split(",")))
    return sorted(out)


def use_config(module, experts=None):
    """Set an arch's config module (of either package) to its reduced
    config with remat, with ``experts`` experts if given."""
    import dataclasses
    module.PUBLISHED = getattr(module, "PUBLISHED", module.CONFIG)
    cfg = dataclasses.replace(module.PUBLISHED.reduced(), remat=True)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    module.CONFIG = cfg


# the gloo world's families: name -> (arch, experts or None, dispatch,
# the data (and reference) of the family named)
FAMILIES = {"granite-moe": ("granite-moe-3b-a800m", None, "einsum",
                            "granite-moe"),
            "granite-moe-gather": ("granite-moe-3b-a800m", None, "gather",
                                   "granite-moe"),
            "qwen2-vl": ("qwen2-vl-7b", None, "einsum", "qwen2-vl"),
            "granite-moe-e3": ("granite-moe-3b-a800m", 3, "einsum",
                               "granite-moe-e3"),
            "granite-moe-e3-gather": ("granite-moe-3b-a800m", 3, "gather",
                                      "granite-moe-e3")}
# cells whose per-device flops ratio port/reference lies outside [0.9, 1.1],
# with the ratio measured: XLA leaves qwen2-vl's k and v projections whole
# on every model rank (their forward dots contract all of d_model in the
# reference's HLO) where the port splits the contraction
# (``sharding.project``); why XLA splits them at tinyllama's head_dim 16
# and not at qwen2-vl's 32 is not known
FLOPS_OUTSIDE_BAND = {"qwen2-vl-7b/train_4k/0": 0.8684}
# VLM positions: the train rows' text, image block side, text; the prompt's
VLM_TRAIN, VLM_PROMPT = (8, 4), (3, 2)
STILL_UNMESHED = ("mamba2-130m", "jamba-v0.1-52b", "whisper-tiny")

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json, dataclasses
sys.path.insert(0, "src")
import repro.launch.mesh as M
M.make_production_mesh = lambda multi_pod=False: M._mk(
    (2, 2, 2) if multi_pod else (2, 4),
    ("pod", "data", "model") if multi_pod else ("data", "model"))
import repro.configs.tinyllama as TL
import repro.configs.base as CB
use_config(TL)
CB.SHAPES_BY_NAME = dict(CB.SHAPES_BY_NAME)
CB.SHAPES_BY_NAME["train_4k"] = CB.ShapeConfig("train_4k", 64, 4, "train")
CB.SHAPES_BY_NAME["decode_32k"] = CB.ShapeConfig("decode_32k", 64, 4, "decode")
import repro.launch.dryrun as D
D.SHAPES_BY_NAME = CB.SHAPES_BY_NAME
out = {}
for shape, multi, fsdp in CELLS:
    compiled, meta = D.lower_cell("tinyllama-1.1b", shape, multi, fsdp=fsdp)
    st = D.cell_stats(compiled, meta, 8)
    out[key(shape, multi, fsdp)] = {k: st[k] for k in
                                   ("flops_per_device", "memory",
                                    "collectives")}
for bits in (0, 8):
    compiled, meta = D.lower_admm_cell(False, bits=bits, **ADMM)
    out[f"admm/{bits}"] = D.cell_stats(compiled, meta, 8)["collectives"]
import importlib
for arch, experts, shape in FAMILY_CELLS:
    use_config(importlib.import_module("repro.configs." +
                                       CONFIG_MODULES[arch]), experts)
    compiled, meta = D.lower_cell(arch, shape, False)
    st = D.cell_stats(compiled, meta, 8)
    out[fkey(arch, experts, shape)] = {k: st[k] for k in
                                      ("flops_per_device", "memory",
                                       "collectives")}
    out[fkey(arch, experts, shape)]["kv_contract"] = kv_contractions(
        compiled.as_text())
print(json.dumps(out))
"""

PORT = r"""
import sys, json, dataclasses
sys.path.insert(0, "src")
import repro_torch.configs.tinyllama as TL
import repro_torch.configs.base as CB
use_config(TL)
CB.SHAPES_BY_NAME = dict(CB.SHAPES_BY_NAME)
CB.SHAPES_BY_NAME["train_4k"] = CB.ShapeConfig("train_4k", 64, 4, "train")
CB.SHAPES_BY_NAME["decode_32k"] = CB.ShapeConfig("decode_32k", 64, 4, "decode")
import repro_torch.launch.mesh as M
import repro_torch.launch.dryrun as D
from repro_torch.parallel.ring import StageMesh
D.SHAPES_BY_NAME = CB.SHAPES_BY_NAME
D.make_production_mesh = lambda multi_pod=False: M._mk(
    (2, 2, 2) if multi_pod else (2, 4),
    ("pod", "data", "model") if multi_pod else ("data", "model"))
D.fake_world = lambda n, _fw=M.fake_world: _fw(8)
D.stage_mesh = lambda multi_pod: StageMesh(2, 4)
out = {}
for shape, multi, fsdp in json.loads(sys.argv[1]):
    program, meta = D.trace_cell("tinyllama-1.1b", shape, multi, fsdp=fsdp)
    st = D.cell_stats(program, meta, 8)
    out[key(shape, multi, fsdp)] = {k: st[k] for k in
                                   ("flops_per_device", "memory",
                                    "collectives", "trace_s")}
for bits in json.loads(sys.argv[2]):
    program, meta = D.lower_admm_cell(False, bits=bits, **ADMM)
    out[f"admm/{bits}"] = D.cell_stats(program, meta, 8)["collectives"]
import importlib
for arch, experts, shape in json.loads(sys.argv[3]):
    use_config(importlib.import_module("repro_torch.configs." +
                                       CONFIG_MODULES[arch]), experts)
    program, meta = D.trace_cell(arch, shape, False)
    st = D.cell_stats(program, meta, 8)
    out[fkey(arch, experts, shape)] = {k: st[k] for k in
                                      ("flops_per_device", "memory",
                                       "collectives", "trace_s")}
print(json.dumps(out))
"""

WORKER = r"""
import sys, dataclasses, json
sys.path.insert(0, "src")
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import Shard
torch.set_num_threads(1)        # four ranks on a shared CPU
rank, init, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=4)
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import common
from repro_torch.models.api import build
from repro_torch.models.interop import lm_params_from_numpy
from repro_torch.parallel import sharding as sh
from repro_torch.train import optim
from repro_torch.train.trainer import make_accum_train_step

def unflatten(d):
    out = {}
    for k, v in d.items():
        if k.startswith("p/"):
            node = out
            *path, leaf = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out

d = dict(np.load(data))
params_np = unflatten(d)
cfg = get_arch("tinyllama-1.1b").reduced()
mesh = compat_make_mesh((2, 2), ("data", "model"), "cpu")
res = {}

def full(t):
    return t.full_tensor().numpy()

B, S = d["tokens"].shape
tb = build(cfg, mesh, ShapeConfig("t", S, B, "train"), dtype=torch.float32,
           attn_chunk=16)
params = tb.distribute(lm_params_from_numpy(params_np, device="cpu"),
                       tb.param_pspecs())
batch = tb.distribute({"tokens": torch.from_numpy(d["tokens"]),
                       "targets": torch.from_numpy(d["targets"])},
                      tb.input_pspecs(ShapeConfig("t", S, B, "train")))
loss, grads = steps.value_and_grad(tb, params, batch)
grads = steps.on_param_placements(grads, params)
res["loss"] = full(loss)
for path, g in common.leaves(grads):
    res["g/" + "/".join(path)] = full(g)
opt = optim.adamw(1e-3)
new, _, _ = make_accum_train_step(tb, opt, 2)(params, opt.init(params), batch)
for path, p in common.leaves(new):
    res["step/" + "/".join(path)] = full(p)

prompt = torch.from_numpy(d["prompt"])
Bp, T = prompt.shape[0], int(d["max_len"])
pb = build(cfg, mesh, ShapeConfig("p", T, Bp, "prefill"), dtype=torch.float32)
db = build(cfg, mesh, ShapeConfig("d", T, Bp, "decode"), dtype=torch.float32)
dshape = ShapeConfig("d", T, Bp, "decode")
logits, cache = pb.prefill(params, pb.distribute(
    {"tokens": prompt}, pb.input_pspecs(ShapeConfig("p", T, Bp, "prefill"))),
    max_len=T)
res["prefill"] = full(logits)
res["prefill_k"] = full(cache.k)
# one step on the prefill's layout (batch-sharded, heads local): decode
# attention per rank under local_map
def lay_out(tree, pspecs):
    return type(tree)(*(x.redistribute(mesh, sh.placements(mesh, s, x.ndim))
                        if hasattr(x, "redistribute") else x
                        for x, s in zip(tree, pspecs)))

kv = lay_out(cache, pb.serve_state_pspecs(ShapeConfig("p", T, Bp, "prefill")))
kv = kv._replace(k=kv.k.clone(), v=kv.v.clone())
logits, _ = pb.serve_step(params, kv, db.distribute(
    {"token": torch.from_numpy(d["decode"][0])}, db.input_pspecs(dshape)),
    length=prompt.shape[1])
res["decode_local"] = full(logits)
cache = lay_out(cache, db.serve_state_pspecs(dshape))
assert str(cache.k.placements) == "(Shard(dim=1), Shard(dim=2))", cache.k
for i, tok in enumerate(d["decode"]):
    batch = db.distribute({"token": torch.from_numpy(tok)},
                          db.input_pspecs(dshape))
    logits, cache = db.serve_step(params, cache, batch,
                                  length=prompt.shape[1] + i)
    res[f"decode/{i}"] = full(logits)
res["decode_k"] = full(cache.k)

# FSDP rules: every weight with an embed dim sharded over the data axis too
fcfg = dataclasses.replace(cfg, use_fsdp=True)
fb = build(fcfg, mesh, ShapeConfig("t", S, B, "train"), dtype=torch.float32,
           attn_chunk=16)
fparams = fb.distribute(lm_params_from_numpy(params_np, device="cpu"),
                        fb.param_pspecs())
flat = dict(common.leaves(fparams))
on_data = sum(isinstance(p.placements[0], Shard) for p in flat.values())
assert on_data >= 8, on_data
fbatch = fb.distribute({"tokens": torch.from_numpy(d["tokens"]),
                        "targets": torch.from_numpy(d["targets"])},
                       fb.input_pspecs(ShapeConfig("t", S, B, "train")))
loss, grads = steps.value_and_grad(fb, fparams, fbatch)
grads = steps.on_param_placements(grads, fparams)
res["fsdp/loss"] = full(loss)
for path, g in common.leaves(grads):
    assert g.placements == flat[path].placements, path
    res["fsdp/g/" + "/".join(path)] = full(g)
new, _, _ = make_accum_train_step(fb, opt, 2)(fparams, opt.init(fparams),
                                              fbatch)
for path, p in common.leaves(new):
    res["fsdp/step/" + "/".join(path)] = full(p)
fpb = build(fcfg, mesh, ShapeConfig("p", T, Bp, "prefill"),
            dtype=torch.float32)
logits, _ = fpb.prefill(fparams, fpb.distribute(
    {"tokens": prompt}, fpb.input_pspecs(ShapeConfig("p", T, Bp, "prefill"))),
    max_len=T)
res["fsdp/prefill"] = full(logits)
if rank == 0:
    np.savez(out, **res)

# the MoE and VLM families: loss, gradients, adamw step, prefill, decode,
# and each router call's picks on every rank (its rows' offset beside them)
from repro_torch.models import layers as L
from repro_torch.models.layers import _offset
picks, real_router = [], L._router

def router(x, w, k):
    out = real_router(x, w, k)
    idx = out[1]
    picks.append((_offset(idx, 0), idx.to_local().numpy()))
    return out

L._router = router
for name, (arch, experts, impl, fdata, fout) in json.loads(
        sys.argv[5]).items():
    d = dict(np.load(fdata))
    cfg = get_arch(arch).reduced()
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    vlm = "positions" in d
    B, S = d["tokens"].shape
    tshape = ShapeConfig("t", S, B, "train")
    tb = build(cfg, mesh, tshape, dtype=torch.float32, attn_chunk=16,
               moe_impl=impl)
    params = tb.distribute(lm_params_from_numpy(unflatten(d), device="cpu"),
                           tb.param_pspecs())
    keys = ["tokens", "targets"] + (["positions"] if vlm else [])
    batch = tb.distribute({k: torch.from_numpy(d[k]) for k in keys},
                          tb.input_pspecs(tshape))
    res, picks[:] = {}, []
    loss, grads = steps.value_and_grad(tb, params, batch)
    grads = steps.on_param_placements(grads, params)
    res["loss"] = full(loss)
    for path, g in common.leaves(grads):
        res["g/" + "/".join(path)] = full(g)
    new, _, _ = make_accum_train_step(tb, opt, 2)(params, opt.init(params),
                                                  batch)
    for path, p in common.leaves(new):
        res["step/" + "/".join(path)] = full(p)
    prompt = torch.from_numpy(d["prompt"])
    Bp, T = prompt.shape[0], int(d["max_len"])
    pshape = ShapeConfig("p", T, Bp, "prefill")
    dshape = ShapeConfig("d", T, Bp, "decode")
    pb = build(cfg, mesh, pshape, dtype=torch.float32, moe_impl=impl)
    db = build(cfg, mesh, dshape, dtype=torch.float32, moe_impl=impl)
    pbatch = {"tokens": prompt}
    if vlm:
        pbatch["positions"] = torch.from_numpy(d["prompt_positions"])
    n_train = len(picks)
    with torch.no_grad():
        logits, cache = pb.prefill(params, pb.distribute(
            pbatch, pb.input_pspecs(pshape)), max_len=T)
        res["prefill"] = full(logits)
        res["prefill_k"] = full(cache.k)
        cache = lay_out(cache, db.serve_state_pspecs(dshape))
        for i, tok in enumerate(d["decode"]):
            dbatch = {"token": torch.from_numpy(tok)}
            if vlm:
                dbatch["positions"] = torch.from_numpy(
                    d["decode_positions"][i])
            logits, cache = db.serve_step(params, cache, db.distribute(
                dbatch, db.input_pspecs(dshape)), length=prompt.shape[1] + i)
            res[f"decode/{i}"] = full(logits)
        res["decode_k"] = full(cache.k)
    # the loss's forward pass (the first n_layers calls) and the serving's
    serve = picks[n_train:]
    mine = {"train": picks[:cfg.n_layers], "serve": serve}
    every = [None] * 4
    dist.all_gather_object(every, mine)
    if rank == 0:
        for r, m in enumerate(every):
            for part, calls in m.items():
                for i, (off, idx) in enumerate(calls):
                    res[f"picks/{part}/{i}/r{r}"] = idx
                    res[f"picks/{part}/{i}/r{r}/offset"] = np.array(off)
        np.savez(fout, **res)
L._router = real_router
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK")
"""


def _cfg(arch="tinyllama-1.1b", experts=None):
    cfg = get_arch(arch).reduced()
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def vlm_positions(B, n_text, grid):
    """[B, 2·n_text + grid², 3] int32 t/h/w positions: text at t = h = w,
    a grid × grid image block at t = n_text, then text from n_text +
    grid."""
    text = np.arange(n_text)
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    image = np.stack([np.full(grid * grid, n_text), n_text + hh.ravel(),
                      n_text + ww.ravel()], -1)
    tail = (n_text + grid + text)[:, None].repeat(3, 1)
    pos = np.concatenate([text[:, None].repeat(3, 1), image, tail])
    return np.broadcast_to(pos, (B,) + pos.shape).astype(np.int32).copy()


def _data(cfg=None, seed=0):
    """Seeded numpy weights (the reference's init scales) and tokens; the
    VLM's 3-D positions: text, an image block, text."""
    cfg = cfg or _cfg()
    rng = np.random.default_rng(seed)
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32)
    d = {}
    for path, s in common.leaves(tb.param_specs()):
        if s.init in ("ones", "zeros"):
            x = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        else:
            scale = 0.02 if s.init == "small" else s.shape[-2] ** -0.5
            x = rng.standard_normal(s.shape) * scale
        d["p/" + "/".join(path)] = x.astype(np.float32)
    B, S = TRAIN
    d["tokens"] = rng.integers(0, 256, (B, S), dtype=np.int32)
    d["targets"] = rng.integers(0, 256, (B, S), dtype=np.int32)
    d["prompt"] = rng.integers(0, 256, (4, PROMPT), dtype=np.int32)
    d["decode"] = rng.integers(0, 256, (N_DECODE, 4, 1), dtype=np.int32)
    d["max_len"] = np.array(MAX_LEN)
    if cfg.mrope_sections is not None:
        d["positions"] = vlm_positions(B, *VLM_TRAIN)
        d["prompt_positions"] = vlm_positions(4, *VLM_PROMPT)
        nxt = d["prompt_positions"][:, -1:] + 1
        d["decode_positions"] = np.stack([nxt + i for i in range(N_DECODE)])
    return d


def _family_data():
    """Each family's data, by the name of the family whose data it uses."""
    out = {}
    for arch, experts, _, data in FAMILIES.values():
        if data not in out:
            out[data] = _data(_cfg(arch, experts), seed=1 + len(out))
    return out


def _params(d):
    out = {}
    for k, v in d.items():
        if k.startswith("p/"):
            node = out
            *path, leaf = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _start(code, *args, nice=0):
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            preexec_fn=(lambda: os.nice(nice)) if nice
                            else None)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference, the port's cells and the gloo world at once;
    the tests wait on what they read."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    data = os.path.join(tmp, "data.npz")
    d = _data()
    np.savez(data, **d)
    fdata = _family_data()
    for name, fd in fdata.items():
        np.savez(os.path.join(tmp, f"data_{name}.npz"), **fd)
    fams = {name: (arch, experts, impl,
                   os.path.join(tmp, f"data_{data_of}.npz"),
                   os.path.join(tmp, f"out_{name}.npz"))
            for name, (arch, experts, impl, data_of) in FAMILIES.items()}
    consts = (f"CELLS = {CELLS!r}\nADMM = {ADMM!r}\n"
              f"FAMILY_CELLS = {FAMILY_CELLS!r}\n"
              f"CONFIG_MODULES = {CONFIG_MODULES!r}\n"
              + inspect.getsource(key) + inspect.getsource(fkey)
              + inspect.getsource(use_config))
    ref_consts = consts + inspect.getsource(kv_contractions)
    # the port's cells in two processes: the (2, 2, 2) train cell alone
    # takes most of the time (DTensor's sharding search on three mesh dims)
    # and the rest a step down in priority
    procs = {"port": [_start(consts + PORT, json.dumps(CELLS[2:3]), "[]",
                             "[]"),
                      _start(consts + PORT,
                             json.dumps(CELLS[:2] + CELLS[3:]), "[0, 8]",
                             json.dumps(FAMILY_CELLS), nice=5)],
             "ref": _start(ref_consts + REFERENCE, nice=5)}
    init, out = os.path.join(tmp, "pg"), os.path.join(tmp, "out.npz")
    procs["workers"] = [_start(WORKER, str(r), init, data, out,
                               json.dumps(fams), nice=5)
                        for r in range(4)]
    state = {"data": d, "family_data": fdata, "out": out, "fams": fams}
    # the one-process results the gloo world is held to, while it runs
    state["plain"] = plain_results(d)
    state["reference"] = reference_results(d)
    state["family_plain"] = {
        name: family_plain_results(fdata[data], arch, experts, impl)
        for name, (arch, experts, impl, data) in FAMILIES.items()}
    state["family_reference"] = {
        data: family_reference_results(fdata[data], arch, experts)
        for arch, experts, impl, data in FAMILIES.values()
        if impl == "einsum"}
    yield procs, state
    for p in [procs["ref"]] + procs["port"] + procs["workers"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def _json(runs, key):
    procs, state = runs
    if key not in state:
        state[key] = {}
        for p in (procs[key] if key == "port" else [procs[key]]):
            state[key].update(json.loads(
                _finish(p).strip().splitlines()[-1]))
    return state[key]


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS]
                         + [fkey(*c) for c in FAMILY_CELLS])
def test_cells_match_the_reference(runs, cell):
    ref, port = _json(runs, "ref")[cell], _json(runs, "port")[cell]
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(cell, "flops port/ref", ratio, "trace s", port["trace_s"])
    print(" collectives port", port["collectives"]["total"])
    print(" collectives ref ", ref["collectives"]["total"])
    if "kv_contract" in ref:
        print(" the reference's k/v projection dots contract",
              ref["kv_contract"])
    if cell in FLOPS_OUTSIDE_BAND:
        assert round(ratio, 4) == FLOPS_OUTSIDE_BAND[cell], (cell, ratio)
        assert ref["kv_contract"] == [_cfg(cell.split("/")[0]).d_model]
    else:
        assert 0.9 <= ratio <= 1.1, (cell, ratio)
    for k in ("peak_live_bytes", "temp_bytes"):
        assert port["memory"][k] > 0
    if "train_4k" in cell:
        kinds = port["collectives"]["by_kind"]
        assert kinds.get("all-reduce", {}).get("count", 0) + \
            kinds.get("reduce-scatter", {}).get("count", 0) > 0
    if cell.endswith("fsdp"):       # the gradients land on data shards
        assert kinds.get("reduce-scatter", {}).get("count", 0) > 0


@pytest.mark.parametrize("bits", [0, 8])
def test_admm_cell_permute_bytes_equal_the_reference_hlo(runs, bits):
    ref = _json(runs, "ref")[f"admm/{bits}"]["by_kind"]
    port = _json(runs, "port")[f"admm/{bits}"]["by_kind"]
    want = ref["collective-permute"]["moved_bytes"]
    assert want > 0
    assert port["collective-permute"]["moved_bytes"] == want


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def gloo(runs):
    procs, state = runs
    for p in procs["workers"]:
        _finish(p)
    return dict(np.load(state["out"]))


@pytest.fixture(scope="module")
def plain(runs):
    return runs[1]["plain"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]["reference"]


def plain_results(d):
    """The worker's computations through the plain port path (no mesh)."""
    cfg = _cfg()
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32, attn_chunk=16)
    params = lm_params_from_numpy(_params(d), device="cpu")
    batch = {"tokens": torch.from_numpy(d["tokens"]),
             "targets": torch.from_numpy(d["targets"])}
    res = {}
    loss, grads = steps.value_and_grad(tb, params, batch)
    res["loss"] = loss.numpy()
    for path, g in common.leaves(grads):
        res["g/" + "/".join(path)] = g.numpy()
    opt = optim.adamw(1e-3)
    new, _, _ = make_accum_train_step(tb, opt, 2)(params, opt.init(params),
                                                  batch)
    for path, p in common.leaves(new):
        res["step/" + "/".join(path)] = p.numpy()
    with torch.no_grad():
        logits, cache = tb.prefill(params, {"tokens": torch.from_numpy(
            d["prompt"])}, max_len=MAX_LEN)
        res["prefill"], res["prefill_k"] = logits.numpy(), cache.k.numpy()
        res["prefill_k"] = res["prefill_k"].copy()   # decode writes the cache
        for i, tok in enumerate(d["decode"]):
            logits, cache = tb.serve_step(params, cache, {
                "token": torch.from_numpy(tok)}, length=PROMPT + i)
            res[f"decode/{i}"] = logits.numpy()
        res["decode_k"] = cache.k.numpy()
    res["decode_local"] = res["decode/0"]
    return res


def reference_results(d):
    """The worker's computations through the jitted reference."""
    jcfg = j_get_arch("tinyllama-1.1b").reduced()
    B, S = TRAIN
    jb = japi.build(jcfg, j_host_mesh(), JShape("t", S, B, "train"),
                    dtype=jnp.float32, attn_chunk=16)
    params = jax.tree.map(jnp.asarray, _params(d))
    batch = {"tokens": jnp.asarray(d["tokens"]),
             "targets": jnp.asarray(d["targets"])}
    res = {}
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(params, batch)
    res["loss"] = np.asarray(loss)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, g in flat:
        res["g/" + "/".join(k.key for k in path)] = np.asarray(g)
    opt = joptim.adamw(1e-3)
    new, _, _ = jax.jit(j_accum_step(jb, opt, 2))(params, opt.init(params),
                                                  batch)
    for path, p in jax.tree_util.tree_flatten_with_path(new)[0]:
        res["step/" + "/".join(k.key for k in path)] = np.asarray(p)
    logits, cache = jax.jit(lambda p, t: jb.prefill(p, {"tokens": t},
                                                    MAX_LEN))(
        params, jnp.asarray(d["prompt"]))
    res["prefill"], res["prefill_k"] = np.asarray(logits), np.asarray(cache.k)
    step = jax.jit(lambda p, c, t: JT.decode_step(jcfg, jb.mesh, jb.rules, p,
                                                  c, {"token": t}))
    for i, tok in enumerate(d["decode"]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        res[f"decode/{i}"] = np.asarray(logits)
    res["decode_k"] = np.asarray(cache.k)
    res["decode_local"] = res["decode/0"]
    return res


def test_four_rank_mesh_matches_plain_and_reference(gloo, plain, reference):
    """Loss, every gradient, one adamw step, prefill logits and cache and 4
    decode steps on a (2, 2) gloo mesh, and the loss, gradients, step and
    prefill again under FSDP rules (``fsdp/``): f32 relative L2 ≤ 1e-5 of
    the plain port path and of the jitted reference."""
    fsdp = {k for k in gloo if k.startswith("fsdp/")}
    assert set(gloo) - fsdp == set(plain)
    assert {k.removeprefix("fsdp/") for k in fsdp} == \
        {"loss", "prefill"} | {k for k in plain
                               if k.startswith(("g/", "step/"))}
    assert {k for k in gloo if k.startswith(("g/", "step/"))} == \
        {k for k in reference if k.startswith(("g/", "step/"))}
    for k in sorted(gloo):
        want = k.removeprefix("fsdp/")
        assert gloo[k].shape == plain[want].shape, k
        assert _rel(gloo[k], plain[want]) <= 1e-5, \
            (k, _rel(gloo[k], plain[want]))
        assert _rel(gloo[k], reference[want]) <= 1e-5, \
            (k, _rel(gloo[k], reference[want]))


class _Picks:
    """Records each call's picks of ``models.layers._router`` (the MoE's
    router) in the list it yields."""

    def __enter__(self):
        self.real, self.picks = TL._router, []

        def router(x, w, k):
            out = self.real(x, w, k)
            self.picks.append(out[1].numpy())
            return out
        TL._router = router
        return self.picks

    def __exit__(self, *exc):
        TL._router = self.real


def family_plain_results(d, arch, experts, impl):
    """A family's worker computations through the plain port path, and
    the picks of the loss's forward pass and of the serving's calls."""
    cfg = _cfg(arch, experts)
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32, attn_chunk=16,
                    moe_impl=impl)
    params = lm_params_from_numpy(_params(d), device="cpu")
    vlm = "positions" in d
    batch = {k: torch.from_numpy(d[k]) for k in
             ("tokens", "targets") + (("positions",) if vlm else ())}
    res = {}
    with _Picks() as train:
        loss, grads = steps.value_and_grad(tb, params, batch)
    res["loss"] = loss.numpy()
    for path, g in common.leaves(grads):
        res["g/" + "/".join(path)] = g.numpy()
    opt = optim.adamw(1e-3)
    new, _, _ = make_accum_train_step(tb, opt, 2)(params, opt.init(params),
                                                  batch)
    for path, p in common.leaves(new):
        res["step/" + "/".join(path)] = p.numpy()
    prompt = {"tokens": torch.from_numpy(d["prompt"])}
    if vlm:
        prompt["positions"] = torch.from_numpy(d["prompt_positions"])
    with torch.no_grad(), _Picks() as serve:
        logits, cache = tb.prefill(params, prompt, max_len=MAX_LEN)
        res["prefill"] = logits.numpy()
        res["prefill_k"] = cache.k.numpy().copy()  # decode writes the cache
        for i, tok in enumerate(d["decode"]):
            batch = {"token": torch.from_numpy(tok)}
            if vlm:
                batch["positions"] = torch.from_numpy(
                    d["decode_positions"][i])
            logits, cache = tb.serve_step(params, cache, batch,
                                          length=PROMPT + i)
            res[f"decode/{i}"] = logits.numpy()
        res["decode_k"] = cache.k.numpy()
    return res, {"train": train, "serve": serve}


def family_reference_results(d, arch, experts):
    """A family's worker computations through the jitted reference (the
    einsum dispatch: the reference's gather has faults the port does not
    copy, and it decodes MoE with the einsum only)."""
    jcfg = j_get_arch(arch).reduced()
    if experts:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=experts))
    B, S = TRAIN
    jb = japi.build(jcfg, j_host_mesh(), JShape("t", S, B, "train"),
                    dtype=jnp.float32, attn_chunk=16)
    params = jax.tree.map(jnp.asarray, _params(d))
    vlm = "positions" in d
    batch = {k: jnp.asarray(d[k]) for k in
             ("tokens", "targets") + (("positions",) if vlm else ())}
    res = {}
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(params, batch)
    res["loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res["g/" + "/".join(k.key for k in path)] = np.asarray(g)
    opt = joptim.adamw(1e-3)
    new, _, _ = jax.jit(j_accum_step(jb, opt, 2))(params, opt.init(params),
                                                  batch)
    for path, p in jax.tree_util.tree_flatten_with_path(new)[0]:
        res["step/" + "/".join(k.key for k in path)] = np.asarray(p)
    prompt = {"tokens": jnp.asarray(d["prompt"])}
    if vlm:
        prompt["positions"] = jnp.asarray(d["prompt_positions"])
    logits, cache = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(
        params, prompt)
    res["prefill"], res["prefill_k"] = np.asarray(logits), np.asarray(cache.k)
    step = jax.jit(lambda p, c, b: JT.decode_step(jcfg, jb.mesh, jb.rules, p,
                                                  c, b))
    for i, tok in enumerate(d["decode"]):
        batch = {"token": jnp.asarray(tok)}
        if vlm:
            batch["positions"] = jnp.asarray(d["decode_positions"][i])
        logits, cache = step(params, cache, batch)
        res[f"decode/{i}"] = np.asarray(logits)
    res["decode_k"] = np.asarray(cache.k)
    return res


@pytest.fixture(scope="module")
def family_gloo(runs):
    procs, state = runs
    for p in procs["workers"]:
        _finish(p)
    return {name: dict(np.load(f[4])) for name, f in state["fams"].items()}


@pytest.fixture(scope="module")
def family_plain(runs):
    return runs[1]["family_plain"]


@pytest.fixture(scope="module")
def family_reference(runs):
    return runs[1]["family_reference"]


@pytest.mark.parametrize("name", [n for n, f in FAMILIES.items()
                                  if f[0] != "qwen2-vl-7b"])
def test_four_rank_routes_equal_the_plain_path(family_gloo, family_plain,
                                               name):
    """Every router call's picks on every rank of the (2, 2) mesh (the
    loss's forward pass; the prefill and the decode steps) equal the
    plain path's rows they stand for."""
    got, (_, picks) = family_gloo[name], family_plain[name]
    for part, calls in picks.items():
        assert len(calls) == _cfg(*FAMILIES[name][:2]).n_layers * (
            1 if part == "train" else 1 + N_DECODE)
        assert f"picks/{part}/{len(calls)}/r0" not in got
        for i, want in enumerate(calls):
            for r in range(4):
                idx = got[f"picks/{part}/{i}/r{r}"]
                off = int(got[f"picks/{part}/{i}/r{r}/offset"])
                np.testing.assert_array_equal(idx, want[off:off + len(idx)],
                                              err_msg=f"{part} {i} r{r}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_four_rank_mesh_families_match_plain_and_reference(
        family_gloo, family_plain, family_reference, name):
    """Loss (aux included), every gradient, one adamw step over 2
    microbatches, the prefill's logits and K and 4 decode steps of an MoE
    or VLM family on the (2, 2) gloo mesh: f32 relative L2 ≤ 1e-5 of the
    plain port path and of the jitted reference (the gather dispatch
    against the reference's einsum)."""
    got = {k: v for k, v in family_gloo[name].items()
           if not k.startswith("picks/")}
    plain, ref = family_plain[name][0], family_reference[FAMILIES[name][3]]
    assert set(got) == set(plain) == set(ref)
    for k in sorted(got):
        assert got[k].shape == plain[k].shape, k
        assert _rel(got[k], plain[k]) <= 1e-5, (k, _rel(got[k], plain[k]))
        assert _rel(got[k], ref[k]) <= 1e-5, (k, _rel(got[k], ref[k]))


@pytest.mark.parametrize("arch", STILL_UNMESHED)
def test_other_families_still_raise_on_a_device_mesh(arch):
    """The SSM, hybrid and audio families keep raising on a DeviceMesh
    (their DTensor execution is the next slice), in a fake world of 4."""
    from repro_torch.launch.mesh import _mk, fake_world
    with fake_world(4):
        bundle = tapi.build(get_arch(arch).reduced(),
                            _mk((2, 2), ("data", "model")))
        with pytest.raises(NotImplementedError, match="Queue 1, item 1"):
            bundle.abstract_params()


@pytest.mark.parametrize("hq,hkv,model", [(8, 2, 4), (8, 4, 4), (12, 4, 3)])
def test_local_heads_read_their_kv_heads(hq, hkv, model):
    """Trap of GQA on a model axis: q heads sharded ``model`` ways, kv heads
    sharded alike when ``model`` divides them, else replicated. Each rank's
    local attention (``select_kv_heads`` then ``attention`` on the plain
    route) equals its q heads of the whole attention: (8, 2) on 4 is one
    kv head a rank, (8, 4) sharded kv, (12, 4) on 3 a run of q heads over
    two kv heads, which takes one kv head per q head."""
    g = torch.Generator().manual_seed(3)
    B, S, D = 2, 16, 8
    q = torch.randn(B, S, hq, D, generator=g)
    k = torch.randn(B, S, hkv, D, generator=g)
    v = torch.randn(B, S, hkv, D, generator=g)
    whole = TL.attention(q, k, v, causal=True, use_kernel=False)
    n_q = hq // model
    for c in range(model):
        kv_sharded = hkv % model == 0
        n_kv = hkv // model if kv_sharded else hkv
        kv_lo = c * n_kv if kv_sharded else 0
        kl, vl = (k[:, :, kv_lo:kv_lo + n_kv], v[:, :, kv_lo:kv_lo + n_kv])
        ks, vs = TL.select_kv_heads(kl, vl, c * n_q, n_q, kv_lo, hq // hkv)
        local = TL.attention(q[:, :, c * n_q:(c + 1) * n_q], ks, vs,
                             causal=True, use_kernel=False)
        torch.testing.assert_close(local, whole[:, :, c * n_q:(c + 1) * n_q],
                                   rtol=1e-6, atol=1e-6)
