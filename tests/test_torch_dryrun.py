"""The port's dry run (``launch.dryrun``) and every LM family on DTensors
against the JAX reference.

The subprocesses start together when the module's fixture first runs:

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

The other families ride in the same processes: ``REFERENCE`` and
``PORT`` also run the mini cells of ``FAMILY_CELLS`` on (2, 4) (reduced
granite-moe's ``train_4k`` and ``decode_32k``, the experts over the model
axis, and with 6 experts, which 4 does not divide, so the experts' f is
split, the layout full-width granite-moe takes on (16, 16); reduced
qwen2-vl's ``train_4k``; reduced mamba2's ``train_4k`` and
``decode_32k``, its heads over the model axis, and at head_dim 64, whose
2 heads 4 does not divide, so d_inner is split by columns, the layout of
mamba2-130m on (16, 16); reduced whisper's two cells, and again at 6
heads, which 4 does not divide, so its projections' contraction is
split, the layout of whisper-tiny on (16, 16); jamba's ``decode_32k``),
and each ``WORKER`` runs the ``FAMILIES`` after
tinyllama on the same (2, 2) mesh: granite-moe with the einsum and the
gather dispatch, qwen2-vl (its prompt text, a 2 × 2 image block at 3-D
positions, then text), granite-moe with 3 experts (f split) with both
dispatches, mamba2 (8 heads, and 3 heads of 64 at expand 3: 1.5 heads a
rank), jamba with both dispatches and whisper (4 heads, and 3, which 2
does not divide), each with the same loss, gradients, adamw step (one
microbatch for mamba2, jamba and whisper), prefill and decode steps
(mamba2, jamba and whisper from the zero state, whose leaves are
compared), and the router's picks of every call on every rank. In this
process, while they run: the plain path and the jitted reference of the
same computations; ``serve_state_pspecs`` against the decode state's
tree for every arch, the SSD scan by columns, and jamba's decode under
FSDP rules with whole tokens, traced in a fake world.

Held: (a) each cell's ``memory.argument_bytes`` equal to the reference's,
its per-device flops at a port/reference ratio in [0.9, 1.1] (or, for a
cell of ``FLOPS_OUTSIDE_BAND``, at the ratio recorded there, with the
reason read from the reference's HLO), and a gradient all-reduce or
reduce-scatter in the train cells; both collective totals are printed.
(b) The ADMM cells' collective-permute moved bytes per device equal to
the reference's compiled HLO. (c) The 4-rank values within
an f32 relative L2 distance of 1e-5 of the plain port path (one process,
no mesh) and of the jitted reference (the gather dispatch against the
reference's einsum, whose gather has faults the port does not copy; the
reference's gradients of mamba2, jamba and whisper at 1e-4, and their
steps where the reference's gradient reaches ``STEP_GRAD_FLOOR``),
and every rank's picks equal to the plain path's. (d) The kv heads that a rank's
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
from repro.models import whisper as JW
from repro.train import optim as joptim
from repro.train.trainer import make_accum_train_step as j_accum_step
from repro_torch.configs.base import ARCH_IDS, ShapeConfig, get_arch
from repro_torch.launch import steps
from repro_torch.models import api as tapi
from repro_torch.models import common
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW
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
# the other families' mini cells: (arch, variant or None for the reduced
# config, shape); a variant (``variant_cfg``) "E<n>" sets n experts, "hd<n>"
# the SSM's head_dim, "H<n>" the heads. granite-moe at E6 (4 does not
# divide 6: the experts' f split), mamba2 at hd64 (2 heads on 4: the
# ``ssm_inner`` layout) and whisper at H6 (6 heads on 4: its projections'
# contraction split, ``sharding.project``) are the layouts granite-moe,
# mamba2-130m and whisper-tiny take at full width on (16, 16)
FAMILY_CELLS = (("granite-moe-3b-a800m", None, "train_4k"),
                ("granite-moe-3b-a800m", None, "decode_32k"),
                ("qwen2-vl-7b", None, "train_4k"),
                ("granite-moe-3b-a800m", "E6", "train_4k"),
                ("mamba2-130m", None, "train_4k"),
                ("mamba2-130m", None, "decode_32k"),
                ("mamba2-130m", "hd64", "train_4k"),
                ("mamba2-130m", "hd64", "decode_32k"),
                ("whisper-tiny", None, "train_4k"),
                ("whisper-tiny", None, "decode_32k"),
                ("whisper-tiny", "H6", "train_4k"),
                ("whisper-tiny", "H6", "decode_32k"),
                ("jamba-v0.1-52b", None, "decode_32k"))
CONFIG_MODULES = {"tinyllama-1.1b": "tinyllama",
                  "granite-moe-3b-a800m": "granite_moe",
                  "qwen2-vl-7b": "qwen2_vl",
                  "mamba2-130m": "mamba2_130m",
                  "whisper-tiny": "whisper_tiny",
                  "jamba-v0.1-52b": "jamba"}


def fkey(arch, variant, shape):
    return f"{arch}{f'/{variant}' if variant else ''}/{shape}/0"


def variant_cfg(cfg, variant):
    """``cfg`` (either package's) with the variant: "E<n>" n experts,
    "H<n>" n heads (q and kv), "hd<n>" the SSM's head_dim n, "x<e>hd<n>"
    its expand e too."""
    import dataclasses
    import re
    if not variant:
        return cfg
    m = re.fullmatch(r"E(\d+)|H(\d+)|(?:x(\d+))?hd(\d+)", variant)
    if m[1]:
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=int(m[1])))
    if m[2]:
        return dataclasses.replace(cfg, n_heads=int(m[2]),
                                   n_kv_heads=int(m[2]))
    ssm = dataclasses.replace(cfg.ssm, head_dim=int(m[4]))
    if m[3]:
        ssm = dataclasses.replace(ssm, expand=int(m[3]))
    return dataclasses.replace(cfg, ssm=ssm)


def n_routers(cfg):
    """The router calls of one forward pass: one an MoE layer."""
    if cfg.moe is None:
        return 0
    if cfg.hybrid_period:
        moe_at = [i for i in range(cfg.hybrid_period)
                  if i % cfg.moe.every == 1]
        return len(moe_at) * (cfg.n_layers // cfg.hybrid_period)
    return cfg.n_layers


def flat_state(tree, prefix="decode_state"):
    """A decode state's tensors by path (dict keys, tuple positions), the
    same keys for either package's state."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_state(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat_state(t, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


# the reference's projections whose dots' contracted sizes each family
# cell records: (module of ``repro.models``, function, the weights read)
PROJECTIONS = (("transformer", "block_forward", ("wk", "wv")),
               ("whisper", "_mha", ("wq", "wk", "wv", "wo")),
               ("whisper", "decode_step", ("wq", "wk", "wv", "wo")))


def contractions(hlo: str) -> dict:
    """The sizes contracted by the dots that a compiled reference program
    (``hlo``, with its stack frames) attributes to the lines of each of
    ``PROJECTIONS`` that read its weights, by "module.function"."""
    import importlib
    import inspect
    import math
    import re

    from repro.analysis import hlo as H
    lines = {}
    for mod, fn, weights in PROJECTIONS:
        src, first = inspect.getsourcelines(getattr(importlib.import_module(
            "repro.models." + mod), fn))
        for i, line in enumerate(src):
            if any(f'{w}"]' in line for w in weights):
                lines[(f"models/{mod}.py", first + i)] = f"{mod}.{fn}"
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

    out = {}
    for comp in H._split_computations(hlo).values():
        for op in comp.ops:
            frame = re.search(r"stack_frame_id=(\d+)", op.line)
            if op.kind != "dot" or not frame:
                continue
            path, line = where(frame[1])
            name = lines.get(("models/" + path.rsplit("models/", 1)[-1],
                              line))
            if name:
                lhs = comp.symbols[H._OPERAND_RE.findall(op.args)[0]][0][1]
                dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                 op.line)[1]
                out.setdefault(name, set()).add(
                    math.prod(lhs[int(i)] for i in dims.split(",")))
    return {k: sorted(v) for k, v in out.items()}


def use_config(module, variant=None):
    """Set an arch's config module (of either package) to its reduced
    config with remat, in ``variant`` (``variant_cfg``) if given."""
    import dataclasses
    module.PUBLISHED = getattr(module, "PUBLISHED", module.CONFIG)
    module.CONFIG = variant_cfg(dataclasses.replace(
        module.PUBLISHED.reduced(), remat=True), variant)


# the gloo world's families: name -> (arch, variant or None, dispatch,
# the data (and reference) of the family named). On (2, 2) mamba2's 8
# heads take the ``ssm_heads`` layout; its variant x3hd64 (3 heads of 64,
# d_inner 192) the ``ssm_inner`` layout, each rank 1.5 heads, as
# mamba2-130m's 24 heads on 16 ranks; whisper's variant H3 (3 heads, which
# 2 does not divide) its projections' split contraction, as whisper-tiny's
# 6 heads on 16
FAMILIES = {"granite-moe": ("granite-moe-3b-a800m", None, "einsum",
                            "granite-moe"),
            "granite-moe-gather": ("granite-moe-3b-a800m", None, "gather",
                                   "granite-moe"),
            "qwen2-vl": ("qwen2-vl-7b", None, "einsum", "qwen2-vl"),
            "granite-moe-e3": ("granite-moe-3b-a800m", "E3", "einsum",
                               "granite-moe-e3"),
            "granite-moe-e3-gather": ("granite-moe-3b-a800m", "E3", "gather",
                                      "granite-moe-e3"),
            "mamba2": ("mamba2-130m", None, "einsum", "mamba2"),
            "mamba2-x3hd64": ("mamba2-130m", "x3hd64", "einsum",
                              "mamba2-x3hd64"),
            "jamba": ("jamba-v0.1-52b", None, "einsum", "jamba"),
            "jamba-gather": ("jamba-v0.1-52b", None, "gather", "jamba"),
            "whisper": ("whisper-tiny", None, "einsum", "whisper"),
            "whisper-h3": ("whisper-tiny", "H3", "einsum", "whisper-h3")}
# the families whose prefill is the forward pass (no state) and whose
# decode starts from the zero state (whisper's cross K/V precomputed)
SEQ_FAMILIES = ("ssm", "hybrid", "audio")


def step_microbatches(cfg):
    """The adamw step's microbatches: 1 for ``SEQ_FAMILIES`` (the
    reference's step is then its adamw update of the gradients it already
    jitted, and compiles no second backward pass), else 2."""
    return 1 if cfg.family in SEQ_FAMILIES else 2


# Adam's first step moves an element by lr·g/(|g| + eps), here 1e-3·g/(|g|
# + 1e-8): near g = 0 it multiplies the gradient's rounding error by lr/eps
# = 1e5. ``SEQ_FAMILIES``' steps are compared on the elements whose
# reference gradient is at least STEP_GRAD_FLOOR = 30·eps in magnitude.
# Readings (the gloo world against the plain path, the worst leaf): with
# every element 2.6e-5 (jamba's A_log, an element of |g| 1.1e-9); from 3·eps
# 1.1e-5, 10·eps 3.6e-6, 30·eps 4.5e-7 (the reference: 4.1e-7). 30·eps
# leaves out 12,917 of jamba's 437,224 step elements (10,176 of them exact
# zeros: the embedding rows of tokens absent from the batch), 538 of
# mamba2's 72,432, 245 of whisper's 182,528
STEP_GRAD_FLOOR = 3e-7


# cells whose per-device flops ratio port/reference lies outside [0.9, 1.1]:
# (the ratio measured, the projections of ``PROJECTIONS`` read, the sizes
# their dots contract in the reference's HLO). XLA leaves qwen2-vl's k and
# v projections whole on every model rank (their dots contract all of
# d_model, 64) and whisper's at 6 heads on 4 (d_model 64 into q, k, v and
# H·hd 96 into the output) where the port splits the contraction
# (``sharding.project``); why XLA splits them at tinyllama's head_dim 16
# and not at qwen2-vl's 32 is not known
FLOPS_OUTSIDE_BAND = {
    "qwen2-vl-7b/train_4k/0": (0.8684, "transformer.block_forward", [64]),
    "whisper-tiny/H6/train_4k/0": (0.5145, "whisper._mha", [64, 96]),
    "whisper-tiny/H6/decode_32k/0": (0.5588, "whisper.decode_step",
                                     [64, 96])}
# VLM positions: the train rows' text, image block side, text; the prompt's
VLM_TRAIN, VLM_PROMPT = (8, 4), (3, 2)

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
for arch, variant, shape in FAMILY_CELLS:
    use_config(importlib.import_module("repro.configs." +
                                       CONFIG_MODULES[arch]), variant)
    compiled, meta = D.lower_cell(arch, shape, False)
    st = D.cell_stats(compiled, meta, 8)
    out[fkey(arch, variant, shape)] = {k: st[k] for k in
                                      ("flops_per_device", "memory",
                                       "collectives")}
    out[fkey(arch, variant, shape)]["contract"] = contractions(
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
for arch, variant, shape in json.loads(sys.argv[3]):
    use_config(importlib.import_module("repro_torch.configs." +
                                       CONFIG_MODULES[arch]), variant)
    program, meta = D.trace_cell(arch, shape, False)
    st = D.cell_stats(program, meta, 8)
    out[fkey(arch, variant, shape)] = {k: st[k] for k in
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

# the other families: loss, gradients, adamw step, prefill, decode, and
# each router call's picks on every rank (its rows' offset beside them)
from repro_torch.models import layers as L
from repro_torch.models import whisper
from repro_torch.models.layers import _offset
picks, real_router = [], L._router

def router(x, w, k):
    out = real_router(x, w, k)
    idx = out[1]
    picks.append((_offset(idx, 0), idx.to_local().numpy()))
    return out

L._router = router
for name, (arch, variant, impl, fdata, fout) in json.loads(
        sys.argv[5]).items():
    d = dict(np.load(fdata))
    cfg = variant_cfg(get_arch(arch).reduced(), variant)
    seq = cfg.family in SEQ_FAMILIES
    extra = [k for k in ("positions", "frames") if k in d]
    B, S = d["tokens"].shape
    tshape = ShapeConfig("t", S, B, "train")
    tb = build(cfg, mesh, tshape, dtype=torch.float32, attn_chunk=16,
               moe_impl=impl)
    params = tb.distribute(lm_params_from_numpy(unflatten(d), device="cpu"),
                           tb.param_pspecs())
    batch = tb.distribute({k: torch.from_numpy(d[k]) for k in
                           ["tokens", "targets"] + extra},
                          tb.input_pspecs(tshape))
    res, picks[:] = {}, []
    loss, grads = steps.value_and_grad(tb, params, batch)
    grads = steps.on_param_placements(grads, params)
    res["loss"] = full(loss)
    for path, g in common.leaves(grads):
        res["g/" + "/".join(path)] = full(g)
    new, _, _ = make_accum_train_step(tb, opt, step_microbatches(cfg))(
        params, opt.init(params), batch)
    for path, p in common.leaves(new):
        res["step/" + "/".join(path)] = full(p)
    prompt = torch.from_numpy(d["prompt"])
    Bp, T = prompt.shape[0], int(d["max_len"])
    pshape = ShapeConfig("p", T, Bp, "prefill")
    dshape = ShapeConfig("d", T, Bp, "decode")
    pb = build(cfg, mesh, pshape, dtype=torch.float32, moe_impl=impl)
    db = build(cfg, mesh, dshape, dtype=torch.float32, moe_impl=impl)
    pbatch = {"tokens": prompt}
    for k in extra:
        pbatch[k] = torch.from_numpy(d[f"prompt_{k}"])
    pbatch = pb.distribute(pbatch, pb.input_pspecs(pshape))
    n_train = len(picks)
    with torch.no_grad():
        logits, cache = pb.prefill(params, pbatch, max_len=T)
        res["prefill"] = full(logits)
        if seq:         # decode from the zero state, from position 0
            cache, start = db.serve_state_shape(dshape), 0
            if "frames" in extra:
                pspecs = db.serve_state_pspecs(dshape)
                for k, t in zip(("cross_k", "cross_v"),
                                whisper.precompute_cross(
                                    cfg, params, pbatch["frames"],
                                    rules=pb.rules)):
                    t = t.redistribute(mesh, sh.placements(
                        mesh, pspecs[k], t.ndim))
                    cache[k].to_local().copy_(t.to_local())
        else:
            res["prefill_k"] = full(cache.k)
            cache = lay_out(cache, db.serve_state_pspecs(dshape))
            start = prompt.shape[1]
        for i, tok in enumerate(d["decode"]):
            dbatch = {"token": torch.from_numpy(tok)}
            if "positions" in extra:
                dbatch["positions"] = torch.from_numpy(
                    d["decode_positions"][i])
            logits, cache = db.serve_step(params, cache, db.distribute(
                dbatch, db.input_pspecs(dshape)), length=start + i)
            res[f"decode/{i}"] = full(logits)
        if seq:
            res.update({k: full(t) for k, t in flat_state(cache).items()})
        else:
            res["decode_k"] = full(cache.k)
    # the loss's forward pass (its first router calls) and the serving's
    serve = picks[n_train:]
    mine = {"train": picks[:n_routers(cfg)], "serve": serve}
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


def _cfg(arch="tinyllama-1.1b", variant=None):
    return variant_cfg(get_arch(arch).reduced(), variant)


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
    if cfg.encoder_seq:
        d["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        d["prompt_frames"] = rng.standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        d["positions"] = vlm_positions(B, *VLM_TRAIN)
        d["prompt_positions"] = vlm_positions(4, *VLM_PROMPT)
        nxt = d["prompt_positions"][:, -1:] + 1
        d["decode_positions"] = np.stack([nxt + i for i in range(N_DECODE)])
    return d


def _family_data():
    """Each family's data, by the name of the family whose data it uses."""
    out = {}
    for arch, variant, _, data in FAMILIES.values():
        if data not in out:
            out[data] = _data(_cfg(arch, variant), seed=1 + len(out))
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
              + inspect.getsource(variant_cfg)
              + inspect.getsource(use_config))
    ref_consts = (consts + f"PROJECTIONS = {PROJECTIONS!r}\n"
                  + inspect.getsource(contractions))
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
    worker = (f"SEQ_FAMILIES = {SEQ_FAMILIES!r}\n"
              + inspect.getsource(step_microbatches)
              + inspect.getsource(variant_cfg) + inspect.getsource(n_routers)
              + inspect.getsource(flat_state) + WORKER)
    procs["workers"] = [_start(worker, str(r), init, data, out,
                               json.dumps(fams), nice=5)
                        for r in range(4)]
    state = {"data": d, "family_data": fdata, "out": out, "fams": fams}
    # the one-process results the gloo world is held to, while it runs, on
    # one torch thread (beside eight busy processes, more threads only spin)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state["plain"] = plain_results(d)
        state["reference"] = reference_results(d)
        state["family_plain"] = {
            name: family_plain_results(fdata[data], arch, variant, impl)
            for name, (arch, variant, impl, data) in FAMILIES.items()}
        state["family_reference"] = {
            data: family_reference_results(fdata[data], arch, variant)
            for arch, variant, impl, data in FAMILIES.values()
            if impl == "einsum"}
    finally:
        torch.set_num_threads(threads)
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
    if "contract" in ref:
        print(" the reference's projection dots contract", ref["contract"])
    if cell in FLOPS_OUTSIDE_BAND:
        want, where, sizes = FLOPS_OUTSIDE_BAND[cell]
        assert round(ratio, 4) == want, (cell, ratio)
        assert ref["contract"][where] == sizes, ref["contract"]
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


def family_plain_results(d, arch, variant, impl):
    """A family's worker computations through the plain port path, and
    the picks of the loss's forward pass and of the serving's calls."""
    cfg = _cfg(arch, variant)
    seq = cfg.family in SEQ_FAMILIES
    tb = tapi.build(cfg, device="cpu", dtype=torch.float32, attn_chunk=16,
                    moe_impl=impl)
    params = lm_params_from_numpy(_params(d), device="cpu")
    extra = [k for k in ("positions", "frames") if k in d]
    batch = {k: torch.from_numpy(d[k]) for k in
             ["tokens", "targets"] + extra}
    res = {}
    with _Picks() as train:
        loss, grads = steps.value_and_grad(tb, params, batch)
    res["loss"] = loss.numpy()
    for path, g in common.leaves(grads):
        res["g/" + "/".join(path)] = g.numpy()
    opt = optim.adamw(1e-3)
    new, _, _ = make_accum_train_step(tb, opt, step_microbatches(cfg))(
        params, opt.init(params), batch)
    for path, p in common.leaves(new):
        res["step/" + "/".join(path)] = p.numpy()
    prompt = {"tokens": torch.from_numpy(d["prompt"])}
    for k in extra:
        prompt[k] = torch.from_numpy(d[f"prompt_{k}"])
    with torch.no_grad(), _Picks() as serve:
        logits, cache = tb.prefill(params, prompt, max_len=MAX_LEN)
        res["prefill"] = logits.numpy()
        if seq:
            cache = tb.serve_state_shape(
                ShapeConfig("d", MAX_LEN, 4, "decode"))
            if "frames" in extra:
                cache["cross_k"], cache["cross_v"] = TW.precompute_cross(
                    cfg, params, prompt["frames"])
            start = 0
        else:
            res["prefill_k"] = cache.k.numpy().copy()  # decode writes it
            start = PROMPT
        for i, tok in enumerate(d["decode"]):
            batch = {"token": torch.from_numpy(tok)}
            if "positions" in extra:
                batch["positions"] = torch.from_numpy(
                    d["decode_positions"][i])
            logits, cache = tb.serve_step(params, cache, batch,
                                          length=start + i)
            res[f"decode/{i}"] = logits.numpy()
        if seq:
            res.update({k: t.numpy() for k, t in flat_state(cache).items()})
        else:
            res["decode_k"] = cache.k.numpy()
    return res, {"train": train, "serve": serve}


def family_reference_results(d, arch, variant):
    """A family's worker computations through the jitted reference (the
    einsum dispatch: the reference's gather has faults the port does not
    copy, and it decodes MoE with the einsum only)."""
    jcfg = variant_cfg(j_get_arch(arch).reduced(), variant)
    seq = jcfg.family in SEQ_FAMILIES
    B, S = TRAIN
    jb = japi.build(jcfg, j_host_mesh(), JShape("t", S, B, "train"),
                    dtype=jnp.float32, attn_chunk=16)
    params = jax.tree.map(jnp.asarray, _params(d))
    extra = [k for k in ("positions", "frames") if k in d]
    batch = {k: jnp.asarray(d[k]) for k in ["tokens", "targets"] + extra}
    res = {}
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(params, batch)
    res["loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res["g/" + "/".join(k.key for k in path)] = np.asarray(g)
    opt = joptim.adamw(1e-3)
    if step_microbatches(jcfg) == 1:    # j_accum_step's own 1-microbatch step
        new, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    else:
        new, _, _ = jax.jit(j_accum_step(jb, opt, 2))(
            params, opt.init(params), batch)
    for path, p in jax.tree_util.tree_flatten_with_path(new)[0]:
        res["step/" + "/".join(k.key for k in path)] = np.asarray(p)
    prompt = {"tokens": jnp.asarray(d["prompt"])}
    for k in extra:
        prompt[k] = jnp.asarray(d[f"prompt_{k}"])
    logits, cache = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(
        params, prompt)
    res["prefill"] = np.asarray(logits)
    if seq:
        cache = jb.serve_state_shape(JShape("d", MAX_LEN, 4, "decode"))
        if "frames" in extra:
            cache = dict(cache, **dict(zip(("cross_k", "cross_v"), jax.jit(
                lambda p, f: JW.precompute_cross(jcfg, jb.mesh, jb.rules, p,
                                                 f))(params,
                                                     prompt["frames"]))))
        # committed, as the step's outputs are: one compile, not two
        cache = jax.device_put(cache, jax.devices()[0])
        step = jax.jit(lambda p, c, b, n: jb.serve_step(p, c, b, length=n))
        start = 0
    else:
        res["prefill_k"] = np.asarray(cache.k)
        step = jax.jit(lambda p, c, b, n: JT.decode_step(
            jcfg, jb.mesh, jb.rules, p, c, b))
        start = PROMPT
    for i, tok in enumerate(d["decode"]):
        batch = {"token": jnp.asarray(tok)}
        if "positions" in extra:
            batch["positions"] = jnp.asarray(d["decode_positions"][i])
        logits, cache = step(params, cache, batch, jnp.int32(start + i))
        res[f"decode/{i}"] = np.asarray(logits)
    if seq:
        res.update({k: np.asarray(t) for k, t in flat_state(cache).items()})
    else:
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
                                  if _cfg(*f[:2]).moe is not None])
def test_four_rank_routes_equal_the_plain_path(family_gloo, family_plain,
                                               name):
    """Every router call's picks on every rank of the (2, 2) mesh (the
    loss's forward pass; the prefill and the decode steps) equal the
    plain path's rows they stand for."""
    got, (_, picks) = family_gloo[name], family_plain[name]
    for part, calls in picks.items():
        assert len(calls) == n_routers(_cfg(*FAMILIES[name][:2])) * (
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
    """Loss (aux included), every gradient, one adamw step (over
    ``step_microbatches``), the prefill's logits (and K for the
    transformer's families) and 4 decode steps (and the decode state for
    mamba2, jamba and whisper, which decode from the zero state) of a
    family on the (2, 2) gloo mesh: f32 relative L2 ≤ 1e-5 of the plain
    port path and of the jitted reference (the gather dispatch against the
    reference's einsum); against the reference the gradients of mamba2,
    jamba and whisper at 1e-4 a leaf, their family tests' tolerance; their
    steps on the elements whose reference gradient reaches
    ``STEP_GRAD_FLOOR``."""
    got = {k: v for k, v in family_gloo[name].items()
           if not k.startswith("picks/")}
    plain, ref = family_plain[name][0], family_reference[FAMILIES[name][3]]
    seq = _cfg(*FAMILIES[name][:2]).family in SEQ_FAMILIES
    assert set(got) == set(plain) == set(ref)
    for k in sorted(got):
        assert got[k].shape == plain[k].shape, k
        a, b, r = got[k], plain[k], ref[k]
        if seq and k.startswith("step/"):
            keep = np.abs(ref["g/" + k[len("step/"):]]) >= STEP_GRAD_FLOOR
            a, b, r = a[keep], b[keep], r[keep]
        assert _rel(a, b) <= 1e-5, (k, _rel(a, b))
        tol = 1e-4 if seq and k.startswith("g/") else 1e-5
        assert _rel(a, r) <= tol, (k, _rel(a, r))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_state_pspecs_have_the_state_tree(arch):
    """``serve_state_pspecs`` mirrors the decode state leaf for leaf, its
    node types (the ``SSMState`` and KV cache namedtuples) included, for
    every arch on the single production mesh's rules: ``serve_state_shape``
    on a mesh maps the two trees together."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.models.common import TensorSpec
    from repro_torch.parallel.sharding import PSpec
    shape = SHAPES_BY_NAME["decode_32k"]
    bundle = tapi.build(get_arch(arch), {"data": 16, "model": 16}, shape,
                        device="cpu")
    specs = pytree.tree_structure(bundle.serve_state_specs(shape),
                                  is_leaf=lambda x: isinstance(x, TensorSpec))
    pspecs = pytree.tree_structure(bundle.serve_state_pspecs(shape),
                                   is_leaf=lambda x: isinstance(x, PSpec))
    assert specs == pspecs, (specs, pspecs)


def test_moe_decode_under_fsdp_rules_with_replicated_tokens(monkeypatch):
    """jamba's decode at a batch that the data axis does not divide
    (``long_500k``'s single sequence), under its FSDP rules, traced in a
    fake world of 8 on (2, 4): the tokens stay whole on every rank, and the
    expert weights' embed dim, sharded over the data axis, is gathered
    before the experts run (it was kept sharded, and the einsum refused d
    at 256 of 4096 at full width on (16, 16))."""
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    cfg = dataclasses.replace(_cfg("jamba-v0.1-52b"), use_fsdp=True)
    shape = TShape("long", 128, 1, "decode")
    monkeypatch.setattr(D, "get_arch", lambda name: cfg)
    monkeypatch.setattr(D, "SHAPES_BY_NAME", {"long": shape})
    monkeypatch.setattr(D, "fake_world", lambda n: M.fake_world(8))
    monkeypatch.setattr(D, "make_production_mesh", lambda multi_pod=False:
                        M._mk((2, 4), ("data", "model")))
    program, meta = D.trace_cell("jamba-v0.1-52b", "long", False)
    st = D.cell_stats(program, meta, 8)
    assert st["flops_per_device"] > 0
    assert st["collectives"]["by_kind"]["all-gather"]["count"] > 0


@pytest.mark.parametrize("nh,hd,ranks", [(8, 16, 2), (2, 64, 4), (3, 64, 2),
                                         (24, 8, 16)])
def test_ssd_by_columns_equals_the_whole(nh, hd, ranks):
    """The SSD scan of each rank's columns of d_inner (``mamba2._segments``:
    whole heads, or parts of heads where a rank's columns start or end
    inside one) side by side equals the scan of all of them, forward and
    one decode step: 8 heads on 2 ranks (``ssm_heads``), 2 heads of 64 on 4
    (half a head a rank), 3 on 2 (1.5 heads a rank), 24 on 16 (mamba2-130m's
    heads on (16, 16), here of 8 columns)."""
    from repro_torch.models import mamba2 as TM
    g = torch.Generator().manual_seed(5)
    b, l, n, di = 2, 16, 4, nh * hd
    xs = torch.randn(b, l, di, generator=g)
    dt = torch.rand(b, l, nh, generator=g)
    A, D = -torch.rand(nh, generator=g), torch.randn(nh, generator=g)
    Bs, Cs = torch.randn(b, l, n, generator=g), torch.randn(b, l, n, generator=g)
    h = torch.randn(b, nh, hd, n, generator=g)
    whole = TM._ssd_local(xs, dt, A, D, Bs, Cs, hd, 8)
    hw, yw = TM._ssd_decode_local(h, xs[:, 0], dt[:, 0], A, D, Bs[:, 0],
                                  Cs[:, 0], hd)
    w = di // ranks
    for r in range(ranks):
        cols = slice(r * w, (r + 1) * w)
        got = TM._ssd_local(xs[..., cols], dt, A, D, Bs, Cs, hd, 8, r * w)
        torch.testing.assert_close(got, whole[..., cols], rtol=1e-6,
                                   atol=1e-6)
        hr, yr = TM._ssd_decode_local(h, xs[:, 0, cols], dt[:, 0], A, D,
                                      Bs[:, 0], Cs[:, 0], hd, r * w)
        torch.testing.assert_close(yr, yw[:, cols], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hr, hw.reshape(b, di, n)[:, cols],
                                   rtol=1e-6, atol=1e-6)


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
