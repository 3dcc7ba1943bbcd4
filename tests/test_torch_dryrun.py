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

Held: (a) each cell's ``memory.argument_bytes`` equal to the reference's,
its per-device flops at a port/reference ratio in [0.9, 1.1], and a
gradient all-reduce or reduce-scatter in the train cells; both collective
totals are printed. (b) The ADMM cells' collective-permute moved bytes per
device equal to the reference's compiled HLO. (c) The 4-rank values within
an f32 relative L2 distance of 1e-5 of the plain port path (one process,
no mesh) and of the jitted reference. (d) The kv heads that a rank's
local q heads read (``layers.select_kv_heads``), on the plain route: each
rank's local attention equals its heads of the whole attention.
"""
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
TL.CONFIG = dataclasses.replace(TL.CONFIG.reduced(), remat=True)
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
print(json.dumps(out))
"""

PORT = r"""
import sys, json, dataclasses
sys.path.insert(0, "src")
import repro_torch.configs.tinyllama as TL
import repro_torch.configs.base as CB
TL.CONFIG = dataclasses.replace(TL.CONFIG.reduced(), remat=True)
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
print(json.dumps(out))
"""

WORKER = r"""
import sys, dataclasses
sys.path.insert(0, "src")
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import Shard
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

d = dict(np.load(data))
params_np = {}
for k, v in d.items():
    if k.startswith("p/"):
        node = params_np
        *path, leaf = k[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
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
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK")
"""


def _cfg():
    return get_arch("tinyllama-1.1b").reduced()


def _data():
    """Seeded numpy weights (the reference's init scales) and tokens."""
    rng = np.random.default_rng(0)
    tb = tapi.build(_cfg(), device="cpu", dtype=torch.float32)
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
    return d


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
    consts = (f"CELLS = {CELLS!r}\nADMM = {ADMM!r}\n"
              + inspect.getsource(key))
    # the port's cells in two processes: the (2, 2, 2) train cell alone
    # takes most of the time (DTensor's sharding search on three mesh dims)
    # and the rest a step down in priority
    procs = {"port": [_start(consts + PORT, json.dumps(CELLS[2:3]), "[]"),
                      _start(consts + PORT,
                             json.dumps(CELLS[:2] + CELLS[3:]), "[0, 8]",
                             nice=5)],
             "ref": _start(consts + REFERENCE, nice=5)}
    init, out = os.path.join(tmp, "pg"), os.path.join(tmp, "out.npz")
    procs["workers"] = [_start(WORKER, str(r), init, data, out, nice=5)
                        for r in range(4)]
    state = {"data": d, "out": out}
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


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS])
def test_cells_match_the_reference(runs, cell):
    ref, port = _json(runs, "ref")[cell], _json(runs, "port")[cell]
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(cell, "flops port/ref", ratio, "trace s", port["trace_s"])
    print(" collectives port", port["collectives"]["total"])
    print(" collectives ref ", ref["collectives"]["total"])
    assert 0.9 <= ratio <= 1.1, (cell, ratio)
    for k in ("peak_live_bytes", "temp_bytes"):
        assert port["memory"][k] > 0
    if cell.startswith("train"):
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
    return plain_results(runs[1]["data"])


@pytest.fixture(scope="module")
def reference(runs):
    return reference_results(runs[1]["data"])


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
