"""The port's transport (packed codes, quantized all-reduce, padded wire,
ring byte accounting) against the JAX reference, and its process-group ring
against its single-process ring.

* Packing: the plain ``pack_codes`` / ``unpack_codes`` equal the
  reference's ``ops.pack_codes`` byte for byte, on its jnp path and on its
  Pallas kernel in interpret mode (bits 4/8/16, odd and ragged n), the
  row-batched form packs each row as the flat form does, and strided row
  views (each row further off a 16-byte boundary) pack row by row as the
  reference's kernel does.
* Byte functions (``psum_mode``, ``psum_wire_bytes``, ``PaddedWire``,
  ``shard_rows``, ``wire_bytes_per_iteration``,
  ``container_wire_bytes_per_iteration``): equal to the reference's,
  ragged V included.
* The padded wire over a device widths table (one predicated launch per
  width): each shard's container and decoded slab equal the reference's
  ``PaddedWire.encode`` / ``decode`` of that slab at its stage's width
  (its ``lax.switch``) byte for byte, on three tables, one of which
  leaves a width unused; host integers give the same containers.
* ``quantized_psum`` on a ``LocalRing`` of data 2 and 4: gather equals
  code_psum bit for bit, and with deterministic rounding both equal the
  reference's jitted ``shard_map`` run (one subprocess with simulated
  devices, ``REFERENCE``). Stochastic rounding: unbiased under error
  feedback over 1000 rounds (the reference's own criterion).
* ``ProcessGroupRing`` (gloo, two processes spawned with a timeout): the
  stage ring at mesh (1, 2) agrees with ``LocalRing`` to rtol 1e-10 in f64
  from a state three iterations in (sums in another order), its ledger is
  equal, and its quantized psum is equal bit for bit.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jc
from repro.comm import transport as jt
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.parallel import stage_parallel as jsp
from repro_torch.comm import codecs as tc
from repro_torch.comm import transport as tt
from repro_torch.comm.ledger import CommLedger
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops
from repro_torch.parallel import stage_parallel as tsp
from repro_torch.parallel.ring import LocalRing, StageMesh

ROOT = Path(__file__).resolve().parents[1]

# --- packing ------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 17, 128, 1000, 2485, 3327])
def test_pack_unpack_plain_equals_reference_bytes(bits, n):
    rng = np.random.default_rng(bits * 10007 + n)
    codes = rng.integers(0, 2 ** bits, n)
    jdtype = jnp.uint8 if bits <= 8 else jnp.uint16
    want = [np.asarray(jops.pack_codes(jnp.asarray(codes, jdtype), bits,
                                       **kw))
            for kw in ({"use_pallas": False},
                       {"use_pallas": True, "interpret": True})]
    np.testing.assert_array_equal(want[0], want[1])
    tcodes = torch.from_numpy(codes.astype(np.int32)).to(
        tc._container_dtype(bits))
    got = ops.pack_codes(tcodes, bits)
    assert got.dtype == torch.uint8
    assert got.shape == (tc._body_bytes(bits, n),)
    np.testing.assert_array_equal(got.numpy(), want[0])
    back = ops.unpack_codes(got, bits, n)
    assert back.dtype == tcodes.dtype
    np.testing.assert_array_equal(back.to(torch.int32).numpy(), codes)
    # the reference's kernel unpacks the port's bytes
    np.testing.assert_array_equal(
        np.asarray(jops.unpack_codes(jnp.asarray(got.numpy()), bits, n,
                                     use_pallas=True, interpret=True)),
        codes)


@pytest.mark.parametrize("bits,n", [(4, 7), (4, 10), (8, 5), (16, 9)])
def test_row_batched_pack_packs_each_row(bits, n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 2 ** bits, (3, n))
                             .astype(np.int32)).to(tc._container_dtype(bits))
    packed = ops.pack_codes(codes, bits)
    for r in range(3):
        assert torch.equal(packed[r], ops.pack_codes(codes[r], bits))
    # unpack reads each row at its own stride (the head of a wider row)
    wide = torch.zeros((3, packed.shape[1] + 5), dtype=torch.uint8)
    wide[:, :packed.shape[1]] = packed
    assert torch.equal(ops.unpack_codes(wide, bits, n).to(torch.int32),
                       codes.to(torch.int32))


@pytest.mark.parametrize("bits", [4, 16])
@pytest.mark.parametrize("n", [17, 128])
@pytest.mark.parametrize("skew", [0, 1, 2, 3])
def test_strided_rows_pack_as_the_reference_kernel(bits, n, skew):
    """Row views of a wider buffer (``wide[:, :n]``) whose stride leaves
    each row ``skew`` codes further off a 16-byte boundary than the last,
    odd and even n: each packed row equals the reference's Pallas kernel
    (interpret mode) on that row."""
    rng = np.random.default_rng(bits * 131 + n * 7 + skew)
    per16 = 16 // (1 if bits <= 8 else 2)
    ld = (n + per16 - 1) // per16 * per16 + skew
    wide = torch.from_numpy(rng.integers(0, 2 ** bits, (3, ld))
                            .astype(np.int32)).to(tc._container_dtype(bits))
    codes = wide[:, :n]
    got = ops.pack_codes(codes, bits)
    assert got.shape == (3, tc._body_bytes(bits, n))
    jdtype = jnp.uint8 if bits <= 8 else jnp.uint16
    for r in range(3):
        want = jops.pack_codes(
            jnp.asarray(codes[r].to(torch.int32).numpy(), jdtype), bits,
            use_pallas=True, interpret=True)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


def test_codec_int4_payloads_go_through_the_dispatch(monkeypatch):
    calls = []
    real = ops.pack_codes
    monkeypatch.setattr(ops, "pack_codes",
                        lambda c, b: calls.append(b) or real(c, b))
    x = torch.linspace(-1, 1, 21).reshape(3, 7)
    for codec in (tc.GridCodec(tq.uniform_grid(4, -1.0, 1.0)),
                  tc.AffineCodec(4)):
        pj = jc.GridCodec(jq.uniform_grid(4, -1.0, 1.0)) \
            if isinstance(codec, tc.GridCodec) else jc.AffineCodec(4)
        got = codec.encode(x)
        want = jax.jit(pj.encode)(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
    assert calls == [4, 4]


# --- byte functions -----------------------------------------------------------

CODECS = {
    "fp32": (jc.FP32, tc.FP32),
    "grid4": (jc.GridCodec(jq.uniform_grid(4, 0, 1)),
              tc.GridCodec(tq.uniform_grid(4, 0, 1))),
    "grid8": (jc.GridCodec(jq.uniform_grid(8, -2, 6)),
              tc.GridCodec(tq.uniform_grid(8, -2, 6))),
    "int4": (jc.AffineCodec(4), tc.AffineCodec(4)),
    "int8": (jc.AffineCodec(8), tc.AffineCodec(8)),
    "int16": (jc.AffineCodec(16), tc.AffineCodec(16)),
}


def test_psum_mode_and_wire_bytes_equal_reference():
    for name, (cj, ct) in CODECS.items():
        for w in (1, 2, 3, 4, 7, 8, 15, 16):
            assert tt.psum_mode(ct, w) == jt.psum_mode(cj, w), (name, w)
            for mode in (None,) + jt.PSUM_MODES:
                for shape in ((100, 3), (2485, 1000), (7,)):
                    a = jt.psum_wire_bytes(cj, shape, w, mode)
                    b = tt.psum_wire_bytes(ct, shape, w, mode)
                    assert dataclass_tuple(a) == dataclass_tuple(b)
    lj, lt = _ledgers()
    for name, (cj, ct) in CODECS.items():
        jt.record_psum(lj, 0, name, cj, (100, 3), 4)
        tt.record_psum(lt, 0, name, ct, (100, 3), 4)
    assert lt.per_edge() == lj.per_edge()
    assert lt.per_edge_wire() == lj.per_edge_wire()
    with pytest.raises(ValueError):
        tt.psum_wire_bytes(ct, (4,), 2, mode="Gather")


def dataclass_tuple(c):
    return (c.mode, c.wire_bytes, c.logical_bytes, c.handshake_bytes)


def _ledgers():
    from repro.comm import CommLedger as JLedger
    return JLedger(), CommLedger()


def _fake_mesh(**shape):
    return types.SimpleNamespace(shape=shape)


GRIDS = {b: (jq.uniform_grid(b, -2.0, 6.0), tq.uniform_grid(b, -2.0, 6.0))
         for b in (4, 8, 16)}


@pytest.mark.parametrize("V", [128, 256, 2485, 2708, 3327])
@pytest.mark.parametrize("mesh_shape", [
    {"data": 1, "model": 4}, {"data": 2, "model": 4},
    {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2},
    {"data": 3, "model": 4}, {"data": 1, "model": 10},
])
def test_ring_byte_functions_equal_reference(V, mesh_shape):
    mesh = _fake_mesh(**mesh_shape)
    h, L = 64, 20
    n_st = mesh_shape["model"]
    dp = mesh_shape.get("pod", 1) * mesh_shape["data"]
    assert tsp.shard_rows(V, dp) == jsp.shard_rows(V, dp)
    for pn, qn in (("grid8", "grid4"), ("fp32", "fp32"), ("grid4", "int8")):
        a = jsp.wire_bytes_per_iteration(mesh, L, V, h, CODECS[pn][0],
                                         CODECS[qn][0])
        b = tsp.wire_bytes_per_iteration(mesh, L, V, h, CODECS[pn][1],
                                         CODECS[qn][1])
        assert a == b
    wj = jt.PaddedWire.from_grids({b: g[0] for b, g in GRIDS.items()})
    wt = tt.PaddedWire.from_grids({b: g[1] for b, g in GRIDS.items()})
    rng = np.random.default_rng(V)
    q_bits = [int(b) for b in rng.choice([4, 8, 16], n_st)]
    p_bits = [int(b) for b in rng.choice([4, 8, 16], n_st)]
    assert tsp.container_wire_bytes_per_iteration(
        mesh, L, V, h, wt, q_bits, p_bits) == \
        jsp.container_wire_bytes_per_iteration(mesh, L, V, h, wj, q_bits,
                                               p_bits)
    for r in tsp.shard_rows(V, dp):
        assert wt.capacity((1, r, h)) == wj.capacity((1, r, h))
        for bits in (4, 8, 16):
            assert wt.payload_bytes((1, r, h), bits) == \
                wj.payload_bytes((1, r, h), bits)
    assert wt.sel_of_bits(q_bits) == [int(i) for i in wj.sel_of_bits(q_bits)]
    lj, lt = _ledgers()
    jsp._record_container_iteration(lj, 0, mesh, L, V, h, wj, q_bits, p_bits)
    tsp._record_container_iteration(lt, 0, mesh, L, V, h, wt, q_bits, p_bits)
    jsp._record_container_qu_pair(lj, 1, mesh, L, V, h, wj, q_bits, "dropped")
    tsp._record_container_qu_pair(lt, 1, mesh, L, V, h, wt, q_bits, "dropped")
    for jl, tl in ((jsp, lj), (tsp, lt)):
        c = CODECS["grid8"][0 if jl is jsp else 1]
        f = CODECS["fp32"][0 if jl is jsp else 1]
        jl._record_ring_span(tl, 2, 3, mesh, L, V, h, c, f)
        jl._record_qu_pair(tl, 5, mesh, L, V, h, c, f, "inflight")
    assert [dataclass_rec(r) for r in lt.records] == \
        [dataclass_rec(r) for r in lj.records]


def dataclass_rec(r):
    return (r.iteration, r.edge, r.kind, r.elements, r.bits,
            r.payload_bytes, r.wire_bytes)


def test_padded_wire_round_trips_mixed_widths_per_stage():
    """One container per shard, each stage at its own width: decode(encode)
    is each grid's projection, and the container tail stays zero."""
    wire = tt.PaddedWire.from_grids({b: g[1] for b, g in GRIDS.items()})
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 3, 1, 5, 7), generator=g) * 8.0 - 2.0
    sel = [0, 2, 1]
    c = wire.encode(x, sel)
    assert c.shape == (2, 3, wire.capacity((1, 5, 7))) and c.dtype == torch.uint8
    y = wire.decode(c, sel, x.shape)
    for s, k in enumerate(sel):
        grid = wire.grids[k]
        assert torch.equal(y[:, s], grid.project(x[:, s]))
        nb = wire.payload_bytes((1, 5, 7), wire.widths[k])
        assert not c[:, s, nb:].any()


# one width index per stage of a ring of 4 (widths 4, 8, 16); "no_8bit"
# leaves a width of the wire unused
TABLES = {"mixed": [0, 2, 1, 0], "all_16bit": [2, 2, 2, 2],
          "no_8bit": [0, 2, 2, 0]}


@pytest.mark.parametrize("table", list(TABLES))
def test_padded_wire_over_a_device_table_equals_reference(table):
    wj = jt.PaddedWire.from_grids({b: g[0] for b, g in GRIDS.items()})
    wt = tt.PaddedWire.from_grids({b: g[1] for b, g in GRIDS.items()})
    sel = TABLES[table]
    rng = np.random.default_rng(len(table))
    # slabs [D, S, 1, V, h] with V * h odd; some values off the grid's ends
    x = (rng.random((2, 4, 1, 5, 7)) * 9.0 - 2.5).astype(np.float32)
    sel_t = torch.tensor(sel, dtype=torch.int32)
    c = wt.encode(torch.from_numpy(x), sel_t)
    y = wt.decode(c, sel_t, x.shape)
    assert c.shape == (2, 4, wt.capacity((1, 5, 7))) and y.shape == x.shape
    for d in range(2):
        for s, k in enumerate(sel):
            cj = np.asarray(wj.encode(jnp.asarray(x[d, s]), jnp.int32(k)))
            np.testing.assert_array_equal(c[d, s].numpy(), cj)
            yj = wj.decode(jnp.asarray(cj), jnp.int32(k), x[d, s].shape)
            np.testing.assert_array_equal(y[d, s].numpy(), np.asarray(yj))
    assert torch.equal(wt.encode(torch.from_numpy(x), sel), c)
    assert torch.equal(wt.decode(c, sel, x.shape), y)


# --- quantized psum -------------------------------------------------------------

PSUM_CODECS = {
    "grid4": ("GridCodec(uniform_grid(4, -3.0, 3.0))",
              tc.GridCodec(tq.uniform_grid(4, -3.0, 3.0))),
    "grid8": ("GridCodec(uniform_grid(8, -3.0, 3.0))",
              tc.GridCodec(tq.uniform_grid(8, -3.0, 3.0))),
    "int4": ("AffineCodec(4)", tc.AffineCodec(4)),
    "int8": ("AffineCodec(8)", tc.AffineCodec(8)),
    "int16": ("AffineCodec(16)", tc.AffineCodec(16)),
}
WORLDS = (2, 4)

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import compat_make_mesh
from repro.comm import transport
from repro.comm.codecs import AffineCodec, GridCodec
from repro.core.quantize import uniform_grid

out = {}
for w in %(WORLDS)r:
    mesh = compat_make_mesh((w,), ("data",), devices=jax.devices()[:w])
    rng = np.random.default_rng(w)
    x = (rng.standard_normal((w * 3, 17)) * 2.0).astype(np.float32)
    e = (rng.standard_normal((w * 3, 17)) * 0.1).astype(np.float32)
    out[f"x/{w}"], out[f"e/{w}"] = x, e
    for name, src in %(CODECS)r.items():
        codec = eval(src)
        def f(x, e):
            res = [transport.quantized_psum(x, "data", codec, mode=m)
                   for m in ("gather", "code_psum")]
            for m in ("gather", "code_psum"):
                res += list(transport.psum_with_error_feedback(
                    x, e, "data", codec, mode=m))
            return tuple(res)
        sm = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"),) * 6, check_rep=False))
        for i, r in enumerate(sm(jnp.asarray(x), jnp.asarray(e))):
            out[f"{name}/{w}/{i}"] = np.asarray(r)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % dict(WORLDS=WORLDS, CODECS={k: v[0] for k, v in PSUM_CODECS.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("psum_ref") / "reference.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _shards(x, w):
    """[w * 3, 17] rows over data shards -> the ring layout [w, 1, 3, 17]."""
    return torch.from_numpy(x).reshape(w, 1, -1, x.shape[-1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(PSUM_CODECS))
def test_quantized_psum_equals_jitted_reference(ref, name, world):
    codec = PSUM_CODECS[name][1]
    ring = LocalRing(StageMesh(world, 1), "cpu")
    x = _shards(ref[f"x/{world}"], world)
    e = _shards(ref[f"e/{world}"], world)
    got = [tt.quantized_psum(x, ring, "data", codec, mode=m)
           for m in ("gather", "code_psum")]
    for m in ("gather", "code_psum"):
        got += list(tt.psum_with_error_feedback(x, e, ring, "data", codec,
                                                mode=m))
    # the two physical collectives give the same bits
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[2], got[4]) and torch.equal(got[3], got[5])
    for i, g in enumerate(got):
        want = ref[f"{name}/{world}/{i}"].reshape(world, 1, -1, 17)
        np.testing.assert_array_equal(g.numpy(), want, err_msg=str(i))
    assert tt.psum_mode(codec, world) == ("gather" if world * codec.bits < 64
                                          else "code_psum")


def test_error_feedback_unbiased_with_stochastic_rounding():
    """1000 stochastic rounds on the gather path keep the cumulative mean
    within one round's quantization error of the exact sum, and tighter
    than half of it (the reference's criterion)."""
    ring = LocalRing(StageMesh(2, 1), "cpu")
    codec = tc.AffineCodec(4)
    for seed in (0, 1):
        g = torch.Generator().manual_seed(100 + seed)
        x = torch.randn((2, 1, 2, 64), generator=g) * 2.0
        exact = x.sum(dim=0, keepdim=True)
        gen = torch.Generator().manual_seed(seed)
        err = torch.zeros_like(x)
        sums = []
        for _ in range(1000):
            s, err = tt.psum_with_error_feedback(x, err, ring, "data", codec,
                                                 generator=gen, mode="gather")
            sums.append(s[:1])
        sums = torch.stack(sums)
        one_round = float((sums[0] - exact).abs().max())
        drift = float((sums.mean(0) - exact).abs().max())
        assert drift <= one_round + 1e-6, (seed, drift, one_round)
        assert drift < 0.5 * one_round, (seed, drift, one_round)


# --- the process-group ring (gloo) ---------------------------------------------

WORKER = r"""
import sys, json
sys.path.insert(0, "src")
import numpy as np, torch, torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
sys.path.insert(0, "tests")
from test_torch_transport import ring_problem
from repro_torch.comm import codecs as tc
from repro_torch.comm import transport as tt
from repro_torch.comm.ledger import CommLedger
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import ProcessGroupRing, StageMesh

res = {}
meta = {}
for name, (Xp, ds, cfg, warm) in ring_problem().items():
    ring = ProcessGroupRing(StageMesh(1, 2), "cpu")
    for overlap in (False, True):
        led = CommLedger()
        before = ring.shifted_bytes
        st, hist = SP.distributed_train(
            StageMesh(1, 2), None, Xp, ds.labels, ds.masks, 4, ds.n_classes,
            cfg, 3, init=warm, ring=ring, ledger=led, overlap=overlap)
        sent = torch.tensor([ring.shifted_bytes - before], dtype=torch.int64)
        dist.all_reduce(sent)
        for f in SP.StackState._fields:
            res[f"{name}/{int(overlap)}/{f}"] = getattr(st, f).numpy()
        meta[f"{name}/{int(overlap)}"] = {"objective": hist["objective"],
                                           "per_edge": led.per_edge(),
                                           "shifted_bytes": int(sent)}
ring = ProcessGroupRing(StageMesh(2, 1), "cpu")
x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1, 6, 11))
                     .astype(np.float32))[rank:rank + 1]
for bits in (4, 8, 16):
    codec = tc.AffineCodec(bits)
    res[f"psum/{bits}"] = tt.quantized_psum(x, ring, "data", codec,
                                            mode="gather").numpy()
if rank == 0:
    res["meta"] = np.array(json.dumps(meta))
    np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK")
"""


def ring_problem():
    """Two f64 problems at tiny size, each with a state three LocalRing
    iterations in (the forward-consistent init decides τ on rounding
    noise): G, and G-Q with a 4-bit wire."""
    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.graph.datasets import tiny
    ds = tiny(V=48, device="cpu")
    X = ds.augmented(2).double()
    g = torch.Generator().manual_seed(7)
    Xp = torch.relu(X @ (torch.randn(X.shape[1], 12, generator=g,
                                      dtype=torch.float64) / 8.0))
    out = {}
    for name, cfg in (
            ("G", ADMMConfig(nu=1e-2, rho=1.0, use_kernels=False)),
            ("GQ4", ADMMConfig(nu=1e-2, rho=1.0, use_kernels=False,
                               quantize_p=True, quantize_q=True,
                               grid=tq.uniform_grid(4, -1.0, 3.0)))):
        st = tsp.init_stack(1, Xp.float(), 4, cfg)
        st = tsp.StackState(*(x.double() for x in st))
        warm, _ = tsp.distributed_train(StageMesh(1, 2), None, Xp, ds.labels,
                                        ds.masks, 4, ds.n_classes, cfg, 3,
                                        init=st, ring=LocalRing(StageMesh(1, 2),
                                                                "cpu"))
        out[name] = (Xp, ds, cfg, warm)
    return out


def test_process_group_ring_agrees_with_local_ring(tmp_path):
    out = tmp_path / "pg.npz"
    init = tmp_path / "init"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(init), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0 and "WORKER_OK" in so, so[-2000:] + se[-3000:]
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    meta = json.loads(str(got["meta"]))
    for name, (Xp, ds, cfg, warm) in ring_problem().items():
        for overlap in (False, True):
            led = CommLedger()
            local = LocalRing(StageMesh(1, 2), "cpu")
            st, hist = tsp.distributed_train(
                StageMesh(1, 2), None, Xp, ds.labels, ds.masks, 4,
                ds.n_classes, cfg, 3, init=warm, ledger=led, overlap=overlap,
                ring=local)
            m = meta[f"{name}/{int(overlap)}"]
            np.testing.assert_allclose(m["objective"], hist["objective"],
                                       rtol=1e-10)
            assert m["per_edge"] == led.per_edge()
            # both ranks' sends together against the one process's (f64
            # here; test_torch_stage_parallel holds f32 runs to the ledger)
            assert m["shifted_bytes"] == local.shifted_bytes > 0
            for f in tsp.StackState._fields:
                np.testing.assert_allclose(
                    got[f"{name}/{int(overlap)}/{f}"],
                    getattr(st, f).numpy(), rtol=1e-10, atol=1e-12,
                    err_msg=f"{name} {f}")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1, 6, 11))
                         .astype(np.float32))
    ring = LocalRing(StageMesh(2, 1), "cpu")
    for bits in (4, 8, 16):
        want = tt.quantized_psum(x, ring, "data", tc.AffineCodec(bits),
                                 mode="gather")
        np.testing.assert_array_equal(got[f"psum/{bits}"], want[:1].numpy())


def test_collectives_facade_over_a_gradient_tree(ref):
    """``parallel.collectives`` is the affine transport: the same bits as
    ``transport`` (and so as the reference), over dicts and lists."""
    from repro_torch.parallel import collectives as tcol
    ring = LocalRing(StageMesh(2, 1), "cpu")
    x = _shards(ref["x/2"], 2)
    e = _shards(ref["e/2"], 2)
    assert torch.equal(tcol.quantized_psum(x, ring, "data", bits=8),
                       tt.quantized_psum(x, ring, "data", tc.AffineCodec(8)))
    s, ne = tcol.psum_with_error_feedback(x, e, ring, "data", bits=4)
    want = ref["int4/2/2"].reshape(2, 1, -1, 17)
    np.testing.assert_array_equal(s.numpy(), want)
    tree = {"W": x, "b": x[..., 0]}
    errs = {"W": torch.zeros_like(x), "b": torch.zeros_like(x[..., 0])}
    sums, new = tcol.compressed_grad_tree(tree, errs, ring, "data", bits=8)
    assert list(sums) == ["W", "b"] and list(new) == ["W", "b"]
    assert torch.equal(sums["W"], tcol.quantized_psum(x, ring, "data"))
    sums_l, _ = tcol.compressed_grad_tree([x], [errs["W"]], ring, "data")
    assert isinstance(sums_l, list) and torch.equal(sums_l[0], sums["W"])
