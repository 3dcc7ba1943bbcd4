"""The port's fault tolerance (``comm.faults``, ``ckpt.manager``, the
sentinel ring step and its rollback loop) against the JAX reference's.

The reference's ring needs simulated devices, so it runs ONCE, in a
subprocess (``REFERENCE``) with 8 forced CPU devices, at mesh (2, 2) on the
reference's own fault-test problem (V = 32, h = 8, L = 4, 3 classes,
ν = ρ = 1, 3 FISTA steps; the data drawn with numpy so both packages read
the same), and writes an ``.npz``. Before it starts, the port writes a
checkpoint for it to restore (``port_ckpt``).

Exact (bitwise or equal): ``FaultPlan`` controls, events and traces;
checksum headers on f32, uint8, uint16 and packed-gather payloads; wire
verdicts per tick and edge; ``hist["faults"]`` and the ledger's fault
counts and physical bytes under chaos; checkpoint files written by either
package; inside the port, the zero-rate sentinel step against the plain
one, two runs of one plan, and a resumed run against an uninterrupted one.
Tolerances, as in ``test_torch_stage_parallel``: f32 with sums in another
order, states at atol 1e-4 + rtol 1e-3 and objectives at rtol 1e-3.

Bit positions are the port's own (``faults.flip_draws``; the reference's
come from ``jax.random``), so undetected corruption is held to the
reference by effect: a seeded sneaky plan rolls back and converges.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JManager
from repro.comm import faults as JF
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.comm import faults as F
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import LocalRing, StageMesh

ROOT = Path(__file__).resolve().parents[1]
V, H, L, C = 32, 8, 4, 3
N_STAGES, DP = 2, 2
CHAOS = dict(seed=3, flip_rate=0.1, drop_rate=0.05, delay_rate=0.05,
             blackouts=((1, 2, 2),))
WIRE = dict(seed=7, flip_rate=0.5, drop_rate=0.2)
# picked so that the port's own bit draw on this problem corrupts enough
# high exponent bits that the sentinels must roll back
SNEAKY = dict(seed=1, sneaky_rate=0.08, flips_per_event=6)

REFERENCE = r"""
import os, sys, json, shutil
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import compat_make_mesh
from repro.core.pdadmm import ADMMConfig
from repro.core.quantize import uniform_grid
from repro.parallel import stage_parallel as SP
from repro.comm import faults as F
from repro.comm.ledger import CommLedger
from repro.ckpt.manager import CheckpointManager

out_path, ckpt_dir, port_ckpt = sys.argv[1], sys.argv[2], sys.argv[3]
V, H, L, C = %(V)d, %(H)d, %(L)d, %(C)d
rng = np.random.default_rng(0)
Xp = jnp.asarray(rng.standard_normal((V, H)).astype(np.float32))
labels = jnp.asarray(rng.integers(0, C, V).astype(np.int32))
masks = {"train": jnp.ones((V,), jnp.float32)}
mesh = compat_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
cfgs = {"G": ADMMConfig(nu=1.0, rho=1.0, fista_iters=3),
        "GQ": ADMMConfig(nu=1.0, rho=1.0, fista_iters=3, quantize_p=True,
                         quantize_q=True, grid=uniform_grid(8, -4.0, 4.0))}
key = jax.random.PRNGKey(0)
out, meta = {}, {}
for cname in ("GQ", "G"):
    state = SP.init_stack(key, Xp, L, cfgs[cname])
    for i, f in enumerate(state._fields):
        out[f"init/{cname}/" + f] = np.asarray(state[i])

# one health step from the init, and the wire verdicts of a flip/drop plan
good = SP.make_sentinel_primer(mesh)(state.q, state.u, state.p)
step, _ = SP.make_distributed_step(mesh, L, C, cfgs["G"], health=True)
(s1, _), m1 = step((state, good), Xp, labels, masks["train"],
                   F.null_controls(2))
for i, f in enumerate(s1._fields):
    out["health/" + f] = np.asarray(s1[i])
h1 = jax.device_get(m1["health"])
meta["health"] = {"objective": float(m1["objective"]),
                  "residual": float(m1["residual"]),
                  "flags": {k: (np.asarray(v).tolist()) for k, v in h1.items()}}
plan = F.FaultPlan(**%(WIRE)r)
stepf, _ = SP.make_distributed_step(mesh, L, C, cfgs["G"], health=True,
                                    faults=plan)
meta["wire_bad"] = []
for tick in range(6):
    (sf, _), mf = stepf((state, good), Xp, labels, masks["train"],
                        plan.controls(tick, 2))
    meta["wire_bad"].append([int(x) for x in
                             jax.device_get(mf["health"])["wire_bad"]])
    if tick == 0:
        meta["wire_objective"] = float(mf["objective"])

# chaos runs: accounting, ledger
chaos = F.FaultPlan(**%(CHAOS)r)
for cname, overlaps in (("G", (False, True)), ("GQ", (False,))):
    for overlap in overlaps:
        led = CommLedger()
        _, hist = SP.distributed_train(mesh, key, Xp, labels, masks, L, C,
                                       cfgs[cname], 8, faults=chaos,
                                       overlap=overlap, ledger=led)
        f = hist["faults"]
        f["trace"] = [list(t) for t in f["trace"]]
        meta[f"chaos/{cname}/{int(overlap)}"] = {
            "objective": hist["objective"], "faults": f,
            "fault_counts": led.fault_counts(),
            "per_edge": led.per_edge(), "per_edge_wire": led.per_edge_wire(),
            "wire_bytes": led.total_wire_bytes()}

# a checkpoint written here, for the port to resume, and the resumed run
_, h4 = SP.distributed_train(mesh, key, Xp, labels, masks, L, C, cfgs["G"],
                             4, ckpt=ckpt_dir, ckpt_every=2)
shutil.copytree(ckpt_dir, ckpt_dir + "_resumed")
_, h6 = SP.distributed_train(mesh, key, Xp, labels, masks, L, C, cfgs["G"],
                             6, ckpt=ckpt_dir + "_resumed", ckpt_every=2,
                             resume=True)
meta["ckpt"] = {"objective_4": h4["objective"], "objective_46": h6["objective"]}

# the checkpoint the port wrote: restore it, then train on from it
restored, manifest = CheckpointManager(port_ckpt).restore(
    state, shardings=jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s),
        SP.stack_partition_specs(mesh)))
for i, f in enumerate(restored._fields):
    out["port_ckpt/" + f] = np.asarray(restored[i])
shutil.copytree(port_ckpt, port_ckpt + "_ref")
_, hp = SP.distributed_train(mesh, key, Xp, labels, masks, L, C, cfgs["G"],
                             6, ckpt=port_ckpt + "_ref", resume=True)
meta["port_ckpt"] = {"objective": hp["objective"],
                     "extra": manifest["extra"]}
out["meta"] = np.array(json.dumps(meta))
np.savez(out_path, **out)
print("REFERENCE_OK")
""" % dict(V=V, H=H, L=L, C=C, WIRE=WIRE, CHAOS=CHAOS)


def _problem():
    rng = np.random.default_rng(0)
    Xp = torch.from_numpy(rng.standard_normal((V, H)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, C, V).astype(np.int32))
    return Xp, labels, {"train": torch.ones(V)}


G_KW = dict(nu=1.0, rho=1.0, fista_iters=3)
CFGS = {"G": ADMMConfig(**G_KW),
        "GQ": ADMMConfig(**G_KW, quantize_p=True, quantize_q=True,
                         grid=uniform_grid(8, -4.0, 4.0))}


def _init(ref, cname="G"):
    return SP.StackState(*(torch.from_numpy(ref[f"init/{cname}/" + f])
                           for f in SP.StackState._fields))


def _train(ref, epochs, mesh=(2, 2), cname="G", **kw):
    Xp, labels, masks = _problem()
    kw.setdefault("init", _init(ref, cname))
    return SP.distributed_train(StageMesh(*mesh), None, Xp, labels, masks,
                                L, C, CFGS[cname], epochs, **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults_ref")
    # the port's checkpoint for the reference to restore: written first
    init = {}
    r = subprocess.run([sys.executable, "-c", _INIT_ONLY, str(tmp / "i.npz")],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "i.npz") as z:
        init = {k: z[k] for k in z.files}
    port_ckpt = tmp / "port_ckpt"
    _, h = _train(init, 4, ckpt=str(port_ckpt), ckpt_every=2)
    path = tmp / "reference.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                        str(tmp / "ref_ckpt"), str(port_ckpt)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(str(data["meta"]))
    data["tmp"] = tmp
    data["port_objective_4"] = h["objective"]
    return data


_INIT_ONLY = r"""
import sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.core.pdadmm import ADMMConfig
from repro.parallel import stage_parallel as SP
V, H, L, C = %(V)d, %(H)d, %(L)d, %(C)d
rng = np.random.default_rng(0)
Xp = jnp.asarray(rng.standard_normal((V, H)).astype(np.float32))
st = SP.init_stack(jax.random.PRNGKey(0), Xp, L,
                   ADMMConfig(nu=1.0, rho=1.0, fista_iters=3))
np.savez(sys.argv[1], **{"init/G/" + f: np.asarray(st[i])
                         for i, f in enumerate(st._fields)})
""" % dict(V=V, H=H, L=L, C=C)


# --- plans: host numpy on both sides, equal bit for bit -----------------------

PLANS = [dict(seed=5, flip_rate=0.2, sneaky_rate=0.2, drop_rate=0.2,
              delay_rate=0.2, blackouts=((1, 3, 2),)),
         dict(seed=9, flip_rate=0.15, drop_rate=0.15, sneaky_rate=0.1,
              delay_rate=0.1, flips_per_event=3),
         dict(seed=11, sneaky_rate=0.08, flips_per_event=6),
         dict(seed=2, drop_rate=0.3, blackouts=((0, 0, 3), (3, 5, 1))),
         dict(seed=4)]


@pytest.mark.parametrize("kw", PLANS, ids=[str(p["seed"]) for p in PLANS])
def test_fault_plan_controls_events_trace_equal_reference(kw):
    jp, tp = JF.FaultPlan(**kw), F.FaultPlan(**kw)
    assert tp.active == jp.active
    assert tp.trace(40, 4) == jp.trace(40, 4)
    for tick in range(12):
        cj = jp.controls(tick, 4, prev_obj=1.5)
        ct = tp.controls(tick, 4, prev_obj=1.5, device="cpu")
        for f in JF.FaultControls._fields:
            a, b = np.asarray(getattr(cj, f)), getattr(ct, f).numpy()
            assert a.shape == b.shape and np.array_equal(a.astype(b.dtype),
                                                         b), (tick, f)
        assert tp.events(tick, 4) == jp.events(tick, 4)
        # the port's flip draws: drawn where a flip or sneaky event is, and
        # nowhere else
        act = np.stack([ct.sneaky.numpy(), ct.flip.numpy()], -1) > 0
        drawn = (ct.draws.numpy() != 0).any(-1)
        assert np.array_equal(drawn, act)
    n = F.null_controls(4, seqno=3, prev_obj=2.0, device="cpu")
    j = JF.null_controls(4, seqno=3, prev_obj=2.0)
    for f in JF.FaultControls._fields:
        assert np.array_equal(np.asarray(getattr(j, f)).astype(np.int64)
                              if f == "key" else np.asarray(getattr(j, f)),
                              getattr(n, f).numpy()), f


# --- checksum headers: bit for bit -------------------------------------------

def _payloads():
    from repro.comm.codecs import AffineCodec as JAffine
    from repro.comm.codecs import GridCodec as JGrid
    from repro.core.quantize import uniform_grid as jgrid
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    yield "f32", x
    yield "u8", rng.integers(0, 256, (7, 33)).astype(np.uint8)
    yield "u16", rng.integers(0, 65536, (5, 41)).astype(np.uint16)
    yield "i32", rng.integers(-2 ** 31, 2 ** 31, (9, 9)).astype(np.int32)
    for bits in (4, 8, 16):      # codec payloads, int4 packed to bytes
        p = JGrid(jgrid(bits, -3.0, 3.0)).encode(jnp.asarray(x))
        yield f"grid{bits}", [np.asarray(t) for t in p if t is not None]
    p = JAffine(8).encode(jnp.asarray(x))
    yield "affine8", [np.asarray(t) for t in p if t is not None]


@pytest.mark.parametrize("name,payload", list(_payloads()),
                         ids=[n for n, _ in _payloads()])
def test_checksum_header_equals_reference(name, payload):
    leaves = payload if isinstance(payload, list) else [payload]
    jl = [jnp.asarray(a) for a in leaves]
    tl = [torch.from_numpy(a.copy()) for a in leaves]
    for seq in (0, 7, -1):
        want = np.array(JF.checksum_header(jl, seq))
        got = F.checksum_header(tl, seq).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), (seq,)
        assert bool(F.verify_header(tl, torch.from_numpy(want), seq))
        assert not bool(F.verify_header(tl, torch.from_numpy(want), seq + 1))


def test_checksum_covers_the_packed_gather_container():
    """The quantized psum's packed uint8 containers: the port's checksum
    equals the reference's on the same bytes, and every single-bit flip of
    the code body fails the verdict."""
    from repro.comm.codecs import GridCodec as JGrid
    from repro.core.quantize import uniform_grid as jgrid
    from repro_torch.comm.codecs import GridCodec
    x = np.random.default_rng(1).standard_normal((32, 8)).astype(np.float32)
    jp = JGrid(jgrid(4, -3.0, 3.0)).encode(jnp.asarray(x))
    tp = GridCodec(uniform_grid(4, -3.0, 3.0)).encode(torch.from_numpy(x))
    assert tp.codes.dtype == torch.uint8
    assert np.array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    hdr = F.checksum_header(tp, 0)
    assert np.array_equal(hdr.numpy(), np.asarray(JF.checksum_header(jp, 0)))
    nbits = tp.codes.numel() * 8
    for pos in np.random.default_rng(2).integers(0, nbits, 16):
        bad = F.flip_payload(tp, torch.tensor([int(pos)]), 1)
        assert not bool(F.verify_header(bad, hdr, 0)), pos
        assert (bad.codes != tp.codes).sum() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.uint16,
                                   torch.int32])
def test_flip_bits_identity_when_inactive_and_always_detected(dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 16, 8), generator=g) * 100).to(dtype) \
        if dtype != torch.uint16 else \
        torch.randint(0, 65536, (4, 16, 8), generator=g).to(torch.int32) \
        .to(torch.uint16)
    draws = torch.tensor(np.random.default_rng(0).integers(
        0, F.DRAW_RANGE, 3, dtype=np.int64))
    hdr = F.checksum_header(x, 4)
    same = F.flip_bits(x, draws, 0)
    assert torch.equal(same.view(torch.uint8), x.view(torch.uint8))
    width = 8 * x.element_size()
    for i in range(64):
        one = torch.tensor([int(np.random.default_rng(i).integers(
            0, F.DRAW_RANGE))])
        bad = F.flip_bits(x, one, 1)
        diff = (bad.view(torch.uint8) != x.view(torch.uint8)).sum()
        assert int(diff) == 1, i
        assert not bool(F.verify_header(bad, hdr, 4)), i
        # position = draw mod the payload's bits, little-endian words
        pos = int(one) % (x.numel() * width)
        word = x.reshape(-1)[pos // width:pos // width + 1]
        flipped = bad.reshape(-1)[pos // width:pos // width + 1]
        assert not torch.equal(word.view(torch.uint8),
                               flipped.view(torch.uint8))
    # two equal draws cancel: the same bits
    twice = F.flip_bits(x, torch.tensor([5, 5]), 1)
    assert torch.equal(twice.view(torch.uint8), x.view(torch.uint8))


def test_flip_draws_are_a_function_of_key_edge_stage_side():
    key = np.array([123, 456], np.uint32)
    act = np.zeros((3, 4), bool)
    act[1, 2] = True
    a = F.flip_draws(key, 3, act, np.zeros_like(act))
    b = F.flip_draws(key, 5, act, act)
    assert np.array_equal(a[1, 2, 0], b[1, 2, 0, :3])
    assert np.array_equal(b[1, 2, 1], np.random.default_rng(
        (123, 456, 1, 2, 1)).integers(0, F.DRAW_RANGE, 5, dtype=np.int64))
    assert not a[0].any() and not a[1, 2, 1].any()


# --- the sentinel step against the reference's --------------------------------

def test_health_step_matches_reference(ref):
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    Xp, labels, masks = _problem()
    data = [ring.to_local(x, "rows") for x in (Xp, labels, masks["train"])]
    st = SP.shard_stack(_init(ref), ring)
    good = SP.make_sentinel_primer(mesh, ring=ring)(st.q, st.u, st.p)
    step, _ = SP.make_distributed_step(mesh, L, C, CFGS["G"], health=True,
                                       ring=ring)
    (s1, _), m1 = step((st, good), *data,
                       F.null_controls(2, device="cpu"))
    want = ref["meta"]["health"]
    got = SP.gather_stack(s1, ring)
    for f in SP.StackState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   ref["health/" + f], rtol=1e-3, atol=1e-4,
                                   err_msg=f)
    np.testing.assert_allclose(float(m1["objective"]), want["objective"],
                               rtol=1e-3)
    for k, v in want["flags"].items():
        assert np.asarray(m1["health"][k]).tolist() == v, k
    # a flip/drop plan: the verdicts per tick and edge equal the reference's
    plan = F.FaultPlan(**WIRE)
    stepf, _ = SP.make_distributed_step(mesh, L, C, CFGS["G"], health=True,
                                        faults=plan, ring=ring)
    for tick, wb in enumerate(ref["meta"]["wire_bad"]):
        (sf, _), mf = stepf((st, good), *data,
                            plan.controls(tick, 2, device="cpu"))
        assert mf["health"]["wire_bad"].tolist() == wb, tick
        exp = {e: 0 for e in F.EDGES}
        for (e, _, kind) in plan.events(tick, 2):
            if kind in ("drop", "flip"):
                exp[e] += DP
        assert wb == [exp[e] for e in F.EDGES]
        if tick == 0:
            np.testing.assert_allclose(float(mf["objective"]),
                                       ref["meta"]["wire_objective"],
                                       rtol=1e-3)
    assert sum(map(sum, ref["meta"]["wire_bad"])) > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_zero_rate_sentinel_step_is_the_plain_step_bitwise(overlap):
    rng = np.random.default_rng(0)
    Xp, labels, masks = _problem()
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    data = [ring.to_local(x, "rows") for x in (Xp, labels, masks["train"])]
    st = SP.shard_stack(SP.init_stack(int(rng.integers(9)), Xp, L,
                                      CFGS["GQ"]), ring)
    plain, _ = SP.make_distributed_step(mesh, L, C, CFGS["GQ"],
                                        overlap=overlap, ring=ring)
    qc = SP.codec_for_grid(CFGS["GQ"].grid)
    fly0 = (SP.make_overlap_primer(mesh, qc, ring=ring)(st.q, st.u)
            if overlap else None)
    s0, m0 = plain((st, fly0) if overlap else st, *data)
    good = SP.make_sentinel_primer(mesh, qc, qc, ring=ring)(st.q, st.u, st.p)
    for kw, ctl in ((dict(health=True), F.null_controls(2, device="cpu")),
                    (dict(faults=F.FaultPlan(seed=7)),
                     F.FaultPlan(seed=7).controls(0, 2, device="cpu"))):
        step, _ = SP.make_distributed_step(mesh, L, C, CFGS["GQ"],
                                           overlap=overlap, ring=ring, **kw)
        if overlap:
            fly = SP.make_overlap_primer(mesh, qc, sentinel=True, ring=ring)(
                st.q, st.u, -1)
            ((s1, _), _), m1 = step(((st, good), fly), *data, ctl)
            s0_ = s0[0]
        else:
            (s1, _), m1 = step((st, good), *data, ctl)
            s0_ = s0
        for a, b in zip(s0_, s1):
            assert torch.equal(a, b), kw
        for k in ("objective", "residual", "stage_residuals"):
            assert torch.equal(m0[k], m1[k]), (kw, k)
        assert m1["health"]["wire_bad"].tolist() == [0, 0, 0]
        assert not bool(m1["health"]["objective_spike"])


@pytest.mark.parametrize("overlap", [False, True])
def test_sentinel_padded_wire_step(overlap):
    """The sentinel exchange over the padded-container wire (a width per
    stage, ``widths`` before the controls): zero-rate equals the plain
    container step bit for bit, and a flip/drop plan fails exactly one
    verdict per event and data shard."""
    from repro_torch.comm.transport import PaddedWire
    Xp, labels, masks = _problem()
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    data = [ring.to_local(x, "rows") for x in (Xp, labels, masks["train"])]
    st = SP.shard_stack(SP.init_stack(1, Xp, L, CFGS["G"]), ring)
    wire = PaddedWire.from_grids({b: uniform_grid(b, -4.0, 4.0)
                                  for b in (4, 8, 16)})
    widths = [wire.sel_of_bits([4, 16]), wire.sel_of_bits([8, 4])]
    plain, _ = SP.make_distributed_step(mesh, L, C, CFGS["G"], wire=wire,
                                        overlap=overlap, ring=ring)
    fly0 = (SP.make_overlap_primer(mesh, wire=wire, ring=ring)(
        st.q, st.u, widths) if overlap else None)
    s0, m0 = plain((st, fly0) if overlap else st, *data, widths)
    s0 = s0[0] if overlap else s0
    good = SP.make_sentinel_primer(mesh, wire=wire, ring=ring)(
        st.q, st.u, st.p, widths)

    def run(plan, tick):
        step, _ = SP.make_distributed_step(mesh, L, C, CFGS["G"], wire=wire,
                                           overlap=overlap, faults=plan,
                                           ring=ring)
        ctl = plan.controls(tick, 2, device="cpu")
        if overlap:
            fly = SP.make_overlap_primer(mesh, wire=wire, sentinel=True,
                                         ring=ring)(st.q, st.u, widths,
                                                    tick - 1)
            ((s1, _), _), m1 = step(((st, good), fly), *data, widths, ctl)
        else:
            (s1, _), m1 = step((st, good), *data, widths, ctl)
        return s1, m1

    s1, m1 = run(F.FaultPlan(seed=3), 0)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert torch.equal(m0["objective"], m1["objective"])
    plan = F.FaultPlan(**WIRE)
    hit = 0
    for tick in range(4):
        _, m = run(plan, tick)
        exp = {e: 0 for e in F.EDGES}
        for (e, _, kind) in plan.events(tick, 2):
            exp[e] += DP
        assert m["health"]["wire_bad"].tolist() == [exp[e] for e in F.EDGES]
        hit += sum(exp.values())
    assert hit > 0


def test_health_run_keeps_the_logical_ledger_and_adds_headers():
    """Trained: health=True gives the plain run's objectives and logical
    ledger, one step built, and exactly 3 edges x links x 8 B of headers
    per iteration on the physical ledger."""
    Xp, labels, masks = _problem()
    mesh = StageMesh(2, 2)
    init = SP.init_stack(0, Xp, L, CFGS["G"])
    runs = {}
    for kw in (dict(), dict(health=True)):
        led = CommLedger()
        _, h = SP.distributed_train(mesh, None, Xp, labels, masks, L, C,
                                    CFGS["G"], 6, init=init, ledger=led, **kw)
        runs[bool(kw)] = (h, led)
    (hp, lp), (hh, lh) = runs[False], runs[True]
    assert hh["objective"] == hp["objective"]
    assert hh["residual"] == hp["residual"]
    assert hh["n_compiled_steps"] == 1
    assert hh["faults"]["injected"] == hh["faults"]["detected"] == 0
    assert lh.per_edge() == lp.per_edge()
    hdr = 6 * 3 * N_STAGES * DP * F.SENTINEL_HEADER_BYTES
    assert lh.total_wire_bytes() == lp.total_wire_bytes() + hdr
    led = CommLedger()
    SP._record_sentinel_headers(led, 0, 6, mesh)
    assert led.total_wire_bytes() == hdr


@pytest.mark.parametrize("cname,overlap", [("G", False), ("G", True),
                                           ("GQ", False)])
def test_chaos_accounting_equals_reference_and_repeats(ref, cname, overlap):
    want = ref["meta"][f"chaos/{cname}/{int(overlap)}"]
    plan = F.FaultPlan(**CHAOS)
    runs = []
    for _ in range(2):
        led = CommLedger()
        st, h = _train(ref, 8, cname=cname, faults=plan, overlap=overlap,
                       ledger=led)
        runs.append((st, h, led))
    (sa, ha, la), (sb, hb, _) = runs
    f = dict(ha["faults"])
    f["trace"] = [list(t) for t in f["trace"]]
    assert f == want["faults"]
    assert f["injected"] > 0 and f["rolled_back"] == 0
    assert f["detected"] == f["recovered"] <= f["injected"]
    assert la.fault_counts() == want["fault_counts"]
    assert la.per_edge() == want["per_edge"]
    assert la.per_edge_wire() == want["per_edge_wire"]
    np.testing.assert_allclose(ha["objective"], want["objective"], rtol=1e-3)
    # the same plan twice: the same bits
    assert ha["objective"] == hb["objective"] and ha["faults"] == hb["faults"]
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    assert ha["n_compiled_steps"] == 1


def test_sneaky_plan_rolls_back_and_converges(ref, tmp_path):
    """Undetected corruption (the port's own bit draw) trips the sentinels,
    rolls back to a checkpoint and the run still converges near the clean
    one (not bitwise: the replayed tick meets fresh faults)."""
    _, clean = _train(ref, 10)
    led = CommLedger()
    _, h = _train(ref, 10, faults=F.FaultPlan(**SNEAKY), ckpt=str(tmp_path),
                  ckpt_every=2, ledger=led)
    f = h["faults"]
    assert f["rolled_back"] >= 1, f
    assert f["injected"] > 0 and f["detected"] == 0
    assert len(h["objective"]) == 10 and np.isfinite(h["objective"]).all()
    assert abs(h["objective"][-1] - clean["objective"][-1]) \
        < 0.25 * clean["objective"][-1]
    assert h["objective"][-1] < clean["objective"][0]
    assert led.fault_counts()["step"]["rolled_back"] == f["rolled_back"]
    # more rollbacks than allowed: persistent divergence raises
    with pytest.raises(RuntimeError, match="max_rollbacks"):
        _train(ref, 10, faults=F.FaultPlan(**SNEAKY),
               recovery=F.RecoveryConfig(max_rollbacks=0))


def test_resume_is_bitwise_an_uninterrupted_run(ref, tmp_path):
    """Mesh (1, 2) (one data shard, so the saved W is every shard's):
    4 iterations, a save, a fresh run resumed to 8 equals 8 iterations
    bit for bit, under a chaos plan whose tick the resume continues."""
    plan = F.FaultPlan(seed=4, flip_rate=0.2, blackouts=((1, 5, 2),))
    kw = dict(mesh=(1, 2), faults=plan, overlap=True)
    _, h4 = _train(ref, 4, ckpt=str(tmp_path), ckpt_every=4, **kw)
    sb, hb = _train(ref, 8, ckpt=str(tmp_path), resume=True, **kw)
    sc, hc = _train(ref, 8, **kw)
    assert h4["objective"] + hb["objective"] == hc["objective"]
    assert all(torch.equal(a, b) for a, b in zip(sb, sc))
    assert all(t >= 4 for (t, _, _, _) in hb["faults"]["trace"])
    assert hb["faults"]["trace"] == [t for t in hc["faults"]["trace"]
                                     if t[0] >= 4]


def test_elastic_restore_onto_another_mesh(ref, tmp_path):
    """A (2, 2) checkpoint restores onto (1, 2): the saved global stack
    (data shard 0's W and b) shards onto the new ring and trains on."""
    st, _ = _train(ref, 4, ckpt=str(tmp_path), ckpt_every=4)
    saved, manifest = CheckpointManager(str(tmp_path)).restore(like=st)
    assert manifest["extra"]["iteration"] == 4 and manifest["extra"]["tick"] \
        == 4
    for a, b in zip(saved, st):
        assert torch.equal(a, b)
    ring = LocalRing(StageMesh(1, 2), "cpu")
    local = SP.shard_stack(SP.StackState(*saved), ring)
    assert local.W.shape == (1, 2, 2, H, H)
    _, h = _train(ref, 7, mesh=(1, 2), ckpt=str(tmp_path), resume=True)
    assert len(h["objective"]) == 3 and np.isfinite(h["objective"]).all()


# --- checkpoints across the two packages ---------------------------------------

def test_reference_checkpoint_resumes_in_the_port(ref):
    """The reference saved at iterations 2 and 4; the port resumes its
    latest and reaches the reference's own iterations 4 and 5."""
    d = ref["tmp"] / "ref_ckpt"
    mgr = CheckpointManager(str(d))
    assert mgr.all_steps() == [2, 4]
    shutil.copytree(d, str(d) + "_port")
    _, h = SP.distributed_train(StageMesh(2, 2), 0, *_problem(), L, C,
                                CFGS["G"], 6, ckpt=str(d) + "_port",
                                resume=True)
    want = ref["meta"]["ckpt"]
    np.testing.assert_allclose(h["objective"], want["objective_46"],
                               rtol=1e-3)
    assert len(h["objective"]) == 2
    np.testing.assert_allclose(ref["port_objective_4"], want["objective_4"],
                               rtol=1e-3)


def test_port_checkpoint_restores_in_the_reference(ref):
    d = ref["tmp"] / "port_ckpt"
    restored, manifest = CheckpointManager(str(d)).restore(
        like=SP.StackState(*(torch.zeros(1),) * 6))
    for f in SP.StackState._fields:
        assert np.array_equal(ref["port_ckpt/" + f],
                              getattr(restored, f).numpy()), f
    want = ref["meta"]["port_ckpt"]
    assert want["extra"] == manifest["extra"]
    assert manifest["extra"]["iteration"] == 4
    shutil.copytree(d, str(d) + "_port")
    _, h = SP.distributed_train(StageMesh(2, 2), 0, *_problem(), L, C,
                                CFGS["G"], 6, ckpt=str(d) + "_port",
                                resume=True)
    np.testing.assert_allclose(h["objective"], want["objective"], rtol=1e-3)


def _tree(lib):
    """One structure of every kind the manager flattens, in ``lib``
    (``jnp`` or the port's torch)."""
    import collections
    Pt = collections.namedtuple("Pt", "a b")
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(0, 9, (5,)).astype(np.int32),
            np.float32(2.5), rng.standard_normal((2, 2)).astype(np.float32)]
    if lib == "jax":
        t = [jnp.asarray(a) for a in arrs]
        bf = jnp.asarray(arrs[0]).astype(jnp.bfloat16)
    else:
        t = [torch.from_numpy(np.array(a)) for a in arrs]
        bf = torch.from_numpy(arrs[0]).to(torch.bfloat16)
    return {"z": [t[0], Pt(t[1], None)], "a": (t[2], bf), "m": {"k": t[3]}}


def test_checkpoint_files_equal_the_references(tmp_path):
    jt, tt = _tree("jax"), _tree("torch")
    JManager(tmp_path / "j").save(3, jt, extra={"loss": 1.5})
    CheckpointManager(str(tmp_path / "t")).save(3, tt, extra={"loss": 1.5})
    dj, dt = tmp_path / "j" / "step_000000003", tmp_path / "t" / \
        "step_000000003"
    mj = json.loads((dj / "manifest.json").read_text())
    mt = json.loads((dt / "manifest.json").read_text())
    for k in ("step", "n_leaves", "shapes", "dtypes", "extra"):
        assert mt[k] == mj[k], k
    assert mt["dtypes"][1] == "bfloat16"
    assert sorted(p.name for p in dt.iterdir()) == \
        sorted(p.name for p in dj.iterdir())
    for i in range(mj["n_leaves"]):
        assert (dt / f"leaf_{i:05d}.npy").read_bytes() == \
            (dj / f"leaf_{i:05d}.npy").read_bytes(), i
    # each package restores the other's
    back, _ = CheckpointManager(str(tmp_path / "j")).restore(tt)
    for a, b in zip(jax.tree.leaves(jt), [back["a"][0], back["a"][1],
                                          back["m"]["k"], back["z"][0],
                                          back["z"][1].a]):
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              b.float().numpy())
    jback, _ = JManager(tmp_path / "t").restore(jt)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jt)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_ckpt_rotation_uncommitted_skip_and_tmp_sweep(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4), torch.zeros(2)]}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 5, 9):
        mgr.save(step, tree, extra={"loss": step * 1.0})
    assert mgr.all_steps() == [5, 9]          # keep=2 rotated step 1 out
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 9 and mgr.restore_extra() == {"loss": 9.0}
    assert all(torch.equal(restored["b"][i], tree["b"][i]) for i in (0, 1))
    # a torn write: a step directory without the _COMMITTED marker
    broken = tmp_path / "step_000000011"
    broken.mkdir()
    (broken / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 9
    # a torn save's staging litter is swept by the next manager
    litter = tmp_path / ".tmp_abc123"
    litter.mkdir()
    (litter / "leaf_00000.npy").write_bytes(b"torn")
    (tmp_path / ".tmp_stray").write_text("x")
    mgr2 = CheckpointManager(str(tmp_path), keep=2)
    assert not list(tmp_path.glob(".tmp_*"))
    assert mgr2.all_steps() == [5, 9]
    with pytest.raises(ValueError, match="leaves"):
        mgr2.restore({"a": tree["a"]})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


# --- the sentinel step on a process-group ring (gloo) --------------------------

# The workers import torch and the port only (the problem's constants and
# ``_problem`` are written into their code): no JAX, which they never use.
# A collective that hangs raises inside the worker after WORKER_HANG_S,
# with its traceback in the worker's log, before the parent's 240-s wait.
WORKER_HANG_S = 200
WORKER = r"""
import sys, json
from datetime import timedelta
sys.path.insert(0, "src")
import numpy as np, torch, torch.distributed as dist
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2, timeout=timedelta(seconds=WORKER_HANG_S))
from repro_torch.comm import faults as F
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import ProcessGroupRing, StageMesh
CFG = ADMMConfig(**G_KW)
Xp, labels, masks = _problem()
mesh = StageMesh(1, 2)
res = {}
init_st = SP.init_stack(0, Xp, L, CFG)
for overlap in (False, True):
    ring = ProcessGroupRing(mesh, "cpu")
    led = CommLedger()
    st, hist = SP.distributed_train(mesh, None, Xp, labels, masks, L, C,
                                    CFG, 6, init=init_st, ring=ring,
                                    ledger=led, overlap=overlap,
                                    faults=F.FaultPlan(**CHAOS))
    f = hist["faults"]
    f["trace"] = [list(t) for t in f["trace"]]
    res[str(int(overlap))] = {"objective": hist["objective"], "faults": f,
                              "per_edge_wire": led.per_edge_wire(),
                              "in_flight": len(ring.in_flight)}
try:
    SP.distributed_train(mesh, 0, Xp, labels, masks, L, C, CFG, 1,
                         ring=ProcessGroupRing(mesh, "cpu"), ckpt=out + ".d")
except NotImplementedError as e:
    res["ckpt_raises"] = str(e)
if rank == 0:
    with open(out, "w") as fh:
        json.dump(res, fh)
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK")
"""


def _worker_code() -> str:
    import inspect
    consts = (f"V, H, L, C = {V}, {H}, {L}, {C}\nCHAOS = {CHAOS!r}\n"
              f"G_KW = {G_KW!r}\nWORKER_HANG_S = {WORKER_HANG_S}\n")
    return consts + inspect.getsource(_problem) + WORKER


def test_sentinel_step_on_a_process_group_ring(tmp_path):
    out = tmp_path / "pg.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = _worker_code()
    # each worker's output goes to a file: a pipe that nobody reads while
    # the parent waits on the other worker could fill and stall the pair
    logs = [(tmp_path / f"w{r}.out", tmp_path / f"w{r}.err") for r in range(2)]
    procs = []
    for r, (so, se) in enumerate(logs):
        with open(so, "w") as fo, open(se, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(tmp_path / "init"),
                 str(out)], cwd=ROOT, env=env, stdout=fo, stderr=fe))
    try:
        for p in procs:
            try:
                p.wait(timeout=240)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        so, se = so.read_text(), se.read_text()
        assert p.returncode == 0 and "WORKER_OK" in so, (
            f"worker {r}: return code {p.returncode}\n" + so[-2000:]
            + se[-3000:])
    got = json.loads(out.read_text())
    assert "ROADMAP" in got["ckpt_raises"]
    Xp, labels, masks = _problem()
    init = SP.init_stack(0, Xp, L, CFGS["G"])
    for overlap in (False, True):
        led = CommLedger()
        _, h = SP.distributed_train(StageMesh(1, 2), None, Xp, labels, masks,
                                    L, C, CFGS["G"], 6, init=init,
                                    ledger=led, overlap=overlap,
                                    faults=F.FaultPlan(**CHAOS))
        want = got[str(int(overlap))]
        # every shift finished: under overlap the carried tail pair too
        assert want["in_flight"] == 0
        f = dict(h["faults"])
        f["trace"] = [list(t) for t in f["trace"]]
        assert want["faults"] == f
        assert want["per_edge_wire"] == led.per_edge_wire()
        np.testing.assert_allclose(want["objective"], h["objective"],
                                   rtol=1e-4)
