"""The port's stage-parallel runtime against the JAX reference's.

The reference's ``distributed_train`` runs on a simulated multi-device CPU
mesh, which needs ``XLA_FLAGS`` before JAX starts: it runs ONCE, in a
subprocess (``REFERENCE``), at ``tiny(V=128)``, h = 32, L = 4, for meshes
(1, 4) and (2, 2), pdADMM-G and pdADMM-G-Q, 5 iterations, with and without
overlap, plus a mixed-width run and a per-epoch controller run. It writes
its inputs (the projected features, its initial stacks) and outputs to an
``.npz``; the port starts from the same stacks (``init=``) on a
``LocalRing`` on the CPU.

Tolerances: f32 on both sides with sums in another order — objectives at
rtol 1e-3, states at atol 1e-4 + rtol 1e-3 (G) over 5 iterations; ledger
bytes, schedules and the number of steps built are exact. Inside the port:
``overlap=True`` equals ``overlap=False`` bit for bit, ``donate=True``
writes into the storage passed in, and the bytes the ring's shifts move
equal the ledger's.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.comm.codecs import GridCodec
from repro_torch.comm.controller import (BitWidthController,
                                         ControllerConfig, stage_ring_edges)
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.pdadmm import ADMMConfig
from repro_torch.core.quantize import uniform_grid
from repro_torch.parallel import stage_parallel as SP
from repro_torch.parallel.ring import LocalRing, StageMesh

ROOT = Path(__file__).resolve().parents[1]
L, H, EPOCHS = 4, 32, 5
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
MIXED = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16, min_dwell=1,
             hysteresis=0.0, signal="per_edge", thresholds=((0.5, 4), (0.1, 8)))
UNIFORM_CTL = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16,
                   min_dwell=1, hysteresis=0.0, thresholds=((0.5, 4), (0.1, 8)))

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import compat_make_mesh
from repro.graph.datasets import tiny
from repro.core.pdadmm import ADMMConfig
from repro.core.quantize import uniform_grid
from repro.parallel import stage_parallel as SP
from repro.comm import CommLedger, BitWidthController, ControllerConfig
from repro.comm.controller import stage_ring_edges

L, H, EPOCHS = %(L)d, %(H)d, %(EPOCHS)d
ds = tiny(V=128)
X = np.asarray(ds.augmented(4))
P0 = (np.random.default_rng(0).standard_normal((X.shape[1], H))
      .astype(np.float32) * np.float32(np.sqrt(2.0 / X.shape[1])))
Xp = jnp.maximum(jnp.asarray(X) @ P0, 0)
key = jax.random.PRNGKey(0)
out = {"Xp": np.asarray(Xp), "labels": np.asarray(ds.labels),
       "train": np.asarray(ds.masks["train"])}
meta = {}
g8 = uniform_grid(8, -2.0, 6.0)
cfgs = {"G": ADMMConfig(nu=1e-2, rho=1.0),
        "GQ": ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                         grid=g8)}
for cname, cfg in cfgs.items():
    st0 = SP.init_stack(key, Xp, L, cfg)
    for i, f in enumerate(st0._fields):
        out[f"{cname}/init/{f}"] = np.asarray(st0[i])
    for mname, shape in %(MESHES)r.items():
        mesh = compat_make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        for overlap in (False, True):
            led = CommLedger()
            st, hist = SP.distributed_train(
                mesh, key, Xp, ds.labels, ds.masks, L, ds.n_classes, cfg,
                epochs=EPOCHS, ledger=led, overlap=overlap)
            tag = f"{cname}/{mname}/{int(overlap)}"
            meta[tag] = {"objective": hist["objective"],
                         "residual": hist["residual"],
                         "per_edge": led.per_edge(),
                         "per_edge_wire": led.per_edge_wire()}
            if overlap:
                continue
            for i, f in enumerate(st._fields):
                out[f"{tag}/{f}"] = np.asarray(st[i])
            devs = np.asarray(mesh.devices)
            shards = np.zeros((shape[0], shape[1], L // shape[1], H, H),
                              np.float32)
            for sh in st.W.addressable_shards:
                d, s = np.argwhere(devs == sh.device)[0]
                shards[d, s] = np.asarray(sh.data)
            out[f"{tag}/W_shards"] = shards

def mixed():
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    ctl = BitWidthController(stage_ring_edges(4, Xp.shape[0], H),
                             ControllerConfig(**%(MIXED)r))
    led = CommLedger()
    _, hist = SP.distributed_train(
        mesh, key, Xp, ds.labels, ds.masks, L, ds.n_classes, cfgs["G"],
        epochs=EPOCHS, controller=ctl, grids_by_bits=grids, ledger=led,
        mixed_width=True, overlap=True)
    meta["mixed"] = {"objective": hist["objective"],
                     "schedules": [list(s) for s in hist["schedules"]],
                     "n_compiled_steps": hist["n_compiled_steps"],
                     "per_edge": led.per_edge(),
                     "per_edge_wire": led.per_edge_wire(),
                     "n_switches": ctl.n_switches}
    ctl = BitWidthController([2 * Xp.shape[0] * H],
                             ControllerConfig(**%(UNIFORM_CTL)r))
    led = CommLedger()
    _, hist = SP.distributed_train(
        mesh, key, Xp, ds.labels, ds.masks, L, ds.n_classes, cfgs["G"],
        epochs=EPOCHS + 1, controller=ctl, grids_by_bits=grids, ledger=led,
        overlap=True)
    meta["uniform"] = {"objective": hist["objective"],
                       "schedules": [int(b) for b in hist["schedules"]],
                       "n_compiled_steps": hist["n_compiled_steps"],
                       "per_edge": led.per_edge()}

mixed()
out["meta"] = np.array(json.dumps(meta))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % dict(L=L, H=H, EPOCHS=EPOCHS, MESHES=MESHES, MIXED=MIXED,
           UNIFORM_CTL=UNIFORM_CTL)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("stage_ref") / "reference.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(str(data["meta"]))
    return data


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(ref):
    return (_t(ref["Xp"]), _t(ref["labels"]),
            {"train": _t(ref["train"])})


def _config(name):
    if name == "G":
        return ADMMConfig(nu=1e-2, rho=1.0)
    return ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                      grid=uniform_grid(8, -2.0, 6.0))


def _init(ref, cname):
    return SP.StackState(*(_t(ref[f"{cname}/init/{f}"])
                           for f in SP.StackState._fields))


def _train(ref, cname, mesh_shape, **kw):
    Xp, labels, masks = _inputs(ref)
    return SP.distributed_train(StageMesh(*mesh_shape), None, Xp, labels,
                                masks, L, 4, _config(cname), EPOCHS,
                                init=_init(ref, cname), **kw)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("cname", ["G", "GQ"])
def test_distributed_train_tracks_reference(ref, cname, mname):
    meta = ref["meta"]
    for overlap in (False, True):
        led = CommLedger()
        st, hist = _train(ref, cname, MESHES[mname], ledger=led,
                          overlap=overlap)
        want = meta[f"{cname}/{mname}/{int(overlap)}"]
        np.testing.assert_allclose(hist["objective"], want["objective"],
                                   rtol=1e-3)
        np.testing.assert_allclose(hist["residual"], want["residual"],
                                   rtol=1e-2, atol=1e-5)
        # the ring's bytes: exact, consumed and in flight alike
        assert led.per_edge() == want["per_edge"]
        assert led.per_edge_wire() == want["per_edge_wire"]
        assert hist["n_compiled_steps"] == 1
    if cname == "G":
        tag = f"{cname}/{mname}/0"
        for f in SP.StackState._fields:
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       ref[f"{tag}/{f}"], rtol=1e-3,
                                       atol=1e-4, err_msg=f)


def test_per_data_shard_weights_match_reference_devices(ref):
    """With data = 2 each data shard trains its own W (the reference's W/b
    updates reduce over local rows and nothing sums them); the port keeps
    one W per data shard, equal to the reference device's, and a host read
    of either side returns data shard 0's."""
    tag = "G/2x2/0"
    shards = ref[f"{tag}/W_shards"]                      # [D, S, m, h, h]
    # the reference's host read is data shard 0
    np.testing.assert_array_equal(ref[f"{tag}/W"],
                                  shards[0].reshape(L, H, H))
    assert not np.array_equal(shards[0], shards[1])
    Xp, labels, masks = _inputs(ref)
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    step, _ = SP.make_distributed_step(mesh, L, 4, _config("G"), ring=ring)
    st = SP.shard_stack(_init(ref, "G"), ring)
    data = [ring.to_local(x, "rows") for x in (Xp, labels, masks["train"])]
    for _ in range(EPOCHS):
        st, _ = step(st, *data)
    assert st.W.shape == (2, 2, 2, H, H)
    np.testing.assert_allclose(st.W.numpy(), shards, rtol=1e-3, atol=1e-4)
    drift = (st.W[0] - st.W[1]).abs().max()
    assert drift > 1e-4, drift
    np.testing.assert_array_equal(SP.gather_stack(st, ring).W.numpy(),
                                  st.W[0].reshape(L, H, H).numpy())


def test_mixed_width_matches_reference_schedules(ref):
    want = ref["meta"]["mixed"]
    Xp, labels, masks = _inputs(ref)
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    ctl = BitWidthController(stage_ring_edges(4, Xp.shape[0], H),
                             ControllerConfig(**MIXED))
    led = CommLedger()
    _, hist = SP.distributed_train(
        StageMesh(1, 4), None, Xp, labels, masks, L, 4, _config("G"),
        EPOCHS, controller=ctl, grids_by_bits=grids, ledger=led,
        mixed_width=True, overlap=True, init=_init(ref, "G"))
    assert hist["n_compiled_steps"] == want["n_compiled_steps"] == 1
    assert [list(s) for s in hist["schedules"]] == want["schedules"]
    assert len({tuple(s) for s in want["schedules"]}) > 1
    assert ctl.n_switches == want["n_switches"]
    assert led.per_edge() == want["per_edge"]
    assert led.per_edge_wire() == want["per_edge_wire"]
    np.testing.assert_allclose(hist["objective"], want["objective"],
                               rtol=1e-3)


def test_per_epoch_controller_matches_reference(ref):
    want = ref["meta"]["uniform"]
    Xp, labels, masks = _inputs(ref)
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    ctl = BitWidthController([2 * Xp.shape[0] * H],
                             ControllerConfig(**UNIFORM_CTL))
    led = CommLedger()
    _, hist = SP.distributed_train(
        StageMesh(1, 4), None, Xp, labels, masks, L, 4, _config("G"),
        EPOCHS + 1, controller=ctl, grids_by_bits=grids, ledger=led,
        overlap=True, init=_init(ref, "G"))
    assert hist["schedules"] == want["schedules"]
    assert len(set(want["schedules"])) > 1
    assert hist["n_compiled_steps"] == want["n_compiled_steps"] > 1
    assert led.per_edge() == want["per_edge"]
    np.testing.assert_allclose(hist["objective"], want["objective"],
                               rtol=1e-3)


def _tiny_problem(seed=0, V=64, h=16):
    from repro_torch.graph.datasets import tiny
    ds = tiny(V=V, device="cpu")
    X = ds.augmented(2)
    g = torch.Generator().manual_seed(seed)
    P0 = torch.randn(X.shape[1], h, generator=g) / np.sqrt(X.shape[1])
    return torch.relu(X @ P0), ds


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (1, 2)])
@pytest.mark.parametrize("wire", ["grid4", "grid8", "mixed"])
def test_overlap_is_bitwise_no_overlap(mesh_shape, wire):
    Xp, ds = _tiny_problem()
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    kw = {}
    if wire == "mixed":
        cfg = ADMMConfig(nu=1e-2, rho=1.0)
        n_st = mesh_shape[1]
        kw = dict(grids_by_bits=grids, mixed_width=True)
    else:
        cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                         grid=grids[int(wire[4:])])
    runs = []
    for overlap in (False, True):
        if wire == "mixed":
            kw["controller"] = BitWidthController(
                stage_ring_edges(n_st, Xp.shape[0], Xp.shape[1]),
                ControllerConfig(**MIXED))
        runs.append(SP.distributed_train(
            StageMesh(*mesh_shape), 3, Xp, ds.labels, ds.masks, 4,
            ds.n_classes, cfg, 4, overlap=overlap, **kw))
    (sa, ha), (sb, hb) = runs
    assert ha["objective"] == hb["objective"]
    assert ha["schedules"] == hb["schedules"]
    for a, b in zip(sa, sb):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("wire", ["fp32", "grid4", "grid8", "mixed"])
def test_ring_shifts_move_the_ledgers_bytes(wire, overlap):
    """What the ring's shifts really moved (``shifted_bytes``, counted from
    the payload tensors) equals the ledger's physical bytes, in-flight
    pairs included: a wire that shipped wider payloads than it charges
    fails here."""
    Xp, ds = _tiny_problem()
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    kw = {}
    if wire == "mixed":
        kw = dict(mixed_width=True, grids_by_bits=grids,
                  controller=BitWidthController(
                      stage_ring_edges(2, Xp.shape[0], Xp.shape[1]),
                      ControllerConfig(**MIXED)))
    elif wire != "fp32":
        cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                         grid=grids[int(wire[4:])])
    led = CommLedger()
    SP.distributed_train(mesh, 3, Xp, ds.labels, ds.masks, 4, ds.n_classes,
                         cfg, 4, overlap=overlap, ledger=led, ring=ring, **kw)
    assert ring.shifted_bytes == led.total_wire_bytes() > 0


def test_affine_ring_shifts_carry_their_header_bytes():
    """An affine wire ships its per-shard scale and offset beside the
    codes; the codec's payload bytes (and so the ledger) count them."""
    from repro_torch.comm.codecs import AffineCodec
    Xp, ds = _tiny_problem()
    mesh = StageMesh(2, 2)
    ring = LocalRing(mesh, "cpu")
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    codec = AffineCodec(8)
    step, _ = SP.make_distributed_step(mesh, 4, ds.n_classes, cfg,
                                       p_codec=codec, q_codec=codec,
                                       ring=ring)
    st = SP.shard_stack(SP.init_stack(3, Xp, 4, cfg), ring)
    data = [ring.to_local(x, "rows") for x in (Xp, ds.labels,
                                                ds.masks["train"])]
    for _ in range(3):
        st, _ = step(st, *data)
    wb = SP.wire_bytes_per_iteration(mesh, 4, Xp.shape[0], Xp.shape[1],
                                     codec, codec)
    assert ring.shifted_bytes == 3 * (wb["q_fwd"] + wb["u_fwd"]
                                      + wb["p_bwd"])


@pytest.mark.parametrize("overlap", [False, True])
def test_donate_writes_into_the_state_passed_in(overlap):
    Xp, ds = _tiny_problem()
    mesh = StageMesh(1, 2)
    ring = LocalRing(mesh, "cpu")
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    data = [ring.to_local(x, "rows") for x in (Xp, ds.labels,
                                                ds.masks["train"])]
    st0 = SP.shard_stack(SP.init_stack(1, Xp, 4, cfg), ring)
    keep = SP.StackState(*(x.clone() for x in st0))
    plain, _ = SP.make_distributed_step(mesh, 4, ds.n_classes, cfg,
                                        overlap=overlap, ring=ring)
    donor, _ = SP.make_distributed_step(mesh, 4, ds.n_classes, cfg,
                                        overlap=overlap, donate=True,
                                        ring=ring)
    prime = SP.make_overlap_primer(mesh, ring=ring)

    def carry(st):
        return (st, prime(st.q, st.u)) if overlap else st

    want, _ = plain(carry(keep), *data)
    got, _ = donor(carry(st0), *data)
    want, got = (want[0], got[0]) if overlap else (want, got)
    for x, w, g in zip(st0, want, got):
        assert g.data_ptr() == x.data_ptr()
        assert torch.equal(g, w)


def test_layouts_round_trip_and_data_shard_zero_is_read():
    mesh = StageMesh(2, 3)
    ring = LocalRing(mesh, "cpu")
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(8, 5, generator=g)
    stack = torch.randn(6, 8, 5, generator=g)
    layers = torch.randn(6, 5, 5, generator=g)
    assert ring.to_local(rows, "rows").shape == (2, 1, 4, 5)
    assert ring.to_local(stack, "layers_rows").shape == (2, 3, 2, 4, 5)
    assert torch.equal(ring.to_global(ring.to_local(rows, "rows"), "rows"),
                       rows)
    assert torch.equal(ring.to_global(ring.to_local(stack, "layers_rows"),
                                      "layers_rows"), stack)
    loc = ring.to_local(layers, "layers")
    assert loc.shape == (2, 3, 2, 5, 5)
    loc[1] += 1.0                        # data shard 1 drifts on its own
    assert torch.equal(ring.to_global(loc, "layers"), layers)
    # stage s, local layer j of data shard d holds rows d, layer s*m + j
    assert torch.equal(ring.to_local(stack, "layers_rows")[1, 2, 1],
                       stack[5, 4:])


def test_unported_options_raise_and_name_their_slice(tmp_path):
    """What the port still refuses: the mixed-width wire under fault
    tolerance (as the reference refuses it) and checkpoints of a
    ProcessGroupRing (the multi-card work). The replay cost model's hooks
    no longer refuse: ``overlap="replay"`` without a cost table takes the
    hand default (overlap on), and each hook answers."""
    import torch.distributed as dist
    from repro_torch.comm.faults import FaultPlan
    from repro_torch.parallel.ring import ProcessGroupRing
    Xp, ds = _tiny_problem()
    mesh = StageMesh(1, 2)
    cfg = ADMMConfig()
    args = (mesh, 0, Xp, ds.labels, ds.masks, 4, ds.n_classes, cfg, 1)
    _, hist = SP.distributed_train(*args, overlap="replay",
                                   ring=LocalRing(mesh, "cpu"))
    assert hist["overlap"] is True
    V, h = Xp.shape
    kw = dict(V=V, h=h)
    assert SP.step_program_plan(mesh, 4, ds.n_classes, cfg, device="cpu",
                                **kw).pallas_calls == {}
    assert SP.trace_step_dag(mesh, 4, ds.n_classes, cfg, **kw).counts()[
        "ppermute"] == 3
    assert SP.choose_overlap_for(mesh, 4, ds.n_classes, cfg, **kw) is True
    assert SP.step_cost_model(mesh, 4, ds.n_classes, cfg, None,
                              grids_by_bits={4: uniform_grid(4, -2.0, 6.0)},
                              **kw)((4, 4)) > 0
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8)}
    for kw in (dict(health=True), dict(faults=FaultPlan(seed=1)),
               dict(ckpt=str(tmp_path / "ck"))):
        with pytest.raises(NotImplementedError, match="mixed_width"):
            SP.distributed_train(
                *args, mixed_width=True, grids_by_bits=grids,
                controller=BitWidthController(
                    stage_ring_edges(2, Xp.shape[0], Xp.shape[1]),
                    ControllerConfig(**MIXED)), **kw)
    for kw in (dict(resume=True), dict(ckpt_every=2)):
        with pytest.raises(ValueError, match="need ckpt"):
            SP.distributed_train(*args, **kw)
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "pg"), rank=0, world_size=1)
    try:
        one = StageMesh(1, 1)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SP.distributed_train(one, 0, Xp, ds.labels, ds.masks, 4,
                                 ds.n_classes, cfg, 1, ckpt=str(tmp_path),
                                 ring=ProcessGroupRing(one, "cpu"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="replaces"):
        SP.make_distributed_step(
            mesh, 4, ds.n_classes, cfg, ring=LocalRing(mesh, "cpu"),
            q_codec=GridCodec(uniform_grid(8, 0, 1)),
            wire=SP.PaddedWire.from_grids({8: uniform_grid(8, 0, 1)}))


# widths tables of a ring of 4 stages (q row, p row; widths 4, 8, 16):
# the last leaves the 8-bit width unused
WIDTHS_TABLES = {"mixed": [[0, 1, 2, 0], [2, 1, 0, 1]],
                 "all_4bit": [[0, 0, 0, 0], [0, 0, 0, 0]],
                 "no_8bit": [[2, 0, 2, 0], [0, 0, 2, 2]]}


def _container_step(overlap, mesh_shape=(1, 4)):
    Xp, ds = _tiny_problem()
    mesh = StageMesh(*mesh_shape)
    ring = LocalRing(mesh, "cpu")
    wire = SP.PaddedWire.from_grids({b: uniform_grid(b, -2.0, 6.0)
                                     for b in (4, 8, 16)})
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    step, _ = SP.make_distributed_step(mesh, 4, ds.n_classes, cfg,
                                       overlap=overlap, wire=wire, ring=ring)
    st = SP.shard_stack(SP.init_stack(0, Xp, 4, cfg), ring)
    data = tuple(ring.to_local(x, "rows")
                 for x in (Xp, ds.labels, ds.masks["train"]))
    return mesh, ring, wire, step, st, data


@pytest.mark.parametrize("overlap", [False, True])
def test_container_step_takes_a_device_table_or_host_ints(overlap):
    """The step over an int32 table (``PaddedWire.widths_table``) is bit
    for bit the step over the same table as rows of host integers, the
    primed in-flight pair too."""
    mesh, ring, wire, step, st, data = _container_step(overlap)
    ints = WIDTHS_TABLES["mixed"]
    table = wire.widths_table([wire.widths[k] for k in ints[0]],
                              [wire.widths[k] for k in ints[1]], "cpu")
    assert table.dtype == torch.int32 and table.tolist() == ints
    outs = []
    for widths in (ints, table):
        carry = st
        if overlap:
            carry = (st, SP.make_overlap_primer(mesh, wire=wire, ring=ring)(
                st.q, st.u, widths))
        outs.append(step(carry, *data, widths))
    (a, ma), (b, mb) = outs
    for x, y in zip(torch.utils._pytree.tree_leaves((a, ma)),
                    torch.utils._pytree.tree_leaves((b, mb))):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


@pytest.mark.parametrize("table", list(WIDTHS_TABLES))
def test_container_step_launches_do_not_depend_on_the_table(table):
    """The recorder counts the same launches for every table: one
    predicated encode and decode per width of the wire and edge, a pack
    and an unpack per packed width, as ``step_program_plan`` states."""
    mesh = StageMesh(1, 4)
    wire = SP.PaddedWire.from_grids({b: uniform_grid(b, -2.0, 6.0)
                                     for b in (4, 8, 16)})
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    kw = dict(V=64, h=16, wire=wire)
    got = SP.trace_step_program(mesh, 4, 7, cfg, widths=WIDTHS_TABLES[table],
                                **kw).launch_counts()
    plan = SP.step_program_plan(mesh, 4, 7, cfg, device="cuda", **kw)
    assert got == plan.pallas_calls
    assert {k: got[k] for k in ("grid_encode", "grid_decode", "pack_codes",
                                "unpack_codes")} == {
        "grid_encode": 6, "grid_decode": 6, "pack_codes": 4,
        "unpack_codes": 4}


def test_quantized_comm_demo_runs_on_the_cpu(capsys):
    from repro_torch.examples import quantized_comm_demo
    quantized_comm_demo.main(["--device", "cpu", "--epochs", "4"])
    out = capsys.readouterr().out
    assert "75% saved" in out and "identical trajectory" in out
    assert "1 step built" in out
    assert "replay-searched choice: overlap=" in out
    assert "walltime objective" in out and "(16, 16, 16, 16)" in out
    # per-device shift payload of one recorded step (the reference's HLO)
    assert "fp32 wire :      98304 bytes" in out
    assert "int8 wire :      49152 bytes  (50% saved)" in out
    # the chaos run: faults caught by the header; a rollback, or why none
    chaos = [x for x in out.splitlines() if x.startswith("chaos run")]
    assert len(chaos) == 1 and "faults injected" in chaos[0]
    assert " 0 rollback(s)" not in chaos[0] or "  no rollback: " in out
    # the lint table of four configurations
    assert "program-contract lint" in out
    for name in ("baseline", "overlap", "int8_wire", "psum_int8_w4"):
        assert any(x.startswith(name + " ") and x.split()[1:] == ["ok"] * 6
                   for x in out.splitlines()), name
    assert "0 error(s) across 4 configs" in out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["grid4", "grid16", "mixed"])
def test_cuda_ring_with_two_layers_per_stage_matches_plain(cuda, wire):
    """Mesh (2, 2) with L = 4 on the card: two layers per stage (strided
    boundary slabs), two data shards, the 4-bit packed wire, the 16-bit
    codes (uint16 on the ring's shift) or the mixed containers — through
    the kernels, against ``use_kernels=False``."""
    from repro_torch.kernels import ops
    Xp, ds = _tiny_problem()
    Xp = Xp.to(cuda)
    labels, masks = ds.labels.to(cuda), {"train": ds.masks["train"].to(cuda)}
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    kw = {}
    if wire == "mixed":
        cfg = ADMMConfig(nu=1e-2, rho=1.0)
    else:
        cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                         grid=grids[int(wire[4:])])
    runs = []
    for uk in (True, False):
        if wire == "mixed":
            kw = dict(grids_by_bits=grids, mixed_width=True,
                      controller=BitWidthController(
                          stage_ring_edges(2, Xp.shape[0], Xp.shape[1]),
                          ControllerConfig(**MIXED)))
        ops.reset_launch_counts()
        c = dataclasses.replace(cfg, use_kernels=uk)
        runs.append(SP.distributed_train(StageMesh(2, 2), 3, Xp, labels,
                                         masks, 4, ds.n_classes, c, 4, **kw))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if uk:
            assert counts["fused_linear"] and counts["fista_zlast"]
            if wire == "grid16":            # 16-bit codes ship unpacked
                assert counts["grid_encode"] and counts["grid_decode"]
            else:
                assert counts["pack_codes"] and counts["unpack_codes"]
    np.testing.assert_allclose(runs[0][1]["objective"],
                               runs[1][1]["objective"], rtol=1e-3)


@pytest.mark.cuda
def test_cuda_sentinel_ring_flips_the_bits_the_cpu_flips(cuda):
    """Mesh (2, 2) with L = 4 (two layers per stage), G-Q under a fault plan
    with link flips, drops and sneaky flips, overlapped: through the kernels
    on the card and the plain path on the CPU, the same fault accounting
    and ledger counts, the objectives at rtol 1e-3; and one tick's flips of
    a ring payload on both devices (the host-drawn positions), bit for bit,
    with equal headers."""
    from repro_torch.comm import faults as F
    Xp, ds = _tiny_problem()
    cfg = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                     grid=uniform_grid(8, -2.0, 6.0))
    plan = F.FaultPlan(seed=5, flip_rate=0.3, drop_rate=0.1,
                       sneaky_rate=0.1, flips_per_event=3)
    runs = {}
    for dev in ("cpu", cuda):
        led = CommLedger()
        _, h = SP.distributed_train(
            StageMesh(2, 2), 3, Xp.to(dev), ds.labels.to(dev),
            {"train": ds.masks["train"].to(dev)}, 4, ds.n_classes, cfg, 6,
            faults=plan, ledger=led, overlap=True)
        runs[str(dev)] = (h, led)
    (hc, lc), (hg, lg) = runs["cpu"], runs[str(cuda)]
    assert hc["faults"] == hg["faults"]
    assert hc["faults"]["detected"] > 0
    assert lc.fault_counts() == lg.fault_counts()
    np.testing.assert_allclose(hg["objective"], hc["objective"], rtol=1e-3)
    x = torch.randn((2, 2, 1) + tuple(Xp.shape),
                    generator=torch.Generator().manual_seed(0))
    ctl = plan.controls(3, 2, device="cpu")
    flipped = {}
    for dev in ("cpu", cuda):
        c = F.FaultControls(*(t.to(dev) for t in ctl))
        bad = F.flip_bits(x.to(dev), c.draws[1, :, 1][None],
                          torch.ones((1, 2), device=dev), batch_dims=2)
        flipped[str(dev)] = (bad.cpu(), F.checksum_header(
            bad, c.seqno, batch_dims=2).cpu())
    assert torch.equal(flipped["cpu"][0].view(torch.int32),
                       flipped[str(cuda)][0].view(torch.int32))
    assert not torch.equal(flipped["cpu"][0].view(torch.int32),
                           x.view(torch.int32))
    assert torch.equal(flipped["cpu"][1], flipped[str(cuda)][1])
    # the checksum's int32 sum wraps on the card as numpy's exact one does
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 2, 100003),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    want = ((words.numpy().astype(np.int64).sum(-1) + 2 ** 31) % 2 ** 32
            - 2 ** 31).astype(np.int32)
    assert np.array_equal(F.payload_checksum(words.to(cuda), 2).cpu().numpy(),
                          want)
    # uint16 containers widen (zero-extend) on the card as on the CPU
    u16 = (words & 0xFFFF).to(torch.uint16)
    want16 = ((words.numpy().astype(np.int64) & 0xFFFF).sum(-1) + 2 ** 31) \
        % 2 ** 32 - 2 ** 31
    for dev in ("cpu", cuda):
        assert np.array_equal(F.payload_checksum(u16.to(dev), 2).cpu()
                              .numpy(), want16.astype(np.int32)), dev
    # the finite sentinels see a NaN and an infinity on the card
    mesh = StageMesh(1, 2)
    ring = LocalRing(mesh, cuda)
    st = SP.shard_stack(SP.init_stack(3, Xp.to(cuda), 4, cfg), ring)
    st.W[0, 0, 0, 0, 0] = float("nan")
    st.z[0, 1, 1, 0, 0] = float("inf")
    data = [ring.to_local(x.to(cuda), "rows")
            for x in (Xp, ds.labels, ds.masks["train"])]
    step, _ = SP.make_distributed_step(mesh, 4, ds.n_classes, cfg,
                                       health=True, ring=ring)
    good = SP.make_sentinel_primer(mesh, ring=ring)(st.q, st.u, st.p)
    _, m = step((st, good), *data, F.null_controls(2, device=cuda))
    assert not bool(m["health"]["W_finite"])
    assert not bool(m["health"]["residual_finite"])
