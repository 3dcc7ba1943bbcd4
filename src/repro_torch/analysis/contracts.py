"""Program-contract linter: each ring step checked against the program it
promises.

Counterpart of ``repro.analysis.contracts``. The pdADMM-G step is only
paper-faithful *and* fast if its program has exactly the promised shape:
the kernel launches, the carried exchanges under overlap, the packed wire
dtypes and bytes, the integrity headers beside the payloads, donation.
The reference reads all of that from the jitted step's jaxpr and lowered
or compiled text without running it. A step of the port is eager Python,
so its program is what one call does: every view here records ONE call of
the step (``parallel.stage_parallel.record_step``, through
``analysis.torch_trace``) with seeded random data (or the caller's
``inputs``),

  * on the CPU (``device="cpu"``), at the specs' sizes: the plain
    versions of the kernels compute, and each kernel scope counts the one
    launch the card would make;
  * on the card (``device="cuda"``, the default): the kernels launch, and
    their wrappers' own counters (``kernels.ops.launch_counts``) are read
    around the call as well.

Schema
------
A **contract** is a named invariant over one recorded step
configuration::

    @contract("schedule.carried", severity="error",
              description="in-flight slabs leaving through the carry")
    def _carried(view):
        got = sum(1 for p in view.profile if p["carried"])
        if got != view.plan.n_carried:
            yield (f"{got} carried shifts, plan says "
                   f"{view.plan.n_carried}", {"got": got})

  * the key is ``family.name``; the family (``dispatch`` / ``schedule`` /
    ``wire`` / ``memory`` / ``dtype`` / ``cache``) is the key's first
    segment and is what the CLI's table groups by,
  * the check receives a :class:`ProgramView` (or a :class:`PsumView`),
    lazily recorded artifacts of one configuration, and yields
    ``(message, details)`` per violation; each becomes a :class:`Finding`
    with the contract's key and severity,
  * severities: ``error`` (the program broke a promise), ``warn``
    (suspicious, not wrong), ``info``.

The declarative half of every step contract is
``stage_parallel.step_program_plan`` (and ``comm.transport.
psum_program_plan`` for the compressed psum), computed next to the code
that owns the invariant; the checks here only compare recording against
plan. The plan is always the one for the card (``device="cuda"``),
whatever device records: a CPU recording counts the card's launches.

How each contract reads a recorded step:

  * ``dispatch.pallas_calls`` — the recorded launches equal
    ``plan.pallas_calls``; on the card, so do the wrappers' counters over
    the call (a kernel scope counts one launch whichever version
    computes, so only the counters catch a wrapper that fell back to its
    plain version).
  * ``dispatch.ragged_fallback`` — a ragged V (``n_rows × 17``) launches
    what the aligned plan states (the CUDA kernels mask their own edges).
  * ``schedule.*`` — from the recorder's collectives, one event per tensor
    moved (a sentinel header is its own event, as in the reference's
    jaxpr); the fault injector is its ``bitwise_xor`` records, the psum
    handshake a ``pmin`` record.
  * ``wire.*`` — the per-tensor moves, in bytes per shard, against
    ``edge_events`` and the ``PsumProgramPlan``.
  * ``memory.donation`` — with ``donate=True`` every returned state leaf
    shares its storage with the leaf passed in, with ``donate=False`` none
    does (the port donates by copying into the old storage).
  * ``memory.aliasing`` — one ``copy_`` into each passed leaf's storage
    iff ``donate`` (``check_compile`` specs).
  * ``memory.copies`` (warn) — the step's ``copy_`` records stay within
    :data:`COPY_BUDGET`.
  * ``dtype.no_f64`` — no record reads or writes float64 (a kernel's
    record holds its inputs' dtypes: its plain version's internals are not
    its program).
  * ``dtype.weak_outputs`` (warn) — PyTorch has no weak types. The port's
    counterpart: a state or metrics output that is a Python number (a host
    read each step), or a tensor whose dtype is not the one the state or
    the metrics declare.
  * ``cache.kwarg_set`` / ``cache.kwarg_observable`` — the step builder's
    keyword-only surface is the pinned set, and flipping each pinned
    kwarg changes the recorded fingerprint.

Mutation testing drives the same engine with a declared spec and a
mutated recording: ``check_contracts(spec, overrides={"donate": False})``
records the step without donation while the plan still promises it, so
``memory.donation`` must fire. ``overrides`` may also name
``use_kernels`` (a config field, not a step kwarg). ``wrap=``
post-composes a function onto the step before recording, ``variants=``
overrides the cache family's flip table and ``pinned=`` the expected
kwarg set.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.analysis.torch_trace import (collective_profile,
                                              count_primitive, ppermute_moves)

# ---------------------------------------------------------------------------
# Findings and the contract registry
# ---------------------------------------------------------------------------

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation (or informational note) on one config."""
    key: str                     # "family.name"
    severity: str                # error | warn | info
    config: str                  # registered spec name (or file path)
    message: str
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def family(self) -> str:
        return self.key.split(".", 1)[0]

    def to_dict(self) -> dict:
        return {"key": self.key, "severity": self.severity,
                "config": self.config, "message": self.message,
                "details": self.details}


@dataclasses.dataclass(frozen=True)
class Contract:
    key: str
    severity: str
    description: str
    check: Callable                      # (view) -> iterable[(msg, details)]

    @property
    def family(self) -> str:
        return self.key.split(".", 1)[0]


CONTRACTS: Dict[str, Contract] = {}


def contract(key: str, *, severity: str, description: str):
    """Register a check function under ``key`` (``family.name``)."""
    assert severity in SEVERITIES, severity

    def deco(fn):
        assert key not in CONTRACTS, f"duplicate contract {key}"
        CONTRACTS[key] = Contract(key, severity, description, fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# Registered step configurations (plain data: they list without recording)
# ---------------------------------------------------------------------------

GRID_RANGE = (-2.0, 6.0)     # calibration range every registered grid uses

# The keyword-only surface of make_distributed_step that decides WHAT a
# step computes: the reference's step-cache key, kept as its seven.
PINNED_STEP_KWARGS = frozenset(
    {"overlap", "donate", "p_codec", "q_codec", "wire", "health", "faults"})

# Keyword-only arguments that pick WHERE a step runs, not what it computes:
# ``ring`` (a LocalRing on some device, or a ProcessGroupRing). Excluded
# from the pinned set and from the flip table; cache.kwarg_set compares the
# surface without them.
PLACEMENT_STEP_KWARGS = frozenset({"ring"})


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One registered ``make_distributed_step`` configuration, held as
    plain data."""
    name: str
    mesh: Tuple[int, int] = (2, 2)       # (data, model)
    V: int = 64
    h: int = 32
    L: int = 4
    n_classes: int = 4
    fista_iters: int = 5
    solver_grid_bits: int = 0    # >0: pdADMM-G-Q solver (backtracking p)
    overlap: bool = False
    donate: bool = False
    p_bits: int = 0              # wire codec bits (0 -> config default)
    q_bits: int = 0
    container: Tuple[int, ...] = ()      # PaddedWire widths
    health: bool = False
    fault_flip_rate: float = 0.0
    cache_probe: bool = False    # run the cache family from this spec
    check_ragged: bool = False   # re-record at a ragged V
    check_compile: bool = False  # the aliasing and copy checks

    def config(self, use_kernels: bool = True):
        from repro_torch.core.pdadmm import ADMMConfig
        from repro_torch.core.quantize import uniform_grid
        grid = None
        if self.solver_grid_bits:
            grid = uniform_grid(self.solver_grid_bits, *GRID_RANGE)
        return ADMMConfig(nu=1e-2, rho=1.0, fista_iters=self.fista_iters,
                          quantize_p=grid is not None,
                          quantize_q=grid is not None, grid=grid,
                          use_kernels=use_kernels)

    def kwargs(self) -> dict:
        """The ``make_distributed_step`` kwargs this spec declares."""
        from repro_torch.comm import codecs as C, faults as FT
        from repro_torch.comm.transport import PaddedWire
        from repro_torch.core.quantize import uniform_grid

        def grid_codec(bits):
            return C.GridCodec(uniform_grid(bits, *GRID_RANGE)) \
                if bits else None

        wire = None
        if self.container:
            wire = PaddedWire.from_grids(
                {b: uniform_grid(b, *GRID_RANGE) for b in self.container})
        faults = None
        if self.fault_flip_rate:
            faults = FT.FaultPlan(seed=0, flip_rate=self.fault_flip_rate)
        return dict(overlap=self.overlap, donate=self.donate,
                    p_codec=grid_codec(self.p_bits),
                    q_codec=grid_codec(self.q_bits),
                    wire=wire, health=self.health, faults=faults)


STEP_SPECS: Tuple[StepSpec, ...] = (
    StepSpec(name="baseline", cache_probe=True, check_ragged=True),
    StepSpec(name="overlap", overlap=True),
    StepSpec(name="donate", donate=True, check_compile=True),
    StepSpec(name="int8_wire", p_bits=8, q_bits=8),
    StepSpec(name="int4_wire", p_bits=4, q_bits=4),
    StepSpec(name="mixed_wire", p_bits=8, q_bits=16),
    StepSpec(name="quantized_solver", solver_grid_bits=8, check_ragged=True),
    StepSpec(name="container", container=(4, 8, 16)),
    StepSpec(name="container_overlap", container=(4, 8, 16), overlap=True),
    StepSpec(name="health", health=True),
    StepSpec(name="faults", health=True, fault_flip_rate=0.05),
)


@dataclasses.dataclass(frozen=True)
class PsumSpec:
    """One registered ``quantized_psum`` point: codec bits x world size."""
    name: str
    bits: int
    world: int = 4
    rows: int = 8
    cols: int = 16

    def codec(self):
        from repro_torch.comm import codecs as C
        return C.FP32 if self.bits >= 32 else C.AffineCodec(self.bits)


PSUM_SPECS: Tuple[PsumSpec, ...] = (
    PsumSpec(name="psum_int4_w4", bits=4),      # 16 < 64  -> gather
    PsumSpec(name="psum_int8_w4", bits=8),      # 32 < 64  -> gather
    PsumSpec(name="psum_int16_w4", bits=16),    # 64 >= 64 -> code_psum
    PsumSpec(name="psum_fp32_w4", bits=32),     # uncompressed psum
)


def get_spec(name: str):
    for s in STEP_SPECS + PSUM_SPECS:
        if s.name == name:
            return s
    raise KeyError(f"no registered spec {name!r}; known: "
                   f"{[s.name for s in STEP_SPECS + PSUM_SPECS]}")


# ---------------------------------------------------------------------------
# Recorded-program views (lazy: one recording each, on first use)
# ---------------------------------------------------------------------------

def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _find(tree, cls):
    """The first ``cls`` instance in a tuple tree (NamedTuples are
    tuples: the test comes first)."""
    if isinstance(tree, cls):
        return tree
    if isinstance(tree, tuple):
        for x in tree:
            found = _find(x, cls)
            if found is not None:
                return found
    return None


class ProgramView:
    """Lazily recorded artifacts of one step configuration.

    ``plan`` always reflects the spec's DECLARED kwargs; ``overrides``
    mutates only what is recorded (the mutation-testing hook), ``wrap``
    post-composes a function onto the step before recording. ``inputs``
    (global ``(Xp, labels, label_mask)`` of the spec's V and h) replaces
    the seeded random data (``stage_parallel.record_step``). ``variants``
    (kwarg -> override; default :func:`_default_variants`) and ``pinned``
    (default :data:`PINNED_STEP_KWARGS`) are what the cache contracts
    hold the step to."""

    def __init__(self, spec: StepSpec, *, overrides: Optional[dict] = None,
                 wrap: Optional[Callable] = None, device=None, inputs=None,
                 variants: Optional[dict] = None,
                 pinned: Optional[Iterable[str]] = None):
        self.spec = spec
        self.overrides = dict(overrides or {})
        self.wrap = wrap
        self.variants = variants
        self.pinned = frozenset(PINNED_STEP_KWARGS if pinned is None
                                else pinned)
        self.device = resolve_device(device)
        self.inputs = inputs
        self._cache: dict = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def mesh(self):
        from repro_torch.parallel.ring import StageMesh
        return StageMesh(*self.spec.mesh)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def plan(self):
        from repro_torch.parallel import stage_parallel as SP

        def build():
            s = self.spec
            return SP.step_program_plan(self.mesh, s.L, s.n_classes,
                                        s.config(), V=s.V, h=s.h,
                                        device="cuda", **s.kwargs())
        return self._memo("plan", build)

    @property
    def trace_kwargs(self) -> dict:
        kw = self.spec.kwargs()
        kw.update(self.overrides)
        kw.pop("use_kernels", None)
        return kw

    @property
    def recorded(self):
        """The ``stage_parallel.RecordedStep`` of one call."""
        from repro_torch.parallel import stage_parallel as SP

        def build():
            s = self.spec
            cfg = s.config(self.overrides.get("use_kernels", True))
            return SP.record_step(self.mesh, s.L, s.n_classes, cfg, V=s.V,
                                  h=s.h, device=self.device, wrap=self.wrap,
                                  inputs=self.inputs, **self.trace_kwargs)
        return self._memo("recorded", build)

    @property
    def program(self):
        return self.recorded.program

    @property
    def profile(self):
        return self._memo("profile", lambda: collective_profile(self.program))

    @property
    def pallas_counts(self) -> Dict[str, int]:
        """Launches the recording counted (one per kernel scope)."""
        return self.program.launch_counts()

    @property
    def launches(self) -> Optional[Dict[str, int]]:
        """The wrappers' counters over the call; ``None`` off the card."""
        return self.recorded.launches if self.on_card else None

    @property
    def ppermute_moves(self):
        return self._memo("moves", lambda: ppermute_moves(self.program))

    @property
    def passed_state(self):
        from repro_torch.parallel.stage_parallel import StackState
        return _find(self.recorded.carry, StackState)

    @property
    def returned_state(self):
        from repro_torch.parallel.stage_parallel import StackState
        return _find(self.recorded.out[0], StackState)

    def copies_into_passed(self) -> Dict[str, int]:
        """State leaf -> ``copy_`` records writing its passed storage."""
        keys = {f: _storage(t) for f, t in
                zip(self.passed_state._fields, self.passed_state)}
        dests = [r.dest for r in self.program.records if r.dest is not None]
        return {f: sum(1 for d in dests if d == k) for f, k in keys.items()}

    def ragged_view(self) -> "ProgramView":
        """The same configuration recorded at a V whose per-row shard is
        ragged against every kernel tile."""
        def build():
            n_rows = self.spec.mesh[0]
            return ProgramView(dataclasses.replace(self.spec,
                                                   V=n_rows * 17),
                               overrides=self.overrides, wrap=self.wrap,
                               device=self.device)
        return self._memo("ragged", build)

    def fingerprint(self) -> tuple:
        """Cheap identity of the recorded program used by the cache
        contracts: two kwarg points MUST differ somewhere in here."""
        prof = self.profile
        return (len(prof),
                sum(1 for p in prof if p["carried"]),
                tuple(p["dtype"] for p in prof),
                tuple(self.ppermute_moves),
                count_primitive(self.program, "bitwise_xor") > 0,
                sum(self.copies_into_passed().values()),
                len(self.recorded.args))


class PsumView:
    """Lazily recorded ``quantized_psum`` on a ``LocalRing`` of world
    ``spec.world`` (the data axis), through a ``RecordingRing``."""

    def __init__(self, spec: PsumSpec, *, codec_override=None, device=None):
        self.spec = spec
        self.codec_override = codec_override
        self.device = resolve_device(device)
        self._cache: dict = {}

    @property
    def plan(self):
        from repro_torch.comm import transport as T
        if "plan" not in self._cache:
            self._cache["plan"] = T.psum_program_plan(
                self.spec.codec(), (self.spec.rows, self.spec.cols),
                self.spec.world)
        return self._cache["plan"]

    @property
    def program(self):
        from repro_torch.analysis import torch_trace as tt
        from repro_torch.comm.transport import quantized_psum
        from repro_torch.parallel.ring import LocalRing, StageMesh
        if "program" not in self._cache:
            spec = self.spec
            ring = LocalRing(StageMesh(spec.world, 1), self.device)
            g = torch.Generator(device=self.device).manual_seed(0)
            x = ring.to_local(torch.randn((spec.world * spec.rows, spec.cols),
                                          generator=g, device=self.device),
                              "rows")
            codec = self.codec_override or spec.codec()
            with tt.StepRecorder(spec.world) as rec:
                quantized_psum(x, tt.RecordingRing(ring, rec), "data", codec)
            self._cache["program"] = rec.program
        return self._cache["program"]

    def payload_ops(self):
        """(prim, dtype, operand bytes per shard) of every payload-bearing
        collective (psum / all_gather). The port's ``quantized_psum`` runs
        no bookkeeping psum: the world size is the ring's host integer."""
        return [(r.prim, dt, b) for r in self.program.records
                if r.kind == "collective" and r.prim in ("psum", "all_gather")
                for dt, b in r.moves]


# ---------------------------------------------------------------------------
# dispatch family
# ---------------------------------------------------------------------------

@contract("dispatch.pallas_calls", severity="error",
          description="exact launch count per kernel matches the step's "
                      "plan for the card (and, on the card, the wrappers' "
                      "counters)")
def _dispatch_counts(view):
    got, want = view.pallas_counts, view.plan.pallas_calls
    if got != want:
        yield (f"per-kernel launches {got} != plan {want}",
               {"got": got, "want": want})
    real = view.launches
    if real is not None and real != want:
        yield (f"the kernel wrappers counted {real} != plan {want}: a "
               f"wrapper fell back to its plain version",
               {"counted": real, "want": want})


@contract("dispatch.ragged_fallback", severity="error",
          description="ragged node counts keep the kernel path "
                      "(no silent plain fallback)")
def _dispatch_ragged(view):
    if not view.spec.check_ragged or not view.plan.pallas_calls:
        return
    ragged = view.ragged_view()
    want = view.plan.pallas_calls
    got = ragged.pallas_counts
    if got != want:
        yield (f"ragged V={ragged.spec.V} launches {got} != aligned plan "
               f"{want}", {"ragged_V": ragged.spec.V, "got": got})
    real = ragged.launches
    if real is not None and real != want:
        yield (f"ragged V={ragged.spec.V}: the kernel wrappers counted "
               f"{real} != aligned plan {want} — silent plain fallback",
               {"ragged_V": ragged.spec.V, "counted": real})


# ---------------------------------------------------------------------------
# schedule family
# ---------------------------------------------------------------------------

@contract("schedule.ppermute_count", severity="error",
          description="total boundary shifts (payload + headers) match "
                      "the plan")
def _sched_count(view):
    got, want = len(view.profile), len(view.plan.edge_events)
    if got != want:
        yield (f"{got} shifted tensors recorded, plan schedules {want}",
               {"got": got, "want": want})


@contract("schedule.carried", severity="error",
          description="in-flight slabs leaving through the carry (2 under "
                      "overlap, else 0)")
def _sched_carried(view):
    got = sum(1 for p in view.profile if p["carried"])
    if got != view.plan.n_carried:
        yield (f"{got} carried shifts, plan says {view.plan.n_carried}",
               {"got": got, "want": view.plan.n_carried})


@contract("schedule.work_to_consumer", severity="error",
          description="overlap hides consumed exchanges behind solver "
                      "work; the baseline ordering is exactly fused")
def _sched_work(view):
    floor = view.plan.min_work_to_consumer
    consumed = [p for p in view.profile if not p["carried"]]
    if floor == 0:
        bad = [p["work_to_consumer"] for p in consumed
               if p["work_to_consumer"] != 0]
        if bad:
            yield (f"fused schedule has work between issue and consume: "
                   f"{bad}", {"work": bad})
        return
    payload = [p for p in consumed if p["dtype"] != "int32"]
    lazy = [p["work_to_consumer"] for p in payload]
    if any(w < floor for w in lazy):
        yield (f"consumed exchange sits on the critical path: "
               f"work_to_consumer {lazy} < {floor}",
               {"work": lazy, "floor": floor})


@contract("schedule.fault_injector", severity="error",
          description="xor injection machinery present iff an active "
                      "FaultPlan is declared")
def _sched_xor(view):
    has_xor = count_primitive(view.program, "bitwise_xor") > 0
    if has_xor != view.plan.expects_xor:
        yield (f"xor machinery {'present' if has_xor else 'absent'}, plan "
               f"expects {'it' if view.plan.expects_xor else 'none'}",
               {"has_xor": has_xor})


@contract("schedule.psum_mode", severity="error",
          description="the compressed psum's physical collective matches "
                      "the world*bits < 64 rule")
def _sched_psum(view):
    if not isinstance(view, PsumView):
        return
    plan = view.plan
    ops = view.payload_ops()
    prims = {(p, d) for p, d, _ in ops}
    if (plan.collective, plan.operand_dtype) not in prims:
        yield (f"mode {plan.mode} promises {plan.collective}"
               f"[{plan.operand_dtype}], recording has {sorted(prims)}",
               {"want": [plan.collective, plan.operand_dtype],
                "got": sorted(prims)})
    has_handshake = count_primitive(view.program, "pmin") > 0
    if plan.mode != "psum" and has_handshake != plan.handshake:
        yield (f"affine min/max handshake "
               f"{'present' if has_handshake else 'absent'}, plan expects "
               f"{plan.handshake}", {"handshake": has_handshake})


# ---------------------------------------------------------------------------
# wire family
# ---------------------------------------------------------------------------

@contract("wire.dtypes", severity="error",
          description="each boundary shift moves the codec's physical "
                      "container dtype, in issue order")
def _wire_dtypes(view):
    got = [p["dtype"] for p in view.profile]
    want = [d for _, d, _ in view.plan.edge_events]
    if got != want:
        yield (f"wire dtypes {got} != plan {want} (issue order "
               f"{[e for e, _, _ in view.plan.edge_events]})",
               {"got": got, "want": want})


@contract("wire.ppermute_bytes", severity="error",
          description="physical bytes of each boundary shift equal the "
                      "codec/container accounting (payload_bytes/capacity)")
def _wire_bytes(view):
    got = view.ppermute_moves
    want = view.plan.edge_events
    if len(got) != len(want):
        return  # schedule.ppermute_count already fires
    for (edge, wdt, wb), (gdt, gb) in zip(want, got):
        if gb != wb:
            yield (f"{edge} moves {gb} B/link ({gdt}), accounting says "
                   f"{wb} B ({wdt}) — wire undercount",
                   {"edge": edge, "got": gb, "want": wb})


@contract("wire.psum_bytes", severity="error",
          description="the compressed psum's payload operand bytes equal "
                      "psum_wire_bytes' physical accounting")
def _wire_psum_bytes(view):
    if not isinstance(view, PsumView):
        return
    plan = view.plan
    match = [b for p, d, b in view.payload_ops()
             if (p, d) == (plan.collective, plan.operand_dtype)]
    if not match:
        return  # schedule.psum_mode already fires
    if plan.operand_bytes not in match:
        yield (f"{plan.collective}[{plan.operand_dtype}] payload bytes "
               f"{match} != psum_wire_bytes {plan.operand_bytes}",
               {"got": match, "want": plan.operand_bytes})


# ---------------------------------------------------------------------------
# memory family
# ---------------------------------------------------------------------------

@contract("memory.donation", severity="error",
          description="donate=True returns every state leaf in the storage "
                      "it was passed in; donate=False none")
def _mem_donation(view):
    passed, returned = view.passed_state, view.returned_state
    shared = [f for f, a, b in zip(passed._fields, passed, returned)
              if _storage(a) == _storage(b)]
    want = len(passed) if view.plan.donate else 0
    if len(shared) != want:
        yield (f"{len(shared)} returned state leaves share the passed "
               f"storage {shared}, donation promises {want}",
               {"got": shared, "want": want})


# ~2x the copy_ records the donated 2x2 spec's step makes today (11: the
# six settles of donation, and five splices into fresh tensors: layer 0's
# p and residual, layer L-1's z and q, the last stage's risk) — a jump
# past this means the step started copying state it used to update in
# place
COPY_BUDGET = 22


@contract("memory.aliasing", severity="error",
          description="donated state is written back into its own storage "
                      "(one copy_ per leaf), undonated state never")
def _mem_alias(view):
    if not view.spec.check_compile:
        return
    copies = view.copies_into_passed()
    want = 1 if view.plan.donate else 0
    bad = {f: n for f, n in copies.items() if n != want}
    if bad:
        yield (f"copy_ into the passed state {copies}, donation "
               f"{view.plan.donate} promises {want} per leaf",
               {"got": copies, "want": want})


@contract("memory.copies", severity="warn",
          description="the step's copy_ count stays inside the budget "
                      "(donation keeps state updates in place)")
def _mem_copies(view):
    if not view.spec.check_compile:
        return
    got = count_primitive(view.program, "copy_")
    if got > COPY_BUDGET:
        yield (f"{got} copy_ records > budget {COPY_BUDGET}",
               {"got": got, "budget": COPY_BUDGET})


# ---------------------------------------------------------------------------
# dtype family
# ---------------------------------------------------------------------------

@contract("dtype.no_f64", severity="error",
          description="no float64 anywhere in the step (silent "
                      "f32->f64 promotion doubles wire and memory)")
def _dtype_f64(view):
    hits = sorted({r.name for r in view.program.records
                   if "float64" in r.dtypes})
    if hits:
        yield (f"float64 flows through {hits}", {"primitives": hits})


def _declared_dtypes() -> dict:
    """Output leaf path -> the dtype the step declares for it."""
    from repro_torch.parallel.stage_parallel import HEALTH_FLAGS
    f32 = torch.float32
    out = {("metrics", k): f32
           for k in ("residual", "objective", "stage_residuals")}
    out[("metrics", "health", "wire_bad")] = torch.int32
    out.update({("metrics", "health", k): torch.bool for k in HEALTH_FLAGS})
    return out


def _metric_leaves(tree, path=("metrics",)):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _metric_leaves(v, path + (k,))
    else:
        yield path, tree


@contract("dtype.weak_outputs", severity="warn",
          description="state and metrics outputs are tensors of their "
                      "declared dtypes (a Python number is a host read "
                      "each step)")
def _dtype_weak(view):
    from repro_torch.comm.faults import GoodSlabs
    carry, metrics = view.recorded.out
    leaves = list(_metric_leaves(metrics))
    for cls in (type(view.passed_state), GoodSlabs):
        tree = _find(carry, cls)
        if tree is not None:
            leaves += [((cls.__name__, f), t)
                       for f, t in zip(tree._fields, tree)]
    declared = _declared_dtypes()
    bad = []
    for path, t in leaves:
        want = declared.get(path, torch.float32)
        if not isinstance(t, torch.Tensor):
            bad.append(("/".join(path), type(t).__name__))
        elif t.dtype != want:
            bad.append(("/".join(path), str(t.dtype)))
    if bad:
        yield (f"outputs off their declared dtypes: {bad}", {"outputs": bad})


# ---------------------------------------------------------------------------
# cache family
# ---------------------------------------------------------------------------

def _default_variants(spec: StepSpec) -> Dict[str, dict]:
    """Per pinned kwarg: the override that must change the recorded
    program relative to ``spec``'s base point."""
    from repro_torch.comm import codecs as C, faults as FT
    from repro_torch.comm.transport import PaddedWire
    from repro_torch.core.quantize import uniform_grid
    return {
        "overlap": {"overlap": not spec.overlap},
        "donate": {"donate": not spec.donate},
        "p_codec": {"p_codec": C.GridCodec(uniform_grid(8, *GRID_RANGE))},
        "q_codec": {"q_codec": C.GridCodec(uniform_grid(16, *GRID_RANGE))},
        "wire": {"wire": PaddedWire.from_grids(
            {b: uniform_grid(b, *GRID_RANGE) for b in (4, 8, 16)}),
            "p_codec": None, "q_codec": None},
        "health": {"health": not spec.health},
        "faults": {"faults": FT.FaultPlan(seed=0, flip_rate=0.1)},
    }


@contract("cache.kwarg_set", severity="error",
          description="make_distributed_step's keyword-only surface (less "
                      "placement) IS the pinned set (a new kwarg must "
                      "register contracts before it ships)")
def _cache_kwargs(view):
    from repro_torch.parallel import stage_parallel as SP
    if not view.spec.cache_probe:
        return
    sig = inspect.signature(SP.make_distributed_step)
    kwonly = {n for n, p in sig.parameters.items()
              if p.kind == inspect.Parameter.KEYWORD_ONLY}
    kwonly -= PLACEMENT_STEP_KWARGS
    pinned = view.pinned
    if kwonly != set(pinned):
        yield (f"kwarg-only surface {sorted(kwonly)} != pinned set "
               f"{sorted(pinned)}",
               {"got": sorted(kwonly), "pinned": sorted(pinned)})


@contract("cache.kwarg_observable", severity="error",
          description="every pinned kwarg provably changes the recorded "
                      "program")
def _cache_observable(view):
    if not view.spec.cache_probe:
        return
    base = view.fingerprint()
    variants = view.variants if view.variants is not None \
        else _default_variants(view.spec)
    for kw, delta in variants.items():
        flipped = ProgramView(view.spec, overrides=delta, device=view.device,
                              inputs=view.inputs)
        if flipped.fingerprint() == base:
            yield (f"flipping {kw!r} leaves the recorded program "
                   f"indistinguishable (fingerprint unchanged)",
                   {"kwarg": kw})


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

# the contracts a PsumSpec runs (step specs run everything else)
PSUM_CONTRACTS = frozenset({"schedule.psum_mode", "wire.psum_bytes"})


def check_contracts(spec, *, overrides: Optional[dict] = None,
                    wrap: Optional[Callable] = None,
                    variants: Optional[dict] = None,
                    pinned: Optional[Iterable[str]] = None,
                    families: Optional[Iterable[str]] = None,
                    device=None, inputs=None):
    """Run every registered contract against one spec (by name or object),
    recorded on ``device`` (default: the card), on ``inputs`` if given
    (a step spec's global ``(Xp, labels, label_mask)``); returns the list
    of :class:`Finding`. ``overrides`` / ``wrap`` / ``variants`` /
    ``pinned`` are the mutation-testing hooks (module docstring). A check
    that raises is an error finding."""
    if isinstance(spec, str):
        spec = get_spec(spec)
    if isinstance(spec, PsumSpec):
        view = PsumView(spec, codec_override=(overrides or {}).get("codec"),
                        device=device)
        keys = PSUM_CONTRACTS
    else:
        view = ProgramView(spec, overrides=overrides, wrap=wrap,
                           device=device, inputs=inputs, variants=variants,
                           pinned=pinned)
        keys = set(CONTRACTS) - PSUM_CONTRACTS
    findings = []
    for c in CONTRACTS.values():
        if c.key not in keys:
            continue
        if families and c.family not in families:
            continue
        try:
            problems = list(c.check(view) or ())
        except Exception as e:  # noqa: BLE001 — a crashed check IS a finding
            findings.append(Finding(c.key, "error", spec.name,
                                    f"contract check crashed: "
                                    f"{type(e).__name__}: {e}",
                                    {"crashed": True}))
            continue
        for msg, details in problems:
            findings.append(Finding(c.key, c.severity, spec.name, msg,
                                    details))
    return findings


def check_all(names: Optional[Iterable[str]] = None,
              families: Optional[Iterable[str]] = None, device=None):
    """:func:`check_contracts` over every registered step + psum spec."""
    specs = STEP_SPECS + PSUM_SPECS
    if names:
        specs = tuple(get_spec(n) for n in names)
    out = []
    for s in specs:
        out.extend(check_contracts(s, families=families, device=device))
    return out


def summary_table(findings, configs=None) -> str:
    """Fixed-width per-config x per-family error/warn table (the text the
    CLI and ``examples/quantized_comm_demo.py`` print)."""
    families = sorted({c.family for c in CONTRACTS.values()})
    if configs is None:
        configs = sorted({f.config for f in findings} |
                         {s.name for s in STEP_SPECS + PSUM_SPECS})
    by = {}
    for f in findings:
        by.setdefault((f.config, f.family), []).append(f)
    width = max([len(c) for c in configs] + [6])
    head = "config".ljust(width) + "".join(f"  {fam:>9}" for fam in families)
    lines = [head, "-" * len(head)]
    for cfg in configs:
        row = cfg.ljust(width)
        for fam in families:
            fs = by.get((cfg, fam), [])
            ne = sum(1 for f in fs if f.severity == "error")
            nw = sum(1 for f in fs if f.severity == "warn")
            cell = "ok" if not fs else \
                "/".join(filter(None, [f"{ne}E" if ne else "",
                                       f"{nw}W" if nw else ""])) or "info"
            row += f"  {cell:>9}"
        lines.append(row)
    return "\n".join(lines)
