"""The (data, model) mesh of the stage-parallel runtime, and its rings.

Counterpart of ``repro.launch.mesh.compat_make_mesh`` plus what
``shard_map`` hands the reference's step body: the shard's position on each
named axis, the ring shift (``ppermute``) and the collectives (``psum``,
``pmin``, ``pmax``, ``all_gather``).

Shard layout. A tensor the ring works on leads with two shard axes,
``[data, model]``, of the sizes this process holds:

  * :class:`LocalRing` holds every shard in one process (the one card):
    tensors are ``[D, S, ...]`` and every collective is a reduction over
    those leading axes on the device. A shift moves the encoded payload one
    step along the model axis as a real copy (``torch.roll``).
  * :class:`ProcessGroupRing` is one process per shard over
    ``torch.distributed``: tensors are ``[1, 1, ...]``, a shift is an
    ``isend``/``irecv`` pair started at once and waited on at ``finish``,
    and collectives are ``all_reduce`` / ``all_gather`` on the axis's group.
    It runs with gloo on the CPU; with NCCL on several cards the same code
    applies, unverified so far.

Both run the same step body (``parallel.stage_parallel``), and both count
in ``shifted_bytes`` the payload bytes their shifts have sent (from the
tensors' sizes, on the host): on a :class:`LocalRing` that is every
shard's, on a :class:`ProcessGroupRing` this rank's. Shard ``(d, s)``
of a ``ProcessGroupRing`` is rank ``d * model + s``, the row-major order of
the reference's device mesh.

The stacked state's global layout is the reference's: layers ``[L, ...]``
over the model axis (``m = L / model`` per stage), node rows ``[V, ...]``
over the data axis (``V / data`` per shard). :meth:`to_local` and
:meth:`to_global` convert by a spec: ``"rows"`` (``P(dp)``: data-sharded,
model-replicated), ``"layers_rows"`` (``P("model", dp)``) and ``"layers"``
(``P("model")``: W and b, held per data shard — the reference's devices
keep their own copy, and a host read returns data shard 0's).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import List, Sequence

import torch

from repro_torch import resolve_device

AXES = ("data", "model")
SPECS = ("rows", "layers_rows", "layers")
# every LocalRing alive: a CUDA graph replay advances their byte counts
# (core.graphs), since a replay runs no Python
_LOCAL_RINGS = weakref.WeakSet()


def live_local_rings() -> list:
    return list(_LOCAL_RINGS)


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """A (data, model) mesh: ``data`` node-row shards times ``model``
    layer stages."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> dict:
        """Axis name -> size, as the reference's ``mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def _dims(axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; expected {AXES}")
    return tuple(AXES.index(a) for a in axes)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} shards")
    return n // parts


def _roll(t, delta: int, dim: int):
    """``torch.roll`` of any payload: CUDA has no roll for uint16 (16-bit
    grid codes), so those bits move as int16."""
    if t.dtype == torch.uint16:
        return torch.roll(t.view(torch.int16), shifts=delta,
                          dims=dim).view(torch.uint16)
    return torch.roll(t, shifts=delta, dims=dim)


class LocalRing:
    """Every shard of ``mesh`` in this process: tensors lead with
    ``[data, model]`` at full size, on ``device``."""

    def __init__(self, mesh: StageMesh, device=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.shifted_bytes = 0
        _LOCAL_RINGS.add(self)

    # -- where this process sits ------------------------------------------
    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def axis_index(self, axis: str) -> List[int]:
        """The global indices on ``axis`` of the shards held here."""
        return list(range(self.mesh.shape[axis]))

    # -- the ring shift ----------------------------------------------------
    def shift(self, tensors: Sequence[torch.Tensor], delta: int,
              axis: str = "model", tag: int = 0):
        """Start moving each tensor from shard i to shard i + delta along
        ``axis``; returns the in-flight handle :meth:`finish` takes. Here
        the move is a copy on the device, so it has landed on return."""
        (dim,) = _dims(axis)
        self.shifted_bytes += sum(t.nbytes for t in tensors)
        return [_roll(t, delta, dim) for t in tensors]

    def finish(self, handle) -> List[torch.Tensor]:
        return handle

    def drain(self) -> None:
        """Nothing is ever in flight here (see ``ProcessGroupRing.drain``)."""

    # -- collectives ---------------------------------------------------------
    def psum(self, x, axes):
        """Sum over the named shard axes; those axes keep size 1. The sum
        keeps x's dtype (an int32 psum wraps in int32, as an all-reduce
        does; ``torch.sum`` alone would widen integers to int64)."""
        dtype = None if x.dtype == torch.bool else x.dtype
        return x.sum(dim=_dims(axes), keepdim=True, dtype=dtype)

    def pmin(self, x, axes):
        return x.amin(dim=_dims(axes), keepdim=True)

    def pmax(self, x, axes):
        return x.amax(dim=_dims(axes), keepdim=True)

    def all_gather(self, x, axis: str):
        """Every shard receives the stack of its ``axis`` peers' tensors,
        as a new axis 2: ``[D, S, ...] -> [D, S, n_axis, ...]``."""
        D, S = x.shape[:2]
        if axis == "data":
            peers = x.transpose(0, 1).unsqueeze(0).expand(D, S, D,
                                                          *x.shape[2:])
        else:
            peers = x.unsqueeze(1).expand(D, S, S, *x.shape[2:])
        return peers.contiguous()

    # -- layout --------------------------------------------------------------
    def to_local(self, x, spec: str):
        """Global tensor -> this ring's shard layout (see the module doc)."""
        D, S = self.mesh.data, self.mesh.model
        x = x.to(self.device)
        if spec == "rows":
            Vd = _split(x.shape[0], D, "rows")
            return x.reshape(D, 1, Vd, *x.shape[1:])
        m = _split(x.shape[0], S, "layers")
        if spec == "layers":
            return x.reshape(1, S, m, *x.shape[1:]).expand(
                D, S, m, *x.shape[1:]).contiguous()
        if spec == "layers_rows":
            Vd = _split(x.shape[1], D, "rows")
            return x.reshape(S, m, D, Vd, *x.shape[2:]) \
                .movedim(2, 0).contiguous()
        raise ValueError(f"unknown spec {spec!r}; expected {SPECS}")

    def to_global(self, x, spec: str):
        """This ring's shard layout -> the global tensor a host read of the
        reference returns (``"layers"``: data shard 0's copy)."""
        if spec == "rows":
            return x[:, 0].reshape(-1, *x.shape[3:])
        if spec == "layers":
            return x[0].reshape(-1, *x.shape[3:])
        if spec == "layers_rows":
            D, S, m, Vd = x.shape[:4]
            return x.movedim(0, 2).reshape(S * m, D * Vd, *x.shape[4:])
        raise ValueError(f"unknown spec {spec!r}; expected {SPECS}")


class ProcessGroupRing:
    """One shard of ``mesh`` per process over ``torch.distributed``, whose
    default group must already be initialised with ``mesh.size`` ranks.
    Tensors lead with ``[1, 1]``. Every rank builds the same axis groups, in
    the same order, at construction."""

    def __init__(self, mesh: StageMesh, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupRing needs "
                               "torch.distributed.init_process_group first")
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"world size {dist.get_world_size()} != mesh "
                             f"size {mesh.size}")
        self.dist = dist
        self.mesh = mesh
        self.device = resolve_device(device)
        self.rank = dist.get_rank()
        self.shifted_bytes = 0
        self.in_flight = []     # shift handles not yet finished
        D, S = mesh.data, mesh.model
        self.coord = {"data": self.rank // S, "model": self.rank % S}
        self.groups = {}
        for d in range(D):
            g = dist.new_group([d * S + s for s in range(S)])
            if d == self.coord["data"]:
                self.groups["model"] = g
        for s in range(S):
            g = dist.new_group([d * S + s for d in range(D)])
            if s == self.coord["model"]:
                self.groups["data"] = g

    def _rank_of(self, data: int, model: int) -> int:
        return data * self.mesh.model + model

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def axis_index(self, axis: str) -> List[int]:
        return [self.coord[axis]]

    def shift(self, tensors, delta: int, axis: str = "model", tag: int = 0):
        n = self.mesh.shape[axis]
        self.shifted_bytes += sum(t.nbytes for t in tensors)
        if n == 1:
            return [t.clone() for t in tensors]
        me = dict(self.coord)
        dst = dict(me, **{axis: (me[axis] + delta) % n})
        src = dict(me, **{axis: (me[axis] - delta) % n})
        dst_r = self._rank_of(dst["data"], dst["model"])
        src_r = self._rank_of(src["data"], src["model"])
        sent = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sent]
        works = []
        for i, (t, b) in enumerate(zip(sent, bufs)):
            works.append(self.dist.isend(t, dst_r, tag=tag * 16 + i))
            works.append(self.dist.irecv(b, src_r, tag=tag * 16 + i))
        handle = (sent, bufs, works)
        self.in_flight.append(handle)
        return handle

    def finish(self, handle):
        _, bufs, works = handle
        for w in works:
            w.wait()
        self.in_flight = [h for h in self.in_flight if h is not handle]
        return bufs

    def drain(self) -> None:
        """Finish every shift still in flight: a carried pair that its
        caller drops (superseded by a re-prime, or the tail of a run).
        Gloo pairs a send with a receive by peer and tag in posting order,
        and a transfer reads and writes its tensors until it completes; a
        handle dropped unfinished would leave its buffers to the garbage
        collector mid-transfer and its messages to be matched by the next
        shift on that tag. Seen as a gloo timeout in the collective after
        such a run, on a loaded host."""
        while self.in_flight:
            self.finish(self.in_flight[0])

    def _reduce(self, x, axes, op):
        out = x.clone()
        for a in ((axes,) if isinstance(axes, str) else axes):
            _dims(a)
            if self.mesh.shape[a] > 1:
                self.dist.all_reduce(out, op=op, group=self.groups[a])
        return out

    def psum(self, x, axes):
        return self._reduce(x, axes, self.dist.ReduceOp.SUM)

    def pmin(self, x, axes):
        return self._reduce(x, axes, self.dist.ReduceOp.MIN)

    def pmax(self, x, axes):
        return self._reduce(x, axes, self.dist.ReduceOp.MAX)

    def all_gather(self, x, axis: str):
        _dims(axis)
        x = x.contiguous()
        n = self.mesh.shape[axis]
        if n == 1:
            return x.unsqueeze(2).clone()
        parts = [torch.empty_like(x) for _ in range(n)]
        self.dist.all_gather(parts, x, group=self.groups[axis])
        return torch.stack(parts, dim=2)

    def to_local(self, x, spec: str):
        D, S = self.mesh.data, self.mesh.model
        d, s = self.coord["data"], self.coord["model"]
        x = x.to(self.device)
        if spec == "rows":
            Vd = _split(x.shape[0], D, "rows")
            return x[d * Vd:(d + 1) * Vd][None, None].contiguous()
        m = _split(x.shape[0], S, "layers")
        piece = x[s * m:(s + 1) * m]
        if spec == "layers":
            return piece[None, None].contiguous()
        if spec == "layers_rows":
            Vd = _split(x.shape[1], D, "rows")
            return piece[:, d * Vd:(d + 1) * Vd][None, None].contiguous()
        raise ValueError(f"unknown spec {spec!r}; expected {SPECS}")

    def to_global(self, x, spec: str):
        """Gather every rank's shard and assemble the global tensor (every
        rank gets it)."""
        if spec not in SPECS:
            raise ValueError(f"unknown spec {spec!r}; expected {SPECS}")
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.mesh.size)]
        self.dist.all_gather(parts, x)
        D, S = self.mesh.data, self.mesh.model
        full = torch.cat(parts, dim=0).reshape(D, S, *x.shape[2:])
        if spec == "rows":
            return full[:, 0].reshape(-1, *x.shape[3:])
        if spec == "layers":
            return full[0].reshape(-1, *x.shape[3:])
        return full.movedim(0, 2).reshape(S * x.shape[2], D * x.shape[3],
                                          *x.shape[4:])
