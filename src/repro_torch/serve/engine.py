"""Batched serving engine: a continuous-batching decode loop over a
fixed-size slot table, with per-slot stop handling.

The port of ``repro/serve/engine.py``. It keeps the reference's behaviour
token for token, including what its docstring does not say (ROADMAP
Queue 3): ``admit`` only records the prompt, nothing prefills it, and
``step`` feeds each slot its last token at one shared position,
``max(lengths) - 1``. So a prompt's earlier tokens never enter the KV
cache, every slot writes the same cache row, and a freed slot's rows stay
as they were.

The reference jits ``serve_step`` with ``length`` traced. Here a meshless
bundle on a CUDA card captures one decode step as a CUDA graph
(:func:`decode_program`, on ``core.graphs``' machinery) once for the
engine's life and replays it once a token: the host writes the tokens and
the length into the program's device inputs, one replay runs the step
(the position read on the device in every family), and the greedy next
tokens reach the host in one copy. On the CPU, or with ``jit=False``, the
engine runs the eager step under ``torch.inference_mode()``. A bundle on
a ``DeviceMesh`` keeps the eager step; asking it for the graph raises.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import graphs
from repro_torch.models import layers
from repro_torch.models.api import ModelBundle

# id(bundle) -> {signature: DecodeProgram}; an entry goes with its bundle
_DECODE: Dict[int, Dict[tuple, "DecodeProgram"]] = {}
MESH_REFUSAL = ("a CUDA graph of the decode step on a DeviceMesh is not "
                "ported (ROADMAP Queue 1 item 2, the mesh's compiled "
                "decode); pass jit=False for the eager step")


def _decode_fn(bundle: ModelBundle):
    """The step a program captures: ``serve_step`` at the device
    ``length``, the logits copied into the program's logits buffer, the
    greedy next tokens [B] as its metrics. A KV cache's ``length`` field
    stays what the buffers hold: the position is an input, not state.
    The bundle is held weakly, so a cached program does not keep it."""
    ref = weakref.ref(bundle)
    vocab = bundle.cfg.vocab

    def decode(state, params, token, length, positions, logits):
        batch = {"token": token}
        if positions is not None:
            batch["positions"] = positions
        out, new = ref().serve_step(params, state, batch, length=length)
        logits.copy_(out)
        if isinstance(new, (layers.KVCache, layers.KVCacheQ)):
            new = new._replace(length=state.length)
        return new, out[:, 0, :vocab].argmax(dim=-1)
    return decode


class DecodeProgram:
    """One decode step of a meshless bundle over a state held in the
    program's buffers (the caller's state adopted, not cloned), captured
    as a CUDA graph on a CUDA state and run as its eager body on the CPU
    (``core.graphs.ChunkProgram``). Its inputs are device buffers that
    :meth:`step` writes in place before each replay: ``token`` [B, 1]
    int32, ``length`` 0-d int32 and, for the VLM, ``positions`` [B, 1, 3]
    int32. ``logits`` [B, 1, Vp] f32 holds the last step's logits. Every
    call runs under ``torch.inference_mode()``, the buffers being made,
    captured, written and replayed in it."""

    def __init__(self, bundle: ModelBundle, params, state, batch):
        dev = bundle.device
        B = batch["token"].shape[0]
        with torch.inference_mode():
            self.token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            self.length = torch.zeros((), dtype=torch.int32, device=dev)
            self.positions = (torch.zeros(tuple(batch["positions"].shape),
                                          dtype=torch.int32, device=dev)
                              if "positions" in batch else None)
            self.logits = torch.zeros((B, 1, bundle.vocab_padded),
                                      dtype=torch.float32, device=dev)
            # host staging of the inputs: pinned on a card, so that a
            # write is one asynchronous copy (each step ends in the host's
            # read of its tokens, after which the staging is free again)
            pin = dev.type == "cuda"
            self._host = {name: torch.zeros(t.shape, dtype=t.dtype,
                                            pin_memory=pin)
                          for name, t in self._inputs().items()}
            self._fn = _decode_fn(bundle)
            self.program = graphs.program_for(
                self._fn, state, (params, self.token, self.length,
                                  self.positions, self.logits), 1,
                adopt=True)
            self.program.buffers.load(state)

    def _inputs(self) -> dict:
        out = {"token": self.token, "length": self.length}
        if self.positions is not None:
            out["positions"] = self.positions
        return out

    def _put(self, name: str, value) -> None:
        dst = getattr(self, name)
        if isinstance(value, torch.Tensor) and value.device == dst.device:
            dst.copy_(value)
            return
        host = self._host[name]
        host.copy_(torch.as_tensor(np.asarray(value)).reshape(host.shape))
        dst.copy_(host, non_blocking=True)

    def step(self, token, length, positions=None):
        """One decode step at ``length`` for ``token`` [B, 1] (and the VLM's
        ``positions`` [B, 1, 3]), each a tensor on the device (copied
        there) or host values (staged): one replay (on the CPU one run of
        its body). Returns the greedy next tokens, a numpy [B] int64, in
        one copy."""
        with torch.inference_mode():
            self._put("token", token)
            self._put("length", length)
            if self.positions is not None:
                if positions is None:
                    raise ValueError("this program takes the VLM's "
                                     "positions [B, 1, 3] every step")
                self._put("positions", positions)
            return self.program.iterate(self._fn)

    @property
    def state(self):
        """The state the buffers hold (new tensor objects over them)."""
        return self.program.buffers.state()

    def load(self, state) -> None:
        """Copy ``state`` into the buffers (nothing where it is them)."""
        with torch.inference_mode():
            self.program.buffers.load(state)

    def takes(self, state) -> bool:
        """Whether ``state`` may be loaded into these buffers: it is them,
        or the state they hold is not held elsewhere."""
        leaves, spec = pytree.tree_flatten(state)
        bufs = self.program.buffers
        return str(spec) == str(bufs.spec) and not bufs.lent_alive(leaves)

    @property
    def replays(self) -> int:
        """Graph replays (CUDA) or body runs (CPU) of this program."""
        return self.program.replays


def _signature(params, state, batch) -> tuple:
    return (graphs.state_signature(state),
            tuple((k, tuple(v.shape)) for k, v in sorted(batch.items())),
            tuple(p.data_ptr() for p in pytree.tree_leaves(params)
                  if isinstance(p, torch.Tensor)))


def decode_program(bundle: ModelBundle, params, state, batch
                   ) -> DecodeProgram:
    """The bundle's cached decode program for ``params`` and a state and
    batch of these shapes (``batch``: ``token`` [B, 1] and, for the VLM,
    ``positions`` [B, 1, 3]; its values are not read), with ``state``
    loaded into its buffers: the cached program where its buffers may take
    ``state``, else a new one (captured on a CUDA state) that adopts
    ``state``'s tensors as its buffers, replacing the cached one. Raises
    ``NotImplementedError`` on a mesh."""
    if bundle.on_mesh:
        raise NotImplementedError(MESH_REFUSAL)
    table = _DECODE.get(id(bundle))
    if table is None:
        table = _DECODE[id(bundle)] = {}
        weakref.finalize(bundle, _DECODE.pop, id(bundle), None)
    key = _signature(params, state, batch)
    prog = table.get(key)
    if prog is not None and prog.takes(state):
        prog.load(state)
        return prog
    table.pop(key, None)
    del prog                        # its graph goes before a new capture
    prog = table[key] = DecodeProgram(bundle, params, state, batch)
    return prog


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class ServingEngine:
    """Fixed batch of `slots`; requests stream through free slots.

    ``jit`` (default: wherever it can) replays one captured decode step a
    token (:class:`DecodeProgram`, captured when the engine is made and
    kept for its life) on a meshless bundle whose state lies on a CUDA
    device; on the CPU, and with ``jit=False``, the step runs eagerly. On
    a ``DeviceMesh`` ``jit=True`` raises ``NotImplementedError``."""

    def __init__(self, bundle: ModelBundle, params, *, slots: int = 4,
                 max_len: int = 256, jit: Optional[bool] = None):
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.max_len = max_len
        if jit and bundle.on_mesh:
            raise NotImplementedError(MESH_REFUSAL)
        shape = ShapeConfig("serve", max_len, slots, "decode")
        self.state = bundle.serve_state_shape(shape)
        self.tokens = np.zeros((slots, max_len), np.int64)
        self.lengths = np.zeros(slots, np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.program: Optional[DecodeProgram] = None
        if jit is not False and not bundle.on_mesh and graphs.on_cuda(
                self.state):
            self.program = decode_program(
                bundle, params, self.state,
                {"token": torch.zeros((slots, 1), dtype=torch.int32)})
            self.state = self.program.state

    # -- admission ------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, a in enumerate(self.active):
            if a is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        req.out = []
        self.active[slot] = req
        self.tokens[slot, :] = 0
        self.tokens[slot, : len(req.prompt)] = req.prompt
        self.lengths[slot] = len(req.prompt)
        return True

    # -- decode loop -------------------------------------------------------------
    def step(self):
        """One decode step for all active slots (greedy sampling)."""
        if not any(a is not None for a in self.active):
            return
        # feed each slot its last token; the shared `length` is the max filled
        length = int(self.lengths.max()) - 1
        last = np.array([[self.tokens[i, max(self.lengths[i] - 1, 0)]]
                         for i in range(self.slots)], np.int32)
        if self.program is not None:
            nxt = self.program.step(last, length)
        else:
            batch = {"token": torch.from_numpy(last).to(self.bundle.device)}
            with torch.inference_mode():
                logits, self.state = self.bundle.serve_step(
                    self.params, self.state, batch, length=length)
                nxt = logits[..., : self.bundle.cfg.vocab].argmax(dim=-1)
            nxt = nxt[:, 0].cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            if self.lengths[i] < self.max_len:
                self.tokens[i, self.lengths[i]] = tok
                self.lengths[i] += 1
            if len(req.out) >= req.max_new or self.lengths[i] >= self.max_len:
                self.active[i] = None   # completed; slot freed

    def run(self, requests: List[Request], max_steps: int = 512):
        """Drive a queue of requests to completion; returns rid -> tokens."""
        queue = list(requests)
        steps = 0
        while (queue or any(a is not None for a in self.active)) \
                and steps < max_steps:
            while queue and self.admit(queue[0]):
                queue.pop(0)
            self.step()
            steps += 1
        return {r.rid: (r.out or []) for r in requests}
