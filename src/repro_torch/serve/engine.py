"""Batched serving engine: a continuous-batching decode loop over a
fixed-size slot table, with per-slot stop handling.

The port of ``repro/serve/engine.py``, eager under
``torch.inference_mode()`` where the reference jits the step. It keeps the
reference's behaviour token for token, including what its docstring does
not say (ROADMAP Queue 3): ``admit`` only records the prompt, nothing
prefills it, and ``step`` feeds each slot its last token at one shared
position, ``max(lengths) - 1``. So a prompt's earlier tokens never enter
the KV cache, every slot writes the same cache row, and a freed slot's
rows stay as they were.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import ModelBundle


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class ServingEngine:
    """Fixed batch of `slots`; requests stream through free slots."""

    def __init__(self, bundle: ModelBundle, params, *, slots: int = 4,
                 max_len: int = 256):
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.max_len = max_len
        shape = ShapeConfig("serve", max_len, slots, "decode")
        self.state = bundle.serve_state_shape(shape)
        self.tokens = np.zeros((slots, max_len), np.int64)
        self.lengths = np.zeros(slots, np.int64)
        self.active: List[Optional[Request]] = [None] * slots

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
