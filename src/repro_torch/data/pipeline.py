"""LM data pipeline: a deterministic synthetic corpus, one global batch a
step.

The port of ``repro/data/pipeline.py``. The tokens are drawn with numpy
exactly as the reference draws them (Zipf 1.3 unigrams, then a 30% mask
that copies an affine map of the previous token, seeded by
``(seed << 32) ^ step``), so every batch is bitwise the reference's. Any
host can regenerate any step's batch, so a checkpoint needs no data-loader
state beyond the step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 32) ^ step)

    def batch(self, step: int) -> dict:
        """The global batch of ``step`` on this pipeline's device:
        ``tokens`` and ``targets`` (the tokens shifted left by one) int32
        [B, S], ``mask`` f32 [B, S] with the last position 0."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # Zipf marginal + order-1 structure: tok[t] ~ f(tok[t-1]) mostly
        base = (rng.zipf(1.3, size=(B, S)) - 1) % V
        prev = np.roll(base, 1, axis=1)
        copy_mask = rng.random((B, S)) < 0.3
        toks = np.where(copy_mask, (prev * 7 + 11) % V, base).astype(np.int32)
        targets = np.roll(toks, -1, axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {k: torch.from_numpy(a).to(self.device)
                for k, a in (("tokens", toks), ("targets", targets),
                             ("mask", mask))}

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
