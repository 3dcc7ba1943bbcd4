"""The LM training loop: checkpoint and restart, failure injection,
microbatch accumulation.

The port of ``repro/train/trainer.py``. PyTorch runs eagerly: there is no
jit and no donation. The optimizer returns new trees and rebinding the
names frees the old ones. On a mesh the params, optimizer state and
batch are DTensors: each microbatch is a block of the batch's rows, as in
the reference, laid out as the batch (``split_microbatches``), and
the summed gradients come to their params' placements (the data-parallel
all-reduce) before the update. Checkpoints go through
``ckpt.manager.CheckpointManager``, whose files either package restores,
so a run the reference saved resumes here and the other way round.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import (make_train_step, on_param_placements,
                                     value_and_grad)
from repro_torch.models.api import ModelBundle
from repro_torch.parallel.sharding import (_is_dtensor, gathered,
                                          on_mesh_of)
from repro_torch.train import optim


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "artifacts/ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    microbatches: int = 1          # gradient accumulation
    grad_compression_bits: int = 0  # 0 = off; 8 = int8 error-feedback psum
    # fault tolerance testing
    fail_at_step: Optional[int] = None   # simulate a crash (tests)
    # straggler mitigation: skip a slow "host"'s microbatch if it exceeds
    # deadline_factor x median step time (simulated via callback hook)
    deadline_factor: float = 3.0


def split_microbatches(x, microbatches: int) -> list:
    """``x``'s ``microbatches`` microbatches along dim 0: contiguous blocks
    of rows, as the reference's reshape splits the batch. A DTensor batch
    is gathered whole once (token ids and positions, a few bytes a
    position) and each block laid out as the batch was. Splitting each
    data shard's rows instead would move nothing, but it makes other
    microbatches: the same mean cross-entropy, another sum of the MoE's
    aux loss, which is a product of means over a microbatch."""
    blocks = gathered(x, 0).reshape(
        (microbatches, -1) + tuple(x.shape[1:])).unbind(0)
    if not _is_dtensor(x):
        return list(blocks)
    return [b.redistribute(x.device_mesh, x.placements) for b in blocks]


def make_accum_train_step(bundle: ModelBundle, opt: optim.Optimizer,
                          microbatches: int, accum_dtype=None):
    """Gradient accumulation over ``microbatches`` splits of the batch dim.

    accum_dtype: dtype of the running gradient sum (default f32; bf16
    halves the accumulator memory — acceptable with few microbatches). The
    sum is divided by ``microbatches`` in f32 and the loss is the mean of
    the microbatches' losses."""
    if microbatches <= 1:
        return make_train_step(bundle, opt)

    adt = accum_dtype or torch.float32

    def step(params, opt_state, batch):
        loss_acc = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                          device=batch["tokens"].device),
                              batch["tokens"])
        grads_acc = tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
        split = {k: split_microbatches(x, microbatches)
                 for k, x in batch.items()}
        for i in range(microbatches):
            loss, grads = value_and_grad(
                bundle, params, {k: x[i] for k, x in split.items()})
            loss_acc = loss_acc + loss
            grads_acc = tree_map(lambda a, g: a + g.to(adt), grads_acc,
                                 grads)
        grads = tree_map(lambda g: g.float() / microbatches, grads_acc)
        grads = on_param_placements(grads, params)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss_acc / microbatches

    return step


class Trainer:
    def __init__(self, bundle: ModelBundle, opt: optim.Optimizer,
                 pipeline: TokenPipeline, cfg: TrainerConfig):
        self.bundle = bundle
        self.opt = opt
        self.pipe = pipeline
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.step_fn = make_accum_train_step(bundle, opt, cfg.microbatches)
        self.history: list = []

    # -- lifecycle -----------------------------------------------------------
    def init_or_restore(self, generator: torch.Generator):
        """Fresh params from ``generator`` (on the bundle's device) and a
        fresh optimizer state, or the latest checkpoint's in their place.
        Returns (params, opt_state, the first step to run)."""
        params = self.bundle.init(generator)
        opt_state = self.opt.init(params)
        start = 0
        if self.ckpt.latest_step() is not None:
            (params, opt_state), manifest = self.ckpt.restore(
                (params, opt_state))
            start = manifest["step"] + 1
        return params, opt_state, start

    def run(self, generator: torch.Generator):
        params, opt_state, start = self.init_or_restore(generator)
        for step in range(start, self.cfg.steps):
            if self.cfg.fail_at_step is not None and step == self.cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.pipe.batch(step)
            t0 = time.time()
            params, opt_state, loss = self.step_fn(params, opt_state, batch)
            loss = float(loss)      # waits for the step on the device
            dt = time.time() - t0
            self.history.append({"step": step, "loss": loss, "sec": dt})
            if step % self.cfg.log_every == 0:
                print(f"step {step:6d} loss {loss:.4f} ({dt*1e3:.0f} ms)",
                      flush=True)
            if (step + 1) % self.cfg.ckpt_every == 0 or step == self.cfg.steps - 1:
                self.ckpt.save(step, (params, opt_state),
                               extra={"loss": loss})
        return params, opt_state
