"""The LM training loop: checkpoint and restart, failure injection,
microbatch accumulation.

The port of ``repro/train/trainer.py``. PyTorch runs eagerly: there is no
jit and no donation. The optimizer returns new trees and rebinding the
names frees the old ones. On a mesh the params, optimizer state and
batch are DTensors: the microbatches split each data shard's rows, and
the summed gradients come to their params' placements (the data-parallel
all-reduce) before the update. Checkpoints go through
``ckpt.manager.CheckpointManager``, whose files either package restores,
so a run the reference saved resumes here and the other way round.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import (make_train_step, on_param_placements,
                                     value_and_grad)
from repro_torch.models.api import ModelBundle
from repro_torch.parallel.sharding import _is_dtensor, on_mesh_of
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


def _batch_shards(x) -> int:
    """The shards of a DTensor's dim 0 (1 for a plain tensor)."""
    if not _is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard
    return math.prod(n for p, n in zip(x.placements, x.device_mesh.shape)
                     if p == Shard(0))


def microbatch(x, i: int, microbatches: int):
    """Microbatch ``i`` of ``microbatches`` along dim 0. A plain batch
    splits into contiguous blocks, as the reference's reshape does; a
    DTensor batch sharded n ways along dim 0 splits each shard's rows
    alike ([n, microbatches, B / (n · microbatches)] and entry i), so
    every microbatch is spread over the data shards and nothing moves.
    With equal token counts a microbatch, both give the same mean."""
    n = _batch_shards(x)
    y = x.reshape((n, microbatches, x.shape[0] // (n * microbatches))
                  + tuple(x.shape[1:]))
    return y[:, i].reshape((x.shape[0] // microbatches,)
                           + tuple(x.shape[1:]))


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
        for i in range(microbatches):
            loss, grads = value_and_grad(
                bundle, params,
                {k: microbatch(x, i, microbatches) for k, x in batch.items()})
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
