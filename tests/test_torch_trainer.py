"""The port's LM trainer (``data.pipeline.TokenPipeline``,
``train.trainer.Trainer``, ``launch.train``) against the JAX reference.

Reduced tinyllama (2 layers, d 64, vocab 256), f32, 32 tokens × 2
sequences, adamw(1e-3), pipeline and init seed 7, on the CPU. Checkpoints
cross between the packages through each one's own ``CheckpointManager``
(the same files), so the reference's random init reaches the port through
a checkpoint.

Tolerances:
* pipeline batches, ``make_inputs``' specs, checkpoint leaves and a
  resume inside one package: bitwise.
* a resume across the packages against the other package's uninterrupted
  run: losses rtol 1e-5; each parameter leaf within a relative L2
  distance of 1e-5 and max |Δ| ≤ 1e-4, a tenth of lr (Adam divides by
  √v, so an element whose gradient is rounding noise moves by up to ~lr
  in either package; see ``tests/test_torch_train.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as j_get_arch
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.train import optim as joptim
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.ckpt.manager import flatten
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import api as tapi
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
S, B, SEED, LR = 32, 2, 7, 1e-3


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _j_trainer(path, steps, fail_at=None):
    cfg = j_get_arch(ARCH).reduced()
    bundle = japi.build(cfg, make_host_mesh(), JShape("t", S, B, "train"),
                        dtype=jnp.float32)
    tc = JTrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(path),
                        log_every=100, fail_at_step=fail_at)
    return JTrainer(bundle, joptim.adamw(LR), JPipe(cfg.vocab, S, B,
                                                     seed=SEED), tc)


def _t_trainer(path, steps, fail_at=None):
    cfg = get_arch(ARCH).reduced()
    bundle = tapi.build(cfg, device="cpu", dtype=torch.float32)
    tc = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(path),
                       log_every=100, fail_at_step=fail_at)
    return Trainer(bundle, optim.adamw(LR),
                   TokenPipeline(cfg.vocab, S, B, seed=SEED, device="cpu"), tc)


def _gen():
    return torch.Generator().manual_seed(SEED)


def _losses(trainer):
    return {h["step"]: h["loss"] for h in trainer.history}


def _assert_params_close(got, want):
    g, w = flatten(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np32(a), _np32(b)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
        assert np.abs(a - b).max() <= 1e-4


# --- data --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("step", [0, 1, 2])
def test_pipeline_batches_bitwise(seed, step):
    want = JPipe(256, 48, 3, seed=seed).batch(step)
    got = TokenPipeline(256, 48, 3, seed=seed, device="cpu").batch(step)
    assert set(got) == {"tokens", "targets", "mask"}
    for k, dt in (("tokens", torch.int32), ("targets", torch.int32),
                  ("mask", torch.float32)):
        assert got[k].dtype == dt and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert not got["mask"][:, -1].any()


def test_pipeline_iterator_walks_the_steps():
    pipe = TokenPipeline(100, 16, 2, seed=3, device="cpu")
    it = pipe.iterator(start_step=5)
    for step in (5, 6, 7):
        b = next(it)
        assert torch.equal(b["tokens"], pipe.batch(step)["tokens"])


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a device the pipeline and the launcher ask for CUDA, and a
    host without it raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(256, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])


# --- inputs and state layout ------------------------------------------------------

def test_train_input_specs_and_make_inputs():
    cfg = get_arch(ARCH).reduced()
    tb = tapi.build(cfg, device="cpu")
    jb = japi.build(j_get_arch(ARCH).reduced(), make_host_mesh(),
                    JShape("t", 64, 4, "train"))
    shape = ShapeConfig("t", 64, 4, "train")
    specs = tb.input_specs(shape)
    want = jb.input_specs(JShape("t", 64, 4, "train"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in specs.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    inputs = tb.make_inputs(shape, torch.Generator().manual_seed(0))
    assert set(inputs) == {"tokens", "targets"}
    for x in inputs.values():
        assert x.shape == (4, 64) and x.dtype == torch.int32
        assert 0 <= int(x.min()) and int(x.max()) < cfg.vocab
    with torch.no_grad():
        params = tb.init(torch.Generator().manual_seed(0))
        assert torch.isfinite(tb.loss(params, inputs))


@pytest.mark.parametrize("name", ["adamw", "adamw8bit"])
def test_train_state_leaves_in_the_reference_order(name):
    """(params, opt.init(params)) flattens to the reference's leaves, in
    order, shape and dtype: the layout of a trainer checkpoint."""
    jb = japi.build(j_get_arch(ARCH).reduced(), make_host_mesh(),
                    JShape("t", S, B, "train"))
    jp = jb.abstract_params()
    jstate = jax.eval_shape(getattr(joptim, name)(LR).init, jp)
    tb = tapi.build(get_arch(ARCH).reduced(), device="cpu")
    tp = tb.init(torch.Generator().manual_seed(0))
    tstate = getattr(optim, name)(LR).init(tp)
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in flatten((tp, tstate))]
    want = [(tuple(a.shape), str(a.dtype))
            for a in jax.tree.leaves((jp, jstate))]
    assert got == want


# --- checkpoints and resume ----------------------------------------------------------

def test_failure_injection_and_resume(tmp_path):
    """The port's own crash at step 4 and resume from the step-3
    checkpoint give the uninterrupted run's parameters, optimizer state
    and losses bit for bit (mirrors
    ``tests/test_systems.py::test_failure_injection_and_resume``)."""
    t_ref = _t_trainer(tmp_path / "ref", 6)
    p_ref, s_ref = t_ref.run(_gen())
    t1 = _t_trainer(tmp_path / "ft", 6, fail_at=4)
    with pytest.raises(RuntimeError, match="injected failure"):
        t1.run(_gen())
    assert t1.ckpt.all_steps() == [1, 3]
    t2 = _t_trainer(tmp_path / "ft", 6)
    p_res, s_res = t2.run(_gen())
    assert [h["step"] for h in t2.history] == [4, 5]
    for a, b in zip(flatten((p_ref, s_ref)), flatten((p_res, s_res))):
        assert torch.equal(a, b)
    ref_losses = _losses(t_ref)
    assert all(ref_losses[s] == loss for s, loss in _losses(t2).items())
    assert t2.ckpt.latest_step() == 5


def test_checkpoint_saves_the_state_it_restores(tmp_path):
    """The final checkpoint holds the returned state leaf for leaf, and a
    trainer with nothing left to run restores it unchanged."""
    t = _t_trainer(tmp_path, 3)
    params, state = t.run(_gen())
    assert t.ckpt.all_steps() == [1, 2]
    again = _t_trainer(tmp_path, 3)
    p2, s2, start = again.init_or_restore(torch.Generator().manual_seed(99))
    assert start == 3
    for a, b in zip(flatten((params, state)), flatten((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resume_reference_checkpoint_in_the_port(tmp_path):
    """The reference's Trainer crashes at step 2 after its step-1
    checkpoint; the port's Trainer restores it and finishes steps 2 and 3
    as the reference's uninterrupted run does."""
    j_ref = _j_trainer(tmp_path / "ref", 4)
    jp, _ = j_ref.run(jax.random.PRNGKey(SEED))
    j_crash = _j_trainer(tmp_path / "x", 4, fail_at=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        j_crash.run(jax.random.PRNGKey(SEED))
    t = _t_trainer(tmp_path / "x", 4)
    tp, _ = t.run(_gen())
    assert [h["step"] for h in t.history] == [2, 3]
    want = _losses(j_ref)
    for step, loss in _losses(t).items():
        np.testing.assert_allclose(loss, want[step], rtol=1e-5)
    _assert_params_close(tp, jp)


def test_resume_port_checkpoint_in_the_reference(tmp_path):
    """The other way round: the port's Trainer crashes at step 2, the
    reference's restores its step-1 checkpoint and finishes as the port's
    uninterrupted run does."""
    t_ref = _t_trainer(tmp_path / "ref", 4)
    tp, _ = t_ref.run(_gen())
    t_crash = _t_trainer(tmp_path / "x", 4, fail_at=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        t_crash.run(_gen())
    j = _j_trainer(tmp_path / "x", 4)
    jp, _ = j.run(jax.random.PRNGKey(0))
    assert [h["step"] for h in j.history] == [2, 3]
    want = _losses(t_ref)
    for step, loss in _losses(j).items():
        np.testing.assert_allclose(loss, want[step], rtol=1e-5)
    for a, b in zip(flatten(tp), jax.tree.leaves(jp)):
        a, b = _np32(a), _np32(b)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(a)
        assert np.abs(a - b).max() <= 1e-4


# --- the launcher -----------------------------------------------------------------

def test_launch_train_reduced_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("done: final loss ")
    assert np.isfinite(float(last.split()[-1]))
    assert (tmp_path / "step_000000002" / "_COMMITTED").exists()
