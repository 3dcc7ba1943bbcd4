"""Fault-tolerant checkpoints: atomic per-leaf ``.npy`` checkpoints with a
manifest, keep-N rotation, and elastic restore.

Counterpart of ``repro.ckpt.manager``, with the same on-disk layout, so a
checkpoint either package writes restores in the other:

  <dir>/step_000000123/
      manifest.json        {step, n_leaves, treedef, shapes, dtypes, extra}
      leaf_00000.npy ...   one file per leaf, host-complete
      _COMMITTED           written LAST: the crash-safe marker

A checkpoint is staged in a ``.tmp_*`` directory and published by one
``os.replace``; stale staging directories are reaped on construction.

Leaves are numbered in the order in which JAX flattens the same structure:
NamedTuple and tuple fields in order, list items in order, dict values by
sorted key, ``None`` holding no leaf. The port cannot write JAX's treedef
string, so ``treedef`` holds its own description of the structure; the
reference's ``restore`` checks only ``n_leaves``.

Elastic restore: leaves are stored host-complete (a ring state is saved
through ``stage_parallel.gather_stack``, which reads data shard 0's W and
b), and the caller shards what ``restore`` returns onto the ring it runs
now (``stage_parallel.shard_stack``), whatever mesh saved it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

# numpy cannot store bfloat16 or fp8: such a leaf is saved as a same-width
# unsigned view and the manifest keeps its true dtype (the reference's rule)
_VIEW_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_TORCH_NAMES = {torch.bfloat16: "bfloat16",
                torch.float8_e4m3fn: "float8_e4m3fn",
                torch.float8_e5m2: "float8_e5m2"}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in flatten(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    return [tree]


def unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def describe(tree) -> str:
    """The manifest's ``treedef``: the structure with ``*`` for a leaf."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(describe(x) for x in tree) + ")"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _to_savable(leaf):
    """A leaf -> (numpy array to write, true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[t.dtype]
            width = torch.int16 if t.element_size() == 2 else torch.uint8
            arr = t.contiguous().view(width).numpy().view(
                _VIEW_DTYPES[name][0])
            return arr, name
        return t.numpy(), t.numpy().dtype.name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name in _VIEW_DTYPES:
        return arr.view(_VIEW_DTYPES[name][0]), name
    return arr, name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_DTYPES:
        width = np.int16 if arr.dtype.itemsize == 2 else np.uint8
        return torch.from_numpy(arr.view(width).copy()).view(
            _VIEW_DTYPES[dtype_name][1])
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # only the atomic rename publishes a checkpoint, so anything still
        # named .tmp_* is a save that died mid-write
        for stale in self.dir.glob(".tmp_*"):
            if stale.is_dir():
                shutil.rmtree(stale, ignore_errors=True)
            else:
                stale.unlink(missing_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        leaves = flatten(tree)
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            shapes, dtypes = [], []
            for i, leaf in enumerate(leaves):
                arr, dtype_name = _to_savable(leaf)
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
                shapes.append(list(arr.shape))
                dtypes.append(dtype_name)
            manifest = {
                "step": step,
                "n_leaves": len(leaves),
                "treedef": describe(tree),
                "shapes": shapes,
                "dtypes": dtypes,
                "extra": extra or {},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "_COMMITTED").write_text("ok")
            final = self.dir / f"step_{step:09d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic on the same file system
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._rotate()
        return final

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- load ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "_COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, device=None):
        """Restore into the structure of ``like``: each leaf takes the dtype
        of ``like``'s leaf at its place and lands on ``device``, or else on
        that leaf's device (the CPU for a leaf that is no tensor). Shapes
        come from the files, not from ``like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves_like = flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint {d} holds {manifest['n_leaves']} "
                             f"leaves; the structure has {len(leaves_like)}")
        out = []
        for i, ref in enumerate(leaves_like):
            t = _from_saved(np.load(d / f"leaf_{i:05d}.npy"),
                            manifest["dtypes"][i])
            if isinstance(ref, torch.Tensor):
                t = t.to(device=device if device is not None else ref.device,
                         dtype=ref.dtype)
            elif device is not None:
                t = t.to(device)
            out.append(t)
        return unflatten(like, out), manifest

    def restore_extra(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        d = self.dir / f"step_{step:09d}"
        return json.loads((d / "manifest.json").read_text())["extra"]
