"""Dispatch for the port's kernels, by device alone.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``. Any
other tensor goes to the hand-written CUDA kernel, whose wrapper launches it
or raises (wrong device, dtype, shape or layout, or a launch error). There
is no policy switch and no fallback: on the card, the kernels are the path.

The TPU path's pad-to-tile plan has no counterpart: the CUDA kernels mask
their ragged edges themselves.

Every dispatch function runs inside :class:`scope`, which a step recorder
(``analysis.torch_trace``) listens to: one scope is one launch of that
kernel on the card, whichever version computes it, so a trace on the CPU
counts the launches the card would make.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (admm_pgrad as _pg, backtrack_phi as _bt,
                                 fista_zlast as _fz, flash_attention as _fa,
                                 fused_linear as _fl, pack_codes as _pc,
                                 quantize_kernel as _qk, ref,
                                 relu_zupdate as _zu)

# Kernel name -> its wrapper module. A module's ``launches`` is an int, or a
# dict keyed by kernel name where one module wraps several entry points.
KERNEL_MODULES = {
    "fused_linear": _fl,
    "admm_pgrad": _pg,
    "relu_zupdate": _zu,
    "fista_zlast": _fz,
    "backtrack_resnorm": _bt,
    "grid_project": _qk,
    "grid_encode": _qk,
    "grid_decode": _qk,
    "pack_codes": _pc,
    "unpack_codes": _pc,
    "flash_attention": _fa,
}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset (CUDA launches only)."""
    return {name: (mod.launches[name] if isinstance(mod.launches, dict)
                   else mod.launches)
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        if isinstance(mod.launches, dict):
            mod.launches[name] = 0
        else:
            mod.launches = 0


def add_launch_counts(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (kernel name -> launches) to the
    counters: the launches a CUDA graph replay made without running the
    wrappers (``core.graphs``)."""
    for name, n in counts.items():
        mod = KERNEL_MODULES[name]
        if isinstance(mod.launches, dict):
            mod.launches[name] += n * times
        else:
            mod.launches += n * times


# the step recorders listening to kernel scopes (innermost last)
_recorders = []


class scope:
    """One call of kernel ``name`` on ``inputs``; ``launches=False`` where
    the wrapper returns without a launch (empty inputs, 8-bit codes that
    are their own container). Costs one list test when nothing records."""

    __slots__ = ("name", "inputs", "launches", "rec")

    def __init__(self, name: str, *inputs, launches: bool = True):
        self.name, self.inputs, self.launches = name, inputs, launches
        self.rec = None

    def __enter__(self):
        if _recorders:
            self.rec = _recorders[-1]
            self.rec.enter_kernel(self.name, self.inputs, self.launches)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.exit_kernel()
        return False


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _packs(bits: int) -> bool:
    """8-bit codes are their own container: no pack/unpack launch."""
    return not 4 < bits <= 8


def fused_linear(p, W, b=None, z=None, *, mode="linear"):
    """p @ W + b (``b=None``: no bias) or z - (p @ W + b); optional leading
    layer axis."""
    with scope("fused_linear", p, W, b, z):
        if _on_cpu(p):
            return ref.fused_linear_ref(p, W, b, z, mode=mode)
        return _fl.fused_linear(p, W, b, z, mode=mode)


def admm_pgrad(r, W, u, p, q, *, nu, rho):
    """-ν (r @ Wᵀ) + u + ρ (p - q); optional leading layer axis."""
    with scope("admm_pgrad", r, W, u, p, q):
        if _on_cpu(r):
            return ref.admm_pgrad_ref(r, W, u, p, q, nu=nu, rho=rho)
        return _pg.admm_pgrad(r, W, u, p, q, nu=nu, rho=rho)


def relu_zupdate(a, q, z_old):
    """Eq.-6 ReLU z-update, elementwise over any shape (the stacked
    [L-1, V, h] block is one launch)."""
    with scope("relu_zupdate", a, q, z_old):
        if _on_cpu(a):
            return ref.relu_zupdate_ref(a, q, z_old)
        return _zu.relu_zupdate(a, q, z_old)


def fista_zlast(a, z_old, labels, label_mask, *, nu, n_iters=15,
                n_classes=None):
    """z_L solve (Eq. 7): min_z R(z;y) + (ν/2)||z − a||², R the masked CE
    over z[:, :n_classes] (default: the full width)."""
    with scope("fista_zlast", a, z_old, labels, label_mask):
        if _on_cpu(a):
            return ref.fista_zlast_ref(a, z_old, labels, label_mask, nu=nu,
                                       n_iters=n_iters, n_classes=n_classes)
        C = a.shape[-1] if n_classes is None else int(n_classes)
        return _fz.fista_zlast(a, z_old, labels, label_mask, nu=float(nu),
                               n_iters=int(n_iters), n_classes=C)


def backtrack_resnorm(r0, d, W, active=None):
    """||r0 − d @ W||² per layer (f32 [L] or 0-d); ``active`` (bool or int,
    the leading shape) zeroes and skips the layers whose search stopped."""
    with scope("backtrack_resnorm", r0, d, W, active):
        if _on_cpu(d):
            return ref.backtrack_resnorm_ref(r0, d, W, active)
        if active is not None:
            active = active.to(torch.int32)
        return _bt.backtrack_resnorm(r0, d, W, active)


def grid_project(x, grid):
    """Nearest point of ``grid``, elementwise over any shape."""
    with scope("grid_project", x, launches=x.numel() > 0):
        if _on_cpu(x):
            return ref.grid_project_ref(x, grid)
        return _qk.grid_project(x, grid)


def grid_encode(x, grid):
    """Wire codes of x on ``grid`` (uint8 <= 8 bits, uint16 above)."""
    with scope("grid_encode", x, launches=x.numel() > 0):
        if _on_cpu(x):
            return ref.grid_encode_ref(x, grid)
        return _qk.grid_encode(x, grid)


def grid_decode(codes, grid, out_dtype=torch.float32):
    """Grid values of wire codes."""
    with scope("grid_decode", codes, launches=codes.numel() > 0):
        if _on_cpu(codes):
            return ref.grid_decode_ref(codes, grid, out_dtype)
        return _qk.grid_decode(codes, grid, out_dtype)


def grid_encode_sel(x, grid, out, sel, k: int):
    """Wire codes of the rows of x [rows, n] into out[:, :n] where row r's
    stage (r % len(sel)) has sel == k; one launch whatever ``sel`` holds
    (the padded wire's width branch)."""
    with scope("grid_encode", x, sel, launches=x.numel() > 0):
        if _on_cpu(x):
            return ref.grid_encode_sel_ref(x, grid, out, sel, k)
        return _qk.grid_encode_sel(x, grid, out, sel, k)


def grid_decode_sel(codes, grid, out, sel, k: int):
    """Grid values of each row's first out.shape[-1] codes into ``out``
    where the row's stage has sel == k; one launch."""
    with scope("grid_decode", codes, sel, launches=out.numel() > 0):
        if _on_cpu(codes):
            return ref.grid_decode_sel_ref(codes, grid, out, sel, k)
        return _qk.grid_decode_sel(codes, grid, out, sel, k)


def pack_codes(codes, bits: int):
    """Integer codes [n] or [rows, n] -> their uint8 wire container, each
    row on its own (4-bit half-split nibbles, 8-bit identity, 16-bit
    big-endian planes)."""
    with scope("pack_codes", codes,
               launches=_packs(bits) and codes.numel() > 0):
        if _on_cpu(codes):
            return ref.pack_codes_ref(codes, bits)
        return _pc.pack_codes(codes, bits)


def unpack_codes(packed, bits: int, n: int):
    """The first ``n`` codes of each packed row (uint8 <= 8 bits, uint16
    above)."""
    rows = packed.shape[0] if packed.dim() == 2 else 1
    with scope("unpack_codes", packed,
               launches=_packs(bits) and rows * n > 0):
        if _on_cpu(packed):
            return ref.unpack_codes_ref(packed, bits, n)
        return _pc.unpack_codes(packed, bits, n)


def pack_codes_sel(codes, bits: int, out, sel, k: int):
    """Pack codes [rows, n] into the head of each row of ``out`` whose
    stage has sel == k (4 or 16 bits); one launch."""
    with scope("pack_codes", codes, sel, launches=codes.numel() > 0):
        if _on_cpu(codes):
            return ref.pack_codes_sel_ref(codes, bits, out, sel, k)
        return _pc.pack_codes_sel(codes, bits, out, sel, k)


def unpack_codes_sel(packed, bits: int, out, sel, k: int):
    """Unpack each row's first out.shape[-1] codes into ``out`` where the
    row's stage has sel == k (4 or 16 bits); one launch."""
    with scope("unpack_codes", packed, sel, launches=out.numel() > 0):
        if _on_cpu(packed):
            return ref.unpack_codes_sel_ref(packed, bits, out, sel, k)
        return _pc.unpack_codes_sel(packed, bits, out, sel, k)


def flash_attention(q, k, v, *, causal=True, q_offset=0):
    """Exact softmax attention, q [B, S, Hq, D] against k, v [B, T, Hkv, D]
    (GQA by head index), keys j <= i + q_offset when causal."""
    with scope("flash_attention", q, k, v,
               launches=q.shape[0] * q.shape[1] > 0):
        if _on_cpu(q):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           q_offset=q_offset)
        return _fa.flash_attention(q, k, v, causal=causal,
                                   q_offset=q_offset)
