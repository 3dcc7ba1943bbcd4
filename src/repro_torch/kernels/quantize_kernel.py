"""CUDA kernel wrappers: projection onto a uniform grid, and the wire
encode/decode of pdADMM-G-Q.

Replaces ``repro/kernels/quantize_kernel.py:grid_project`` /
``grid_encode`` / ``grid_decode`` (Pallas bodies ``_project_kernel``,
``_encode_kernel``, ``_decode_kernel``). Source: ``csrc/quantize_grid.cu``.

What bounds it on the H100: bytes. A projection reads and writes 4 bytes
per element for about five operations; at the ×8 block [8, 2485, 1000]
that is 159 MB, about 0.047 ms at 3.35 TB/s. Encode writes 1 or 2 bytes,
decode reads them.

Design: one grid-stride pass, four elements per thread per step with
128-bit loads where the pointers allow, each input read once and each
output written once. The row-predicated forms (``grid_encode_sel``,
``grid_decode_sel``: the mixed-width ring's padded wire) take rows of
their own strides on the grid's second dimension and a device table of
one width index per stage; a row whose stage is not at this width is
skipped before any load, so one launch a width covers every stage. The arithmetic is the jitted reference's bit for bit
(``core/quantize.py`` says which, and why), so kernel and plain version are
held equal bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

# one launch count per entry point (kernels.ops reads them by name)
launches = {"grid_project": 0, "grid_encode": 0, "grid_decode": 0}

_F32 = torch.float32


def _scalars(grid):
    """(lo, step, 1/step) in f32, as ``QuantGrid.*_in(torch.float32)``
    forms them. numpy scalars keep the wrapper's host time per launch
    small, where torch scalars cost tens of µs."""
    lo, step = np.float32(grid.lo), np.float32(grid.step)
    return float(lo), float(step), float(np.float32(1.0) / step)


def grid_project(x, grid):
    """x: float32, any shape -> the nearest grid point, float32."""
    build.require(x, "x")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lo, step, inv = _scalars(grid)
    err = build.library().grid_project_f32(
        x.data_ptr(), out.data_ptr(), x.numel(), lo, step, inv,
        grid.n_levels, build.stream_handle(x))
    build.check(err, "grid_project")
    launches["grid_project"] += 1
    return out


def grid_encode(x, grid):
    """x: float32 -> codes of x's shape, uint8 (<= 8 bits) or uint16."""
    build.require(x, "x")
    if grid.bits > 16:
        raise ValueError(f"no integer code container for {grid.bits} bits")
    out = torch.empty(x.shape, dtype=grid.code_dtype, device=x.device)
    if x.numel() == 0:
        return out
    lo, _, inv = _scalars(grid)
    err = build.library().grid_encode_f32(
        x.data_ptr(), out.data_ptr(), x.numel(), lo, inv, grid.n_levels,
        out.element_size(), build.stream_handle(x))
    build.check(err, "grid_encode")
    launches["grid_encode"] += 1
    return out


def grid_decode(codes, grid, out_dtype=torch.float32):
    """codes: uint8 or uint16 -> lo + codes·step in float32, cast to
    ``out_dtype`` (as the reference decodes)."""
    if codes.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"codes: expected uint8 or uint16, got {codes.dtype}")
    build.require(codes, "codes", dtype=codes.dtype)
    out = torch.empty(codes.shape, dtype=_F32, device=codes.device)
    if codes.numel() == 0:
        return out.to(out_dtype)
    lo, step, _ = _scalars(grid)
    err = build.library().grid_decode_f32(
        codes.data_ptr(), out.data_ptr(), codes.numel(), lo, step,
        codes.element_size(), build.stream_handle(codes))
    build.check(err, "grid_decode")
    launches["grid_decode"] += 1
    return out if out_dtype == _F32 else out.to(out_dtype)


def grid_encode_sel(x, grid, out, sel, k: int):
    """The row-predicated encode: x float32 [rows, n] (rows contiguous, any
    row stride) -> the codes of row r into out[r, :n] (``grid.code_dtype``,
    [rows, >= n], any row stride) for the rows whose stage r % len(sel)
    has sel == k (sel: int32 [stages] on the card); other rows are left as
    they are. Returns ``out``."""
    if grid.bits > 16:
        raise ValueError(f"no integer code container for {grid.bits} bits")
    x2, ld_in = build.row_view(x, "x", _F32)
    o2, ld_out = build.row_view(out, "out", grid.code_dtype)
    rows, n = x2.shape
    if o2.shape[0] != rows or o2.shape[1] < n:
        raise ValueError(f"out: {tuple(o2.shape)} for [{rows}, {n}] codes")
    if n == 0 or rows == 0:
        return out
    stages = build.stage_table(sel, rows, x.device)
    lo, _, inv = _scalars(grid)
    err = build.library().grid_encode_f32_sel(
        x2.data_ptr(), o2.data_ptr(), rows, n, ld_in, ld_out, lo, inv,
        grid.n_levels, out.element_size(), sel.data_ptr(), int(k), stages,
        build.stream_handle(x))
    build.check(err, "grid_encode")
    launches["grid_encode"] += 1
    return out


def grid_decode_sel(codes, grid, out, sel, k: int):
    """The row-predicated decode: the first n = out.shape[-1] codes of each
    row of codes [rows, >= n] (uint8 or uint16, any row stride) -> lo +
    codes·step into out float32 [rows, n] (any row stride) for the rows
    whose stage r % len(sel) has sel == k; other rows are left as they
    are. Returns ``out``."""
    if codes.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"codes: expected uint8 or uint16, got {codes.dtype}")
    c2, ld_in = build.row_view(codes, "codes", codes.dtype)
    o2, ld_out = build.row_view(out, "out", _F32)
    rows, n = o2.shape
    if c2.shape[0] != rows or c2.shape[1] < n:
        raise ValueError(f"codes: {tuple(c2.shape)} for [{rows}, {n}]")
    if n == 0 or rows == 0:
        return out
    stages = build.stage_table(sel, rows, codes.device)
    lo, step, _ = _scalars(grid)
    err = build.library().grid_decode_f32_sel(
        c2.data_ptr(), o2.data_ptr(), rows, n, ld_in, ld_out, lo, step,
        codes.element_size(), sel.data_ptr(), int(k), stages,
        build.stream_handle(codes))
    build.check(err, "grid_decode")
    launches["grid_decode"] += 1
    return out
