"""CUDA kernel wrappers: integer wire codes into their uint8 container, and
back — the packed payload of the gather all-reduce and of the padded
mixed-width boundary wire.

Replaces ``repro/kernels/pack_codes.py:pack_codes`` / ``unpack_codes``
(Pallas bodies ``_pack4_kernel``, ``_unpack4_kernel``, ``_pack16_kernel``,
``_unpack16_kernel``). Source: ``csrc/pack_codes.cu``.

What bounds it on the H100: bytes, and at the ring's slab sizes the launch.
Packing one [2485, 1000] boundary slab reads 2.5 MB of 4-bit codes and
writes 1.2 MB (about 1.1 µs at 3.35 TB/s); 16-bit codes read 5 MB and write
5 MB (about 3 µs).

Design: one launch formats every row of a [rows, n] batch (one row per
shard's slab), rows on the grid's second dimension. Every load and store
of a row's bulk is 16 bytes wide and 16-byte aligned whatever n and the
row strides (an odd n, a row stride or a row of a wider container leaves
a stream off a 16-byte boundary): each output stream is cut into its
aligned 16-byte chunks, consecutive threads storing consecutive chunks,
and the input is loaded as aligned chunks and realigned by funnel shifts.
Packing realigns in registers (a lane takes its neighbour's chunk by a
warp shuffle): 4-bit codes join the two halves' nibbles on 32-bit words,
16-bit codes pick each plane's bytes with ``__byte_perm``. Unpacking
4-bit codes does the same in registers; 16-bit codes are cut from a span
of both planes staged in shared memory with cp.async. Each stream's head
and tail (under 16 bytes; an odd n's last 4-bit byte joins the tail) go
byte by byte. The 4-bit pack reads the code past an odd end as 0
instead of padding a copy, and unpacking reads each row at its own
stride, so the head of a wider wire container needs no copy. The layout is the wire contract, so kernel and
plain version are held equal byte for byte. 8-bit codes are their own
container: no launch, as on the TPU. The row-predicated forms
(``pack_codes_sel``, ``unpack_codes_sel``: the mixed-width ring's padded
wire) are the same kernels with a device table of one width index per
stage: a row whose stage is not at the launch's width is skipped before
any load, so one launch a packed width covers every stage.
"""
from __future__ import annotations

import torch

from repro_torch.comm.codecs import _body_bytes
from repro_torch.kernels import build

# one launch count per entry point (kernels.ops reads them by name)
launches = {"pack_codes": 0, "unpack_codes": 0}


def pack_codes(codes, bits: int):
    """codes: [n] or [rows, n] (uint8 for <= 8 bits, uint16 above; rows
    contiguous, any row stride), each row packed on its own -> uint8 [body]
    or [rows, body] with body = ``codecs._body_bytes(bits, n)``."""
    if bits > 16:
        raise ValueError(f"no integer wire container for {bits}-bit codes")
    code_dtype = torch.uint8 if bits <= 8 else torch.uint16
    c2, ld_in = build.row_view(codes, "codes", code_dtype)
    rows, n = c2.shape
    nb = _body_bytes(bits, n)
    if 4 < bits <= 8:            # the codes are their own container
        return codes.clone()
    out = torch.empty(codes.shape[:-1] + (nb,), dtype=torch.uint8,
                      device=codes.device)
    if n == 0 or rows == 0:
        return out
    entry = (build.library().pack_codes4 if bits <= 4
             else build.library().pack_codes16)
    err = entry(c2.data_ptr(), out.data_ptr(), rows, n, ld_in, nb,
                build.stream_handle(codes))
    build.check(err, "pack_codes")
    launches["pack_codes"] += 1
    return out


def unpack_codes(packed, bits: int, n: int):
    """packed: uint8 [≥ body] or [rows, ≥ body] (row stride free, rows
    contiguous) -> the first ``n`` codes of each row, [n] or [rows, n],
    uint8 for <= 8 bits and uint16 above."""
    if bits > 16:
        raise ValueError(f"no integer wire container for {bits}-bit codes")
    p2, ld_in = build.row_view(packed, "packed", torch.uint8)
    rows = p2.shape[0]
    nb = _body_bytes(bits, n)
    if p2.shape[1] < nb:
        raise ValueError(f"packed: {p2.shape[1]} bytes per row, {n} codes "
                         f"at {bits} bits need {nb}")
    code_dtype = torch.uint8 if bits <= 8 else torch.uint16
    if 4 < bits <= 8:
        return packed[..., :n].clone()
    out = torch.empty(packed.shape[:-1] + (n,), dtype=code_dtype,
                      device=packed.device)
    if n == 0 or rows == 0:
        return out
    entry = (build.library().unpack_codes4 if bits <= 4
             else build.library().unpack_codes16)
    err = entry(p2.data_ptr(), out.data_ptr(), rows, n, ld_in, n,
                build.stream_handle(packed))
    build.check(err, "unpack_codes")
    launches["unpack_codes"] += 1
    return out


def pack_codes_sel(codes, bits: int, out, sel, k: int):
    """The row-predicated pack: codes [rows, n] (as :func:`pack_codes`
    takes them) into the head of out [rows, >= body] (uint8, any row
    stride), for the rows r whose stage r % len(sel) has sel == k (sel:
    int32 [stages] on the card); other rows are left as they are. 4 and
    16 bits (8-bit codes are their own container). Returns ``out``."""
    if not (bits <= 4 or 8 < bits <= 16):
        raise ValueError(f"no predicated pack for {bits}-bit codes")
    code_dtype = torch.uint8 if bits <= 8 else torch.uint16
    c2, ld_in = build.row_view(codes, "codes", code_dtype)
    o2, ld_out = build.row_view(out, "out", torch.uint8)
    rows, n = c2.shape
    if o2.shape[0] != rows or o2.shape[1] < _body_bytes(bits, n):
        raise ValueError(f"out: {tuple(o2.shape)} for {rows} rows of "
                         f"{_body_bytes(bits, n)} bytes")
    if n == 0 or rows == 0:
        return out
    stages = build.stage_table(sel, rows, codes.device)
    entry = (build.library().pack_codes4_sel if bits <= 4
             else build.library().pack_codes16_sel)
    err = entry(c2.data_ptr(), o2.data_ptr(), rows, n, ld_in, ld_out,
                sel.data_ptr(), int(k), stages, build.stream_handle(codes))
    build.check(err, "pack_codes")
    launches["pack_codes"] += 1
    return out


def unpack_codes_sel(packed, bits: int, out, sel, k: int):
    """The row-predicated unpack: the first n = out.shape[-1] codes of each
    row of packed [rows, >= body] (uint8, any row stride) into out [rows,
    n] (uint8 for 4 bits, uint16 for 16; any row stride), for the rows r
    whose stage r % len(sel) has sel == k; other rows are left as they
    are. Returns ``out``."""
    if not (bits <= 4 or 8 < bits <= 16):
        raise ValueError(f"no predicated unpack for {bits}-bit codes")
    code_dtype = torch.uint8 if bits <= 8 else torch.uint16
    p2, ld_in = build.row_view(packed, "packed", torch.uint8)
    o2, ld_out = build.row_view(out, "out", code_dtype)
    rows, n = o2.shape
    if p2.shape[0] != rows or p2.shape[1] < _body_bytes(bits, n):
        raise ValueError(f"packed: {tuple(p2.shape)} for {rows} rows of "
                         f"{_body_bytes(bits, n)} bytes")
    if n == 0 or rows == 0:
        return out
    stages = build.stage_table(sel, rows, packed.device)
    entry = (build.library().unpack_codes4_sel if bits <= 4
             else build.library().unpack_codes16_sel)
    err = entry(p2.data_ptr(), o2.data_ptr(), rows, n, ld_in, ld_out,
                sel.data_ptr(), int(k), stages, build.stream_handle(packed))
    build.check(err, "unpack_codes")
    launches["unpack_codes"] += 1
    return out
