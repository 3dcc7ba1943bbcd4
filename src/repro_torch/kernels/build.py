"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch headers,
so the build takes seconds). The build runs at first use, one ``nvcc``
process per source started together, then one link. The library lands in
``<repo>/build/repro_torch/<hash>/``, keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is loaded as is.

Nothing here runs at import: the CPU tests import every module on a host
with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every entry point returns a cudaError_t.
SIGNATURES = {
    "fused_linear_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _I, _P, _I, _P],
    "admm_pgrad_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _LL, _LL, _LL, _F, _F, _I, _P],
    "relu_zupdate_f32": [_P, _P, _P, _P, _LL, _P],
    "fista_zlast_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I,
                        _F, _F, _P],
    "backtrack_resnorm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _LL, _LL, _LL, _I, _I, _P],
    "grid_project_f32": [_P, _P, _LL, _F, _F, _F, _I, _P],
    "grid_encode_f32": [_P, _P, _LL, _F, _F, _I, _I, _P],
    "grid_decode_f32": [_P, _P, _LL, _F, _F, _I, _P],
    "grid_encode_f32_sel": [_P, _P, _LL, _LL, _LL, _LL, _F, _F, _I, _I,
                            _P, _I, _LL, _P],
    "grid_decode_f32_sel": [_P, _P, _LL, _LL, _LL, _LL, _F, _F, _I,
                            _P, _I, _LL, _P],
    "pack_codes4": [_P, _P, _LL, _LL, _LL, _LL, _P],
    "unpack_codes4": [_P, _P, _LL, _LL, _LL, _LL, _P],
    "pack_codes16": [_P, _P, _LL, _LL, _LL, _LL, _P],
    "unpack_codes16": [_P, _P, _LL, _LL, _LL, _LL, _P],
    "pack_codes4_sel": [_P, _P, _LL, _LL, _LL, _LL, _P, _I, _LL, _P],
    "unpack_codes4_sel": [_P, _P, _LL, _LL, _LL, _LL, _P, _I, _LL, _P],
    "pack_codes16_sel": [_P, _P, _LL, _LL, _LL, _LL, _P, _I, _LL, _P],
    "unpack_codes16_sel": [_P, _P, _LL, _LL, _LL, _LL, _P, _I, _LL, _P],
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, ctypes.POINTER(_LL), _P],
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a host with the CUDA toolkit")
    return nvcc


def compile_commands(nvcc: str, obj_dir: pathlib.Path) -> list:
    """One ``nvcc -c`` per source, all independent."""
    return [[nvcc, *ARCH, *CFLAGS, "-c", str(src), "-o",
             str(obj_dir / (src.stem + ".o"))] for src in sources()]


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return its path.
    ptxas's register/spill report goes to ``build.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp = pathlib.Path(tmp)
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in compile_commands(nvcc, tmp)]
        # wait for every compile before reporting any failure
        log = [" ".join(cmd) + "\n" + proc.communicate()[0]
               for cmd, proc in procs]
        for (_, proc), text in zip(procs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
        objs = [str(tmp / (src.stem + ".o")) for src in sources()]
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME), *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log[-1]}")
        (out.parent / "build.log").write_text("\n".join(log))
        os.replace(tmp / LIB_NAME, out)   # atomic: a reader sees all or none
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(t, name: str, shape=None, dtype=None) -> None:
    """Validate a kernel operand before its pointer goes to C: a contiguous
    CUDA tensor of the expected dtype (f32 unless given) and shape."""
    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def row_view(t, name: str, dtype):
    """A 1-D or 2-D CUDA operand of ``dtype`` as [rows, cols] and its row
    stride in elements (rows contiguous, any row stride)."""
    if t.dim() not in (1, 2):
        raise ValueError(f"{name}: expected [n] or [rows, n], got "
                         f"{tuple(t.shape)}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    t2 = t if t.dim() == 2 else t.unsqueeze(0)
    if t2.shape[-1] > 1 and t2.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    return t2, (t2.stride(0) if t2.shape[0] > 1 else t2.shape[-1])


def stage_table(sel, rows: int, device) -> int:
    """Check a predicated launch's ``sel`` (int32 [stages] on ``device``,
    contiguous, ``stages`` dividing ``rows``); returns ``stages``."""
    if sel.dim() != 1 or sel.dtype != torch.int32 or not sel.is_contiguous():
        raise ValueError(f"sel: expected a contiguous int32 [stages], got "
                         f"{tuple(sel.shape)} {sel.dtype}")
    if sel.device != device:
        raise ValueError(f"sel: on {sel.device}, the rows on {device}")
    stages = sel.numel()
    if stages < 1 or rows % stages:
        raise ValueError(f"sel: {stages} stages for {rows} rows")
    return stages


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer value. The
    raw handle (as Triton's launcher reads it): building a
    ``torch.cuda.Stream`` to read ``.cuda_stream`` costs as much host time
    a launch as the smallest kernels take on the card."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
