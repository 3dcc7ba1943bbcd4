"""The port's kernel names against ``chip_smoke.PORT_KERNEL_NAMES``, the
prefixes by which its profiles group a trace's kernels as the port's.

Every ``__global__`` function in ``src/repro_torch/kernels/csrc`` must start
with one of them (a kernel that starts with none is counted among
PyTorch's in every profile), and every prefix must start some kernel. The
tuple is read from the script's source with ``ast``; the script is not
imported (it needs a card).
"""
import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
# __global__ void [__launch_bounds__(...)] name(   (launch bounds may nest
# one level of parentheses)
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def _kernels():
    found = []
    for path in SOURCES:
        text = _COMMENT.sub("", path.read_text())
        found += [(path.name, name) for name in _KERNEL.findall(text)]
    return found


def _port_kernel_names():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None)
                == "PORT_KERNEL_NAMES"):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py assigns no PORT_KERNEL_NAMES")


KERNELS = _kernels()
NAMES = _port_kernel_names()


def test_sources_declare_kernels():
    assert len(SOURCES) >= 8
    # one count per source that launches anything: each .cu has a kernel
    assert {f for f, _ in KERNELS} == {p.name for p in CSRC.glob("*.cu")}
    assert isinstance(NAMES, tuple) and all(isinstance(k, str) for k in NAMES)


@pytest.mark.parametrize("source,kernel", KERNELS,
                         ids=[f"{f}:{k}" for f, k in KERNELS])
def test_every_kernel_starts_with_a_port_name(source, kernel):
    """A prefix, not any substring: ``pack4_kernel`` inside
    ``unpack4_kernel`` is a match by accident."""
    assert any(kernel.startswith(k) for k in NAMES), (
        f"{source}: {kernel} starts with none of PORT_KERNEL_NAMES")


@pytest.mark.parametrize("name", NAMES)
def test_every_port_name_starts_a_kernel(name):
    assert any(kernel.startswith(name) for _, kernel in KERNELS), (
        f"PORT_KERNEL_NAMES entry {name!r} starts no kernel in {CSRC}")


@pytest.mark.parametrize("kernel,prefix", [
    ("admm_pgrad_narrow", "admm_pgrad_"), ("admm_pgrad_tc", "admm_pgrad_"),
    ("unpack4_kernel", "unpack4_kernel"),
    ("unpack16_kernel", "unpack16_kernel"), ("pack4_kernel", "pack4_kernel"),
    ("pack16_kernel", "pack16_kernel")])
def test_redesigned_kernels_keep_their_groups(kernel, prefix):
    assert ("pack_codes.cu" if "pack" in kernel else "admm_pgrad.cu",
            kernel) in KERNELS
    assert prefix in NAMES
