"""Isolation of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port never drops to the CPU on
its own."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    from repro_torch.core import pdadmm
    from repro_torch.graph import datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        datasets.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        datasets.synthetic("cora", scale=0.01)
    ds = datasets.tiny(device="cpu")
    X = ds.augmented(2)
    dims = [X.shape[1], 8, ds.n_classes]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdadmm.init_state(0, X, dims, pdadmm.ADMMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdadmm.train(0, X, ds.labels, ds.masks, dims, pdadmm.ADMMConfig(), 1)


def test_tf32_is_off_in_the_port():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
