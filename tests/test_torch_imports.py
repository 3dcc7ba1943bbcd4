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

    from repro_torch.core import block_admm, gd_baseline, greedy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gd_baseline.train_gd(0, X, ds.labels, ds.masks, dims, "adam", 1e-3, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy.greedy_train(0, X, ds.labels, ds.masks, 8, ds.n_classes, (2,),
                            1, pdadmm.ADMMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        block_admm.init_block_state(lambda W, p: p @ W, torch.zeros(2, 4, 4),
                                    torch.zeros(3, 4), 2, pdadmm.ADMMConfig())

    from repro_torch.configs.base import get_arch
    from repro_torch.examples import serve_lm
    from repro_torch.models import api
    from repro_torch.serve.engine import ServingEngine
    cfg = get_arch("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(api.build(cfg), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])


def test_tf32_is_off_in_the_port():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
