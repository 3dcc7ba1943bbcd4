"""Source-level static passes: examples staleness and dead code.

Counterpart of ``repro.analysis.static_checks``, pointed at the port
(``src/repro_torch`` and its ``examples/``). Both passes read source
with ``ast`` and emit the
:class:`~repro_torch.analysis.contracts.Finding` records of the trace-level
contract families, so one report holds both.

* :func:`check_examples` — every ``repro_torch.*`` import in the examples
  must resolve, every keyword argument passed to a resolvable
  ``repro_torch`` callable must exist in its signature, and known
  deprecated API spellings are flagged with their replacement.
* :func:`check_deadcode` — unused and duplicate imports and unreachable
  statements. The exemptions live in :data:`DEADCODE_IGNORE`, each with
  its reason.
"""
from __future__ import annotations

import ast
import fnmatch
import importlib
import inspect
import os

from repro_torch.analysis.contracts import Finding

PACKAGE = "repro_torch"

# Deprecated spelling -> the replacement the finding points at.
DEPRECATED_APIS = {
    "comm_bytes_per_iteration":
        "repro_torch.comm.ledger.admm_bytes_per_iteration",
}

# Dead-code exclusions (fnmatch against the repo-relative posix path);
# every entry says WHY the file is exempt.
DEADCODE_IGNORE = {
    "src/repro_torch/configs/*.py":
        "architecture tables kept importable for the serving surface even "
        "where no test instantiates them, so unused symbols are expected",
}


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _py_files(base: str):
    for dirpath, _, names in os.walk(base):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def _ours(module: str) -> bool:
    return module == PACKAGE or module.startswith(PACKAGE + ".")


# ---------------------------------------------------------------------------
# examples staleness
# ---------------------------------------------------------------------------

def _resolve_imports(tree: ast.AST):
    """name -> imported object, for every ``repro_torch.*`` import that
    resolves (the unresolvable ones come back in the errors list)."""
    objs, errors = {}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if not _ours(a.name):
                    continue
                try:
                    mod = importlib.import_module(a.name)
                except Exception as e:  # noqa: BLE001 — report, don't crash
                    errors.append((node.lineno, a.name, None, str(e)))
                    continue
                objs[a.asname or a.name.split(".")[0]] = \
                    mod if a.asname else importlib.import_module(
                        a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if not _ours(node.module or ""):
                continue
            try:
                mod = importlib.import_module(node.module)
            except Exception as e:  # noqa: BLE001
                errors.append((node.lineno, node.module, None, str(e)))
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                if not hasattr(mod, a.name):
                    # `from pkg import submodule`: the attribute exists
                    # only once the submodule itself is imported
                    try:
                        sub = importlib.import_module(
                            f"{node.module}.{a.name}")
                    except Exception as e:  # noqa: BLE001
                        errors.append((node.lineno, node.module, a.name,
                                       str(e) or "attribute does not "
                                                 "exist"))
                        continue
                    objs[a.asname or a.name] = sub
                    continue
                objs[a.asname or a.name] = getattr(mod, a.name)
    return objs, errors


def _call_target(node: ast.Call, objs: dict):
    """The imported object a call resolves to, if any."""
    f = node.func
    if isinstance(f, ast.Name):
        return objs.get(f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        base = objs.get(f.value.id)
        if base is not None:
            return getattr(base, f.attr, None)
    return None


def _stale_kwargs(node: ast.Call, target, rel: str):
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return
    params = sig.parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return
    for kw in node.keywords:
        if kw.arg is not None and kw.arg not in params:
            yield Finding(
                "examples.stale_kwarg", "error", rel,
                f"line {node.lineno}: {getattr(target, '__name__', target)}("
                f"{kw.arg}=...) — no such keyword (signature: {sig})",
                {"line": node.lineno, "kwarg": kw.arg})


def check_examples(root: str, subdir: str = "src/repro_torch/examples"):
    """Import and staleness findings over every script in root/subdir."""
    findings = []
    for path in _py_files(os.path.join(root, subdir)):
        rel = _rel(path, root)
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding("examples.syntax", "error", rel,
                                    f"does not parse: {e}", {}))
            continue
        objs, errors = _resolve_imports(tree)
        for lineno, module, attr, why in errors:
            what = f"{module}.{attr}" if attr else module
            findings.append(Finding(
                "examples.import", "error", rel,
                f"line {lineno}: import of {what} is stale ({why})",
                {"line": lineno, "target": what}))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                target = _call_target(node, objs)
                if target is not None and callable(target):
                    findings.extend(_stale_kwargs(node, target, rel))
            name = None
            if isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.Name):
                name = node.id
            if name in DEPRECATED_APIS:
                findings.append(Finding(
                    "examples.deprecated_api", "warn", rel,
                    f"line {node.lineno}: {name} is deprecated — use "
                    f"{DEPRECATED_APIS[name]}",
                    {"line": node.lineno, "name": name}))
    return findings


# ---------------------------------------------------------------------------
# dead code
# ---------------------------------------------------------------------------

def _import_bindings(tree: ast.AST, *, top_level_only: bool = False):
    """(lineno, bound name, display target) for every import binding.
    ``top_level_only`` keeps module-scope statements only (function-local
    lazy imports are deliberate: they defer heavy module loads)."""
    out = []
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                out.append((node.lineno, a.asname or a.name.split(".")[0],
                            a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    out.append((node.lineno, a.asname or a.name,
                                f"{node.module}.{a.name}"))
    return out


def _used_names(tree: ast.AST):
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)          # __all__ entries, doc references
    return used


def _unreachable(tree: ast.AST):
    """(lineno of the dead statement, lineno of the terminator) pairs."""
    out = []
    terminal = (ast.Return, ast.Raise, ast.Break, ast.Continue)
    for node in ast.walk(tree):
        if not isinstance(getattr(node, "body", None), list):
            continue
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None) or []
            for i, stmt in enumerate(stmts[:-1]):
                if isinstance(stmt, terminal):
                    out.append((stmts[i + 1].lineno, stmt.lineno))
                    break
    return out


def check_deadcode(root: str, subdir: str = "src/repro_torch"):
    """Unused or duplicate imports and unreachable statements over
    root/subdir, honouring :data:`DEADCODE_IGNORE`."""
    findings = []
    for path in _py_files(os.path.join(root, subdir)):
        rel = _rel(path, root)
        if any(fnmatch.fnmatch(rel, pat) for pat in DEADCODE_IGNORE):
            continue
        if os.path.basename(path) == "__init__.py":
            continue                      # imports ARE the export surface
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        lines = src.splitlines()
        tree = ast.parse(src, filename=path)
        used = _used_names(tree)
        for lineno, name, target in _import_bindings(tree):
            if "noqa" in (lines[lineno - 1] if lineno <= len(lines)
                          else ""):
                continue
            if name not in used:
                findings.append(Finding(
                    "deadcode.unused_import", "error", rel,
                    f"line {lineno}: {target!r} imported as {name!r} but "
                    f"never used", {"line": lineno, "name": name}))
        seen = {}
        for lineno, name, target in _import_bindings(tree,
                                                     top_level_only=True):
            if (name, target) in seen:
                findings.append(Finding(
                    "deadcode.duplicate_import", "warn", rel,
                    f"line {lineno}: {target!r} already imported at line "
                    f"{seen[(name, target)]}", {"line": lineno}))
            seen.setdefault((name, target), lineno)
        for dead, term in _unreachable(tree):
            findings.append(Finding(
                "deadcode.unreachable", "warn", rel,
                f"line {dead}: unreachable (follows the terminator at "
                f"line {term})", {"line": dead}))
    return findings
