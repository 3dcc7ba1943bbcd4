"""``python -m repro_torch.analysis.lint`` — the program-contract linter CLI.

Counterpart of ``repro.analysis.lint``. Checks every registered step and
psum configuration against its declared program plan
(:mod:`repro_torch.analysis.contracts`), each from one recorded call on
``--device`` (default: the card; ``--device cpu`` records on the CPU
through the kernels' plain versions, as the tests do; there is no fallback
to the CPU), and runs the source-level passes
(:mod:`repro_torch.analysis.static_checks`).

Exit status is 1 iff any error-severity finding survives.

    python -m repro_torch.analysis.lint --all                  # everything
    python -m repro_torch.analysis.lint --config overlap       # one spec
    python -m repro_torch.analysis.lint --all --format json --out LINT.json
    python -m repro_torch.analysis.lint --list                 # registry
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _repo_root() -> str:
    # src/repro_torch/analysis/lint.py -> the repo root is above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def build_report(names=None, families=None, *, examples=True,
                 deadcode=True, device=None) -> dict:
    """Run the selected passes; returns the machine-readable report."""
    import torch
    from repro_torch import resolve_device
    from repro_torch.analysis import contracts as CT
    from repro_torch.analysis import static_checks as SC
    dev = resolve_device(device)
    findings = list(CT.check_all(names, families, device=dev))
    if examples:
        findings.extend(SC.check_examples(_repo_root()))
    if deadcode:
        findings.extend(SC.check_deadcode(_repo_root()))
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in CT.SEVERITIES}
    specs = [s.name for s in CT.STEP_SPECS + CT.PSUM_SPECS]
    return {
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "configs": specs if not names else list(names),
        "counts": counts,
        "findings": [f.to_dict() for f in findings],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="program-contract linter (one recorded call per "
                    "configuration)")
    ap.add_argument("--all", action="store_true",
                    help="lint every registered configuration (default "
                         "when no --config is given)")
    ap.add_argument("--config", action="append", default=[],
                    help="lint one registered spec (repeatable)")
    ap.add_argument("--families", default=None,
                    help="comma-separated contract families to run")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--list", action="store_true",
                    help="list registered specs and contracts, then exit")
    ap.add_argument("--no-examples", action="store_true",
                    help="skip the examples staleness pass")
    ap.add_argument("--no-deadcode", action="store_true",
                    help="skip the src/repro_torch dead-code pass")
    ap.add_argument("--device", default=None,
                    help="device the steps are recorded on (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import contracts as CT
    if args.list:
        for s in CT.STEP_SPECS:
            print(f"step  {s.name}")
        for s in CT.PSUM_SPECS:
            print(f"psum  {s.name}")
        for c in CT.CONTRACTS.values():
            print(f"contract  {c.key:26s} [{c.severity}] {c.description}")
        return 0

    names = args.config or None
    families = args.families.split(",") if args.families else None
    report = build_report(names, families,
                          examples=not args.no_examples,
                          deadcode=not args.no_deadcode, device=args.device)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.format == "json":
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        findings = [CT.Finding(**f) for f in report["findings"]]
        configs = report["configs"] if names else None
        print(f"recorded on device={report['device']} "
              f"({report['device_name']})")
        print(CT.summary_table(findings, configs))
        for f in findings:
            print(f"{f.severity.upper():5s} {f.config}: [{f.key}] "
                  f"{f.message}")
        c = report["counts"]
        print(f"{c['error']} error(s), {c['warn']} warning(s), "
              f"{c['info']} info")
    return 1 if report["counts"]["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
