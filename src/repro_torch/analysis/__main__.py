"""CLI for the port's static contract analyzer.

  python -m repro_torch.analysis --all            # every pass
  python -m repro_torch.analysis --lint           # AST rules over --src
  python -m repro_torch.analysis --verify-launch  # structure-zoo checks
  python -m repro_torch.analysis --audit-fingerprints
  python -m repro_torch.analysis --smem-budget 65536

Prints one ``path:line: [rule] message`` diagnostic per finding and
exits nonzero iff any pass found one, as ``python -m repro.analysis``
does.  No flags = ``--all``.  Imports no JAX and needs no card, so it runs
on the CPU and on the card's machine alike.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import workspace
from repro_torch.analysis.report import render


def _package_dir() -> str:
    import repro_torch
    return os.path.abspath(list(repro_torch.__path__)[0])   # .../repro_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract analyzer: launch verification against "
                    "the H100's budgets, repo-invariant lints, fingerprint "
                    "audit")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when no pass selected)")
    ap.add_argument("--lint", action="store_true",
                    help="AST repo-invariant rules over --src")
    ap.add_argument("--verify-launch", action="store_true",
                    help="schedule/grid/shared-memory checks over the "
                         "structure zoo")
    ap.add_argument("--audit-fingerprints", action="store_true",
                    help="key grammar (v7 + |dev=): injectivity + the "
                         "autotune cache")
    ap.add_argument("--smem-budget", type=int,
                    default=workspace.H100_SMEM_PER_CTA,
                    help="shared memory a CTA may take, bytes, for the "
                         "launch verifier (default: the H100's "
                         f"{workspace.H100_SMEM_PER_CTA})")
    ap.add_argument("--src", default=None,
                    help="source tree for --lint (default: the repro_torch "
                         "package's own directory)")
    args = ap.parse_args(argv)

    run_all = args.all or not (args.lint or args.verify_launch
                               or args.audit_fingerprints)
    findings = []
    if run_all or args.lint:
        from repro_torch.analysis import lint_rules
        src = args.src if args.src else _package_dir()
        n0 = len(findings)
        findings += lint_rules.lint_tree(src)
        print(f"lint: {len(findings) - n0} finding(s) over {src}",
              file=sys.stderr)
    if run_all or args.verify_launch:
        from repro_torch.analysis import verify_launch
        n0 = len(findings)
        findings += verify_launch.run_verify(vmem_budget=args.smem_budget)
        print(f"verify-launch: {len(findings) - n0} finding(s) over the "
              "structure zoo", file=sys.stderr)
    if run_all or args.audit_fingerprints:
        from repro_torch.analysis import fingerprint_audit
        n0 = len(findings)
        findings += fingerprint_audit.run_audit(
            os.path.dirname(os.path.dirname(_package_dir())))
        print(f"fingerprint-audit: {len(findings) - n0} finding(s)",
              file=sys.stderr)

    if findings:
        print(render(findings))
        print(f"FAIL: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("OK: all static contracts hold", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
