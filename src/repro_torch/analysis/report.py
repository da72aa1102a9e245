"""Finding: the one diagnostic currency every analyzer pass trades in.

Each pass (launch verifier, repo-invariant linter, fingerprint audit)
returns a flat ``list[Finding]``; the CLI prints them as classic
``path:line: [rule] message`` diagnostics and exits nonzero iff any
exist.  Keeping the type here — not in ``__init__`` — lets the pass
modules import it without touching package-init order.

>>> print(Finding(rule="traced-numpy", path="src/x.py", line=7,
...               message="numpy call reachable from a traced body"))
src/x.py:7: [traced-numpy] numpy call reachable from a traced body
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``rule`` names the invariant, ``path``/``line``
    anchor it (line 0 = whole-file / non-source findings)."""
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def render(findings) -> str:
    """Stable, sorted rendering of a finding list (one per line).

    >>> render([Finding("r", "b.py", 2, "m"), Finding("r", "a.py", 1, "m")])
    'a.py:1: [r] m\\nb.py:2: [r] m'
    """
    return "\n".join(str(f) for f in
                     sorted(findings, key=lambda f: (f.path, f.line, f.rule)))
