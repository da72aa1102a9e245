"""The numbers that decide ``correct``, each held against its limit from
the cell's workload file.

Prefill: ``logits_gap``, the widest gap between the program's and the
reference's last-position logits over the compared prompts (every row of
the window's first batch), in units of the reference logits' root mean
square; ``kv_gap``, the worst block's relative L2 gap between the keys and
values each prompt wrote into the program's cache and the reference's, at
the sampled positions.

Training: ``grad_gap``, the worst leaf's gap between the norms of the program's
first clipped gradient (read back from AdamW's first moment after one
step) and the reference's; ``update_gap``, the worst leaf's gap between
the norms of the parameters' change over the first steps.  A leaf's gap of
norms is measured against the larger of the reference's norm of that leaf
and of the median leaf.  ``update_gap`` leaves out leaves whose reference
gradient is under a thousandth of the median leaf's, which move by
round-off alone.  ``loss_gap``, the largest relative gap of a first
step's loss, is printed and not compared: neither the control nor a fault
reads three times the program's sound runs on it (``PERF.md``).
"""
from __future__ import annotations

import math
import statistics


def logits_gap(prog, ref) -> float:
    prog, ref = prog.float().cpu(), ref.float().cpu()
    return float((prog - ref).abs().max() / ref.square().mean().sqrt())


def kv_gap(prog_k, prog_v, ref_k, ref_v) -> float:
    """``[n_layers, P, ...]`` keys and values of both sides."""
    worst = 0.0
    for p_, r_ in ((prog_k, ref_k), (prog_v, ref_v)):
        p_ = p_.float().cpu().reshape(p_.shape[0], -1)
        r_ = r_.float().cpu().reshape(r_.shape[0], -1)
        gap = (p_ - r_).norm(dim=1) / r_.norm(dim=1).clamp_min(1e-30)
        worst = max(worst, float(gap.max()))
    return worst


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(worst gap of norms, its leaf) over the leaves of ``ref`` (those
    ``keep`` passes)."""
    median = statistics.median(ref.values())
    worst, where = 0.0, None
    for k, r in ref.items():
        if keep is not None and not keep(k):
            continue
        gap = abs(prog[k] - r) / max(r, median, 1e-30)
        if not math.isfinite(gap) or gap > worst:
            worst, where = gap, k
            if not math.isfinite(gap):
                break
    return worst, where


def moved(ref_grads: dict):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    floor = 1e-3 * statistics.median(ref_grads.values())
    return lambda k: ref_grads[k] >= floor


def checks(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of every compared number."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def correct(checked: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())
