"""Helpers the per-layer readers share.  Each reader ``<metric>.py`` has
``UNIT`` and ``read(record)``, which returns the metric's value, or None
where the record holds nothing for it to read (another kind of cell, or no
device trace)."""
from __future__ import annotations

# the sparse kernels by the names of their device functions (the program's
# ``csrc/spmm_tile.cuh``'s ``spmm_kernel<Source, ...>``, ``csrc/
# sddmm_tile.cuh``'s ``sddmm_kernel<Source, ...>``, ``csrc/bcsr_attn.cu``)
# and the program's launch counters of each family
SPMM = {"B1": ("spmm_kernel", "RowptrSource"),
        "B3": ("spmm_kernel", "ScheduleSource")}
SDDMM = {"B2": ("sddmm_kernel", "EntrySource"),
         "B4": ("sddmm_kernel", "ScheduleSource")}
ATTN = {"B5": ("attn_fused",)}
COUNTERS = {"spmm": ("nnz_stream", "row_loop"),
            "sddmm": ("sddmm", "sddmm_row_loop"),
            "attn": ("attn_fused",)}


def traced(record, kind):
    """The record's device trace when it is of ``kind``, else None."""
    if record.get("kind") != kind:
        return None
    sl = record.get("slice")
    if not sl or not sl.get("trace"):
        return None
    return sl


def kernel_seconds(trace, families) -> float:
    """Device seconds of the kernels whose names hold every word of one of
    ``families``' entries."""
    total = 0.0
    for name, k in trace["kernels"].items():
        if any(all(w in name for w in words) for words in families.values()):
            total += k["seconds"]
    return total


def launch_count(launches, family) -> int:
    return sum(launches.get(k, 0) for k in COUNTERS[family])


def bound_seconds(per_unit: list, launched: int) -> float:
    """Least seconds of ``launched`` launches whose least times, one unit's
    worth, are ``per_unit``: ``launched`` times their mean (exact when the
    launches are the units' own, as the counters show today)."""
    if not per_unit or not launched:
        return 0.0
    return launched * sum(per_unit) / len(per_unit)


def idle_share(record, kind):
    sl = traced(record, kind)
    if sl is None:
        return None
    t = sl["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])


def launches_per_unit(record, kind):
    sl = traced(record, kind)
    if sl is None or sl["trace"]["launch_calls"] is None:
        return None
    return sl["trace"]["launch_calls"] / sl["units"]


def mfu(record, kind):
    """The window's operations over its time at the bf16 peak, in %."""
    from bench.work import peaks
    if record.get("kind") != kind:
        return None
    w = record["window"]
    return 100.0 * w["flops"] / (w["seconds"] * peaks.BF16_FLOPS)
