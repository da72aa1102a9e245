"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The cell's files under ``bench/`` say what runs (``core/cells.py``);
the last line of standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and ``busy_s``/``window_s`` with ``--trace
1``), ``breakdown`` (``--trace 1``) and ``checks``, each compared number
beside its limit, which also close standard error.  Exits 2 without a
result when CUDA or the cards are missing, and 3 when a JAX module was
loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's caches, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
# the program's switches that would change what is measured
PROGRAM_SWITCHES = ("REPRO_TRACE", "REPRO_VERIFY_LAUNCH",
                    "REPRO_TORCH_AUTOTUNE_CACHE")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux's
    ``/proc``), else the moment this module was first run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def prepare_env() -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    for key in PROGRAM_SWITCHES:
        os.environ.pop(key, None)
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent     # no bench/ module top-level
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run ``cell`` once on ``device`` (the harness's look for a chip
    already made) and return its result object."""
    from bench.core import cells, judge, profile, result
    from bench.core.runner import Run, per_layer
    out = cells.driver(cell).run(Run(cell, seed, seconds, trace, device,
                                     t_start))
    dev = result.device_entry(device, cell.chips, out.peak_bytes)
    breakdown = None
    if trace:
        metrics = per_layer(out.record)
        sl = out.record.get("slice")
        if sl and sl.get("trace"):
            dev["busy_s"] = sl["trace"]["busy_s"]
            dev["window_s"] = sl["trace"]["wall_s"]
            breakdown = profile.breakdown(sl["trace"])
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out.metrics.items()}
    return result.line(judge.correct(out.checks) and out.failed == 0,
                       out.attempted, out.failed, metrics, dev, out.checks,
                       breakdown)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    from bench.core import cells, result, runner
    runner.START[0] = t_start
    cell = cells.load(args.workload)
    import torch
    runner.log("torch imported")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"bench: {cell.name} seed {args.seed} on "
          f"{result.card_limit()}", file=sys.stderr)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)           # the card's context
    runner.log("CUDA context made")
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                    t_start)
    bad = result.forbidden_modules()
    if bad:
        print(f"bench: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    result.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
