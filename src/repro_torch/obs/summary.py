"""CLI: render a JSONL trace as a span-tree summary.

    REPRO_TRACE=trace.jsonl python -m repro_torch.launch.serve \
        --arch smat-attn-1.3b:smoke --device cpu
    python -m repro_torch.obs.summary trace.jsonl
    python -m repro_torch.obs.summary trace.jsonl --perfetto trace_perfetto.json
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import export


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summary", description=__doc__)
    ap.add_argument("trace", help="JSONL trace (REPRO_TRACE sink or "
                                  "export.to_jsonl output)")
    ap.add_argument("--perfetto", default=None, metavar="OUT.json",
                    help="also write Chrome/Perfetto trace_event JSON")
    args = ap.parse_args(argv)
    events = export.read_jsonl(args.trace)
    print(export.summary_tree(events))
    if args.perfetto:
        export.write_perfetto(events, args.perfetto)
        print(f"wrote {args.perfetto}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
