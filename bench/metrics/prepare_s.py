"""Seconds the program's library host path spent preparing sparse operands
during set-up: its ``prepare.reorder`` and ``prepare.meta`` spans (the
weights the benchmark loads, the masks and metas the first calls build)."""
UNIT = "s"


def read(record):
    spans = record.get("spans")
    if spans is None:
        return None
    return spans.get("prepare.reorder", 0.0) + spans.get("prepare.meta", 0.0)
