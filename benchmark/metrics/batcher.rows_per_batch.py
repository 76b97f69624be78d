"""Sentence rows per batch the Batcher ran over the traced window:
`rows_synthesised / batches_run`, the program's own counters."""


def read(t):
    c = t.counters
    return c["rows"] / c["batches"] if c.get("batches") else None
