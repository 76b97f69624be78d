"""Host wall ms per batch of the Batcher's synthesise stage
(`synthesise_on_device` through the read of the lengths, which waits for the
device; retries included) over the traced window: the program's
`stage_seconds["synthesise"] / batches_run`."""


def read(t):
    c = t.counters
    return 1e3 * c["synthesise_s"] / c["batches"] if c.get("batches") else None
