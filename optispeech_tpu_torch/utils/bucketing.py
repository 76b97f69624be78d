"""Static-shape bucketing helpers.

Padding lengths up to bucket boundaries keeps the set of shapes the model
sees small, and keeps the port's shapes equal to the JAX package's, so the
two give the same numbers on the same inputs."""

import numpy as np


def round_up_to_bucket(n: int, bucket: int, minimum: int | None = None) -> int:
    out = max(int(np.ceil(max(n, 1) / bucket)) * bucket, bucket)
    if minimum is not None:
        out = max(out, minimum)
    return out


def round_up_pow2_bucket(n: int, bucket: int, cap: int | None = None) -> int:
    """Round `n` up to `bucket * 2**k`, at most `cap`: a geometric ladder of
    shapes, so that a drifting estimate (the server's frame cap) lands on
    log2(cap / bucket) + 1 shapes at the cost of at most 2x padding."""
    n = max(int(n), 1)
    rung = bucket
    while rung < n and (cap is None or rung < cap):
        rung *= 2
    if cap is not None:
        rung = min(rung, cap)
    return rung
