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

