"""Device ms per training step of the convolution kernels: the traced
window's device time of kernels whose names match PATTERNS (cuDNN's
forward, data-gradient and weight-gradient convolutions and the kernels it
runs them with), over the steps."""

import re

PATTERNS = re.compile(r"fprop|dgrad|wgrad|implicit_gemm|implicit_convolve|convolve_|conv2d|"
                      r"conv1d|winograd|depthwise|cudnn", re.IGNORECASE)


def read(t):
    steps = t.work.get("steps")
    if not steps:
        return None
    total = sum(s for name, s in t.kernels.items() if PATTERNS.search(name))
    return 1e3 * total / steps if total > 0 else None
