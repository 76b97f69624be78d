"""Share of the traced window in which no operation ran on the device, in
the training cell (`harness.trace.idle_pct`)."""

from harness.trace import idle_pct as read  # noqa: F401
