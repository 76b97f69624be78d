"""One train step at configs/ljspeech-48k.yaml's
feature block, port against JAX on the CPU (tests/torch_rates.py says what
is compared and the tolerances)."""

from torch_rates import *  # noqa: F401,F403

CONFIG = "ljspeech-48k"
