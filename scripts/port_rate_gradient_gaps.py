#!/usr/bin/env python3
"""The gaps behind tests/test_torch_rate_48k.py and _22k.py: one train step
of the port and of the JAX package on the CPU at a configs/*.yaml feature
block, the tests' widths and batch (tests/torch_rates.py::rate_step).

    JAX_PLATFORMS=cpu python scripts/port_rate_gradient_gaps.py [CONFIG ...]
    # default: ljspeech-48k ljspeech-22k

For each config it prints the largest relative gap over the step's logs,
G's largest gradient gap, and for each sub-discriminator the largest gap
of D's gradient, each relative to a tensor's largest entry: the port's
float32 against JAX's float32, each against the float64 gradient (the
port's on its D-turn inputs), the two packages' float64 gradients against
each other, and the port's float32 against its float64 at its own leaky
ReLUs' sides; with the sub-discriminators whose float32 sides differ from
float64's in the port.
"""

import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from optispeech_tpu_torch.compat.from_jax import (  # noqa: E402
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from torch_parity import params_np  # noqa: E402
from torch_rates import rate_step  # noqa: E402


def _gap(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-12)


def main(argv=None) -> int:
    for name in (argv if argv is not None else sys.argv[1:]) or ["ljspeech-48k",
                                                                 "ljspeech-22k"]:
        r = rate_step(name)
        logs = max(abs(float(r["logs"][k]) - float(v)) / max(abs(float(v)), 1e-12)
                   for k, v in r["jlogs"].items())
        g_ref = state_dict_from_jax_params(params_np(r["jnew"].g_opt_state),
                                           r["tcfg"].generator)
        g = max(_gap(np.zeros_like(g_ref[k].numpy()) if x is None else x.numpy(),
                     g_ref[k].numpy())
                for (k, _), x in zip(r["state"].generator.named_parameters(), r["grads"]["g"]))
        d_ref = discriminator_state_dict_from_jax_params(params_np(r["jnew"].d_opt_state),
                                                         r["tcfg"].discriminator)
        d64 = r["d64"]
        subs = defaultdict(lambda: defaultdict(float))
        for (k, _), x in zip(r["state"].discriminator.named_parameters(), r["grads"]["d"]):
            sub = k.split(".convs")[0].split(".conv_post")[0]
            exact = d64["exact"][k].numpy()
            for what, gap in (("port-jax", _gap(x.numpy(), d_ref[k].numpy())),
                              ("port-f64", _gap(x.numpy(), exact)),
                              ("jax-f64", _gap(d_ref[k].numpy(), exact)),
                              ("f64 port-jax", _gap(exact, d64["jax"][k].numpy())),
                              ("port-f64 at its sides",
                               _gap(x.numpy(), d64["at_port_sides"][k].numpy()))):
                subs[sub][what] = max(subs[sub][what], gap)
        print(f"{name}: logs {logs:.3e}, G {g:.3e}; the port's float32 kink sides differ "
              f"from float64's in {sorted(d64['flipped']) or 'none'}", flush=True)
        for sub, gaps in subs.items():
            print(f"  {sub}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
