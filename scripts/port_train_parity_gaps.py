#!/usr/bin/env python3
"""Largest gaps between the port's training loop and the JAX package's on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_train_parity_gaps.py

At `tiny_experiment()`'s sizes with every dropout at 0 and the same weights
(JAX init through the bridges), it prints:
- the largest relative gap over every logged value of the two
  `metrics.jsonl` files of tests/test_torch_trainer_parity.py's runs
  (`fit(max_steps=3)` with a validation at step 2);
- for the first two micro-batches of tests/test_torch_train_options.py
  (numpy seed 21), D's gradient from JAX's jitted train step, from JAX's
  unjitted one and from the port's step, each against the gradient of
  JAX's own `forward_disc` on the same waveforms, as the largest gap over
  the tensors relative to each tensor's largest entry;
- the largest parameter gap after one real train step (Adam's first
  update) on that second micro-batch;
- for each call of tests/test_torch_train_options.py's accumulation and
  recompute runs (D's biases non-zero, Adam with eps 1e3), G's and D's
  largest update gap as a multiple of the tests' tolerance, and how far
  the cached branch's D update lies from JAX's recompute branch's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from optispeech_tpu.training.step import make_train_step as jax_make_train_step  # noqa: E402
from optispeech_tpu_torch.compat.from_jax import (  # noqa: E402
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from optispeech_tpu_torch.training.step import make_train_step  # noqa: E402
from test_train_step import tiny_experiment  # noqa: E402
from torch_parity import no_dropout, params_np, to_torch_config, train_batch, train_setup  # noqa: E402

torch.set_num_threads(1)


def worst_gap(got: dict, expect: dict):
    """(largest |got - expect| / max|expect| over the tensors, its name)."""
    return max((float(np.abs(np.asarray(got[k]) - np.asarray(expect[k])).max())
                / max(float(np.abs(np.asarray(expect[k])).max()), 1e-12), k) for k in expect)


def trainer_gap():
    import tempfile

    import test_torch_trainer_parity as parity

    class TmpFactory:
        def mktemp(self, name):
            return Path(tempfile.mkdtemp(prefix=name))

    jrows, rows = parity.runs.__wrapped__(TmpFactory())
    gaps = [(abs(r[k] - v) / max(abs(v), 1e-12), r["step"], k)
            for jr, r in zip(jrows, rows) for k, v in jr.items()
            if k != "step" and not k.startswith("perf/")]
    return max(gaps)


def discriminator_gaps():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    tcfg = to_torch_config(cfg)
    to_d = lambda t: discriminator_state_dict_from_jax_params(params_np(t), tcfg.discriminator)  # noqa: E731
    to_g = lambda t: state_dict_from_jax_params(params_np(t), tcfg.generator)  # noqa: E731
    rng = np.random.default_rng(21)
    batches = [train_batch(rng, cfg) for _ in range(2)]
    passthrough = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, params=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    for i, batch in enumerate(batches):
        jgen, jdisc, jstate, state = train_setup(cfg)
        # the waveforms both steps hand D: the ground-truth crop and G's output
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        with torch.no_grad():
            wav_hat = state.generator.train()(
                *[b[k] for k in ("x", "x_lengths", "mel", "mel_lengths", "pitches",
                                 "energies")], start_idx=b["start_idx"])["wav_hat"].numpy()

        def d_loss(d_params):
            return jdisc.apply({"params": d_params}, jnp.asarray(batch["wav_seg"]),
                               jnp.asarray(wav_hat), method=type(jdisc).forward_disc)[0]

        reference = to_d(jax.grad(d_loss)(jstate.d_params))
        start = jstate.replace(g_opt_state=passthrough.init(jstate.g_params),
                               d_opt_state=passthrough.init(jstate.d_params))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        for name, jit in (("jitted", True), ("unjitted", False)):
            step = jax_make_train_step(cfg, jgen, jdisc, optimizer=passthrough, jit=jit)
            print(f"  batch {i}: JAX {name} train step's D gradient vs forward_disc's: "
                  f"{worst_gap(to_d(step(start, jbatch)[0].d_opt_state), reference)}")
        recorded = []
        update = state.d_opt.update

        def record(grads, update=update):
            recorded.extend(g.clone() for g in grads)
            return update(grads)

        state.d_opt.update = record
        make_train_step(tcfg)(state, b)
        names = [k for k, _ in state.discriminator.named_parameters()]
        port = {k: g.numpy() for k, g in zip(names, recorded)}
        print(f"  batch {i}: the port's train step's D gradient vs forward_disc's: "
              f"{worst_gap(port, reference)}")
        if i == 1:
            # one real step from the same weights: Adam's first update
            _, _, jstate, state = train_setup(cfg)
            jnew, _ = jax_make_train_step(cfg, jgen, jdisc)(jstate, jbatch)
            make_train_step(tcfg)(state, b)
            for part, mod, conv, params in (("G", state.generator, to_g, jnew.g_params),
                                            ("D", state.discriminator, to_d, jnew.d_params)):
                expect = conv(params)
                gap = max((float(np.abs(p.detach().numpy() - expect[k].numpy()).max()), k)
                          for k, p in mod.named_parameters())
                print(f"  batch {i}: {part} parameters after one step, largest |port - JAX|: "
                      f"{gap}")


def option_gaps():
    import test_torch_train_options as options

    for name, run in (("accumulation", options.accumulated), ("recompute", options.recomputed)):
        _, calls = run.__wrapped__()
        for i, call in enumerate(calls):
            beside = "".join(f"; cached branch's D update {gap:.1f} x ({tensor})"
                             for gap, tensor in call["others"])
            print(f"  {name}, call {i}: G {call['G'][0]:.3f} x ({call['G'][1]}), "
                  f"D {call['D'][0]:.3f} x ({call['D'][1]}){beside}")


if __name__ == "__main__":
    print("trainer, largest relative gap over the logged values (gap, step, key):",
          trainer_gap())
    print("discriminator gradients (gap relative to the tensor's largest entry, tensor):")
    discriminator_gaps()
    print("option tests, update gap as a multiple of the tolerance (tensor):")
    option_gaps()
