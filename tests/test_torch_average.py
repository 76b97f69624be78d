"""The port's checkpoint averaging (training/average.py, cli/average.py)
against the JAX package on the CPU: the average of a port run's last N or
explicit steps equals JAX's `average_generator_params` over a JAX run with
the same weights (through compat/from_jax.py) bit for bit; a missing step
raises; the run config round-trips; the CLI writes an inference checkpoint
that `OptiSpeech.load_from_checkpoint` loads; `--packed-val --compare`
validates both the newest checkpoint and the average."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from optispeech_tpu.training.average import average_generator_params as jax_average
from optispeech_tpu.training.checkpoint import TrainCheckpointManager as JaxManager
from optispeech_tpu_torch.compat.from_jax import state_dict_from_jax_params
from optispeech_tpu_torch.training.average import average_generator_params, load_run_config
from optispeech_tpu_torch.training.checkpoint import TrainCheckpointManager
from test_train_step import tiny_experiment
from torch_parity import params_np, to_torch_config, train_setup

torch.set_num_threads(1)

STEPS = (1, 2, 3, 5)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from optispeech_tpu_torch.training import loggers

    monkeypatch.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run and a port run holding the same generator weights at each
    step (JAX's initial weights, moved by a seeded float32 step per
    checkpoint); returns (jax checkpoints/, port run dir)."""
    root = tmp_path_factory.mktemp("avg")
    cfg = tiny_experiment()
    tcfg = to_torch_config(cfg)
    _, _, jstate, state = train_setup(cfg)
    rng = np.random.default_rng(0)
    jax_mgr = JaxManager(str(root / "jax" / "checkpoints"), keep=10)
    port_mgr = TrainCheckpointManager(str(root / "port" / "checkpoints"), keep=10)
    g = params_np(jstate.g_params)
    for s in STEPS:
        g = jax.tree_util.tree_map(
            lambda p: (p + rng.normal(size=p.shape).astype(np.float32) * np.float32(0.01)
                       ).astype(p.dtype), g)
        jax_mgr.save(s, {"step": np.asarray(s, np.int32), "g_params": g,
                         "d_params": params_np(jstate.d_params), "rng": np.zeros(2, np.uint32)},
                     cfg)
        state.generator.load_state_dict(state_dict_from_jax_params(g, tcfg.generator))
        state.step = s
        port_mgr.save(s, state, tcfg, {"epoch": 0, "pos": s})
    jax_mgr.wait()
    port_mgr.wait()
    return str(root / "jax" / "checkpoints"), str(root / "port"), tcfg


def _assert_bit_equal(ours: dict, jax_params, gen_cfg):
    want = state_dict_from_jax_params(params_np(jax_params), gen_cfg)
    assert set(ours) == set(want)
    for k in want:
        assert ours[k].dtype == want[k].dtype, k
        assert torch.equal(ours[k], want[k]), k


@pytest.mark.parametrize("select", [dict(last_n=3), dict(steps=[5, 1]), dict(last_n=10)])
def test_average_equals_jax_bit_for_bit(runs, select):
    jax_dir, port_run, tcfg = runs
    avg, steps, last_raw = average_generator_params(os.path.join(port_run, "checkpoints"),
                                                    **select)
    javg, jsteps, jlast = jax_average(jax_dir, **select)
    assert steps == jsteps == sorted(select.get("steps") or STEPS[-select["last_n"]:])
    _assert_bit_equal(avg, javg, tcfg.generator)
    assert last_raw["step"] == int(jlast["step"]) == steps[-1]


def test_a_missing_step_raises(runs, tmp_path):
    _, port_run, _ = runs
    with pytest.raises(ValueError, match="not retained"):
        average_generator_params(os.path.join(port_run, "checkpoints"), steps=[2, 7])
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        average_generator_params(str(tmp_path / "nowhere"))


def test_run_config_round_trips(runs):
    _, port_run, tcfg = runs
    assert load_run_config(os.path.join(port_run, "checkpoints")) == tcfg


def test_cli_writes_a_loadable_inference_checkpoint(runs, tmp_path, capsys):
    from optispeech_tpu_torch.cli.average import main
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    _, port_run, _ = runs
    out = tmp_path / "avg"
    assert main([port_run, "-o", str(out), "--last", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"averaged_steps": [3, 5], "out": str(out)}
    avg, _, _ = average_generator_params(os.path.join(port_run, "checkpoints"), last_n=2)
    model = OptiSpeech.load_from_checkpoint(str(out), device="cpu")
    loaded = model.generator.state_dict()
    assert all(torch.equal(loaded[k], avg[k]) for k in avg)


def test_cli_validation_needs_a_device_when_cuda_is_absent(runs, tmp_path, monkeypatch):
    """The averaging runs on the host; the validation pass is on the card
    unless --device says otherwise, and raises without one."""
    from optispeech_tpu_torch.cli.average import main

    _, port_run, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([port_run, "-o", str(tmp_path / "avg"), "--packed-val", "val.pak"])
    assert (tmp_path / "avg" / "generator.pt").exists()


def test_cli_validates_the_average_and_the_newest_checkpoint(tmp_path, capsys):
    """A packed CPU run of 2 steps that keeps both, then `--last 2
    --packed-val --compare --device cpu`: compare.json holds both passes,
    and the averaged checkpoint synthesises."""
    from optispeech_tpu_torch.cli.average import main as average
    from optispeech_tpu_torch.cli.train import main as train
    from optispeech_tpu_torch.data.packed import pack_dataset
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.values import InferenceInputs
    from test_torch_trainer import CLI_OVERRIDES
    from torch_packed_data import HOP, N_FEATS, write_datafiles

    pak = pack_dataset(str(write_datafiles(tmp_path, n=8)), str(tmp_path / "t.pak"),
                       N_FEATS, HOP)
    run = tmp_path / "run"
    assert train(["--packed-train", pak, "--packed-val", pak, "--device", "cpu",
                  "--max-steps", "2", "--out-dir", str(run), "--no-print-config",
                  *CLI_OVERRIDES, "ckpt_every_n_steps=1", "val_every_n_steps=100"]) == 0
    capsys.readouterr()
    assert average([str(run), "--last", "2", "--packed-val", pak, "--compare",
                    "--device", "cpu"]) == 0
    first, second = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()[-2:]]
    assert first["averaged_steps"] == [1, 2]
    compare = json.loads((run / "avg_eval" / "compare.json").read_text())
    assert second["compare"] == str(run / "avg_eval" / "compare.json")
    assert set(compare) == {"averaged_steps", "last", "averaged"}
    for name in ("last", "averaged"):
        assert np.isfinite(compare[name]["total_loss/val_total"])
        assert second[name]["total_loss/val_total"] == round(
            compare[name]["total_loss/val_total"], 4)
    assert compare["last"]["total_loss/val_total"] != compare["averaged"]["total_loss/val_total"]
    model = OptiSpeech.load_from_checkpoint(first["out"], device="cpu", fused=True)
    inputs = InferenceInputs.from_ids_and_lengths([[5, 9, 12, 7, 3]], [5], clean_text="",
                                                  d_factor=1.0, p_factor=1.0, e_factor=1.0)
    wav = model.synthesise_on_device(inputs, n_frames=64)["wav"]
    assert wav.shape == (1, 64 * HOP) and torch.isfinite(wav).all()
