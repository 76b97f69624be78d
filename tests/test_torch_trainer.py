"""The port's training entry point on the CPU (mirroring
tests/test_trainer_loop.py and tests/test_checkpoint_resume.py): fit with
validation, checkpoints and resume, forced resume, keep-N pruning with
per-step loader state, a resumed run equal to an uninterrupted one bit for
bit, the inference export, SIGTERM at a step boundary, and `cli/train.py`.

These tests import no JAX. The TensorBoard sink is switched off: its import
brings in TensorFlow where that is installed, some 15 s; one test hands the
trainer a recording writer instead.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.data.datamodule import BucketedCollate, DataLoader, SyntheticDataset
from optispeech_tpu_torch.training.checkpoint import TrainCheckpointManager
from optispeech_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from optispeech_tpu_torch.training import loggers

    monkeypatch.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)


def tiny_config(**kw):
    """The JAX tests' `tiny_experiment()` sizes, built in the port's config."""
    from optispeech_tpu_torch.config import (
        BackboneConfig,
        DataConfig,
        DiscriminatorConfig,
        ExperimentConfig,
        FeatureConfig,
        GeneratorConfig,
        SchedulerConfig,
        TrainArgs,
        VocoderConfig,
    )

    feats = FeatureConfig(sample_rate=24000, n_feats=20, n_fft=256, hop_length=64,
                          win_length=256)
    bb = BackboneConfig(kind="convnext", intermediate_dim=64, num_layers=2, drop_path=0.1)
    gen = GeneratorConfig(dim=32, segment_size=16, encoder=bb, decoder=bb,
                          vocoder=VocoderConfig(dim=48, intermediate_dim=96, num_layers=2),
                          features=feats)
    disc = DiscriminatorConfig(periods=(2, 3), resolutions=((256, 64, 256), (128, 32, 128)),
                               mrd_channels=16)
    cfg = ExperimentConfig(
        generator=gen, discriminator=disc, train_args=TrainArgs(pretraining_steps=0),
        scheduler=SchedulerConfig(num_warmup_steps=10, num_training_steps=100),
        data=DataConfig(text_bucket_size=16, mel_bucket_size=64),
        log_every_n_steps=100, val_every_n_steps=1000, ckpt_every_n_steps=100)
    return dataclasses.replace(cfg, **kw)


def loaders(cfg, n_items=8, seed=0):
    feats = cfg.generator.features
    ds = SyntheticDataset(n_items=n_items, n_feats=feats.n_feats, hop_length=feats.hop_length,
                          text_range=(8, 16), mel_range=(32, 64))
    collate = BucketedCollate(
        n_feats=feats.n_feats, statistics=cfg.data.statistics, hop_length=feats.hop_length,
        text_bucket=cfg.data.text_bucket_size, mel_bucket=cfg.data.mel_bucket_size,
        max_text_len=cfg.data.text_bucket_size, max_mel_len=cfg.data.mel_bucket_size)
    return (DataLoader(ds, 4, collate, shuffle=True, seed=seed),
            DataLoader(ds, 4, collate, shuffle=False))


def trainer(cfg, out_dir):
    return Trainer(cfg, out_dir=str(out_dir), device="cpu")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


class RecordingWriter:
    def __init__(self):
        self.calls = []

    def add_audio(self, tag, *args):
        self.calls.append(tag)

    def add_image(self, tag, *args):
        self.calls.append(tag)


def test_trainer_fit_val_ckpt_and_resume(tmp_path):
    cfg = tiny_config(log_every_n_steps=1, val_every_n_steps=2, ckpt_every_n_steps=2,
                      train_args=dataclasses.replace(tiny_config().train_args,
                                                     evaluate_periodicity=True))
    train, val = loaders(cfg)
    out_dir = tmp_path / "run"
    t = trainer(cfg, out_dir)
    t.metrics.tb = RecordingWriter()
    state = t.fit(train, val, max_steps=3)
    assert state.step == 3
    csv = (out_dir / "metrics.csv").read_text()
    for key in ("total_loss/val_total", "val/f1_score", "perf/host_rss_gb",
                "gen_adv_loss/val_mel_loss", "total_loss/generator"):
        assert key in csv, key
    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    val = rows[3]
    assert 0 < val["perf/val_synth_seconds"] + val["perf/val_metrics_seconds"] <= (
        val["perf/val_seconds"])
    assert t.metrics.tb.calls == ["wav/original_0", "wav/generated_0", "mel/generated_0",
                                  "wav/original_1", "wav/generated_1", "mel/generated_1"]

    # a new process resumes from the last save (the final one, step 3)
    state2 = trainer(cfg, out_dir).init_or_restore_state()
    assert state2.step == 3 and _same(state2.generator, state.generator)
    assert _same(state2.discriminator, state.discriminator)
    assert state2.g_opt.count == 3
    assert torch.equal(state2.rng.get_state(), state.rng.get_state())

    # the inference export loads back
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    t.export_inference_checkpoint(state, str(out_dir / "inf"))
    api = OptiSpeech.load_from_checkpoint(str(out_dir / "inf"), device="cpu")
    assert api.cfg == cfg
    assert _same(api.generator, state.generator)


def test_resume_at_epoch_boundary_rolls_over(tmp_path):
    """A loader whose restored position is the end of its batch list rolls
    into the next epoch instead of tripping the empty-loader guard."""
    cfg = tiny_config()
    loader, _ = loaders(cfg, seed=3)
    loader.load_state_dict({"epoch": 0, "pos": 2, "seed": 3})
    state = trainer(cfg, tmp_path / "run").fit(loader, None, max_steps=1)
    assert state.step == 1 and loader.epoch == 1


def test_empty_loader_raises(tmp_path):
    cfg = tiny_config()
    loader, _ = loaders(cfg, n_items=3)  # fewer items than the batch, drop_last
    with pytest.raises(RuntimeError, match="no batches twice"):
        trainer(cfg, tmp_path / "run").fit(loader, None, max_steps=1)


def test_forced_resume_restores_g_and_d_with_fresh_optimizers(tmp_path):
    cfg = tiny_config()
    train, _ = loaders(cfg)
    first = trainer(cfg, tmp_path / "run")
    state = first.fit(train, None, max_steps=2)
    ckpt_dir = tmp_path / "run" / cfg.ckpt_dir

    resumed = trainer(cfg, tmp_path / "run2").init_or_restore_state(
        forced_resume_from=str(ckpt_dir))
    assert resumed.step == 0 and resumed.g_opt.count == 0 and not resumed.g_opt.adamw.state
    assert _same(resumed.generator, state.generator)
    assert _same(resumed.discriminator, state.discriminator)

    # from an inference checkpoint: G only
    first.export_inference_checkpoint(state, str(tmp_path / "inf"))
    g_only = trainer(cfg, tmp_path / "run3").init_or_restore_state(
        forced_resume_from=str(tmp_path / "inf"))
    assert _same(g_only.generator, state.generator)
    assert not _same(g_only.discriminator, state.discriminator)


def test_keep_n_pruning_with_per_step_loader_state(tmp_path):
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = tiny_config()
    state = init_train_state(cfg, "cpu", seed=0)
    mgr = TrainCheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state, cfg, loader_state={"epoch": step, "pos": step * 10})
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.loader_state(2) == {"epoch": 2, "pos": 20}
    assert mgr.loader_state(3) == {"epoch": 3, "pos": 30}
    assert mgr.loader_state(1) is None
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "2", "3", "config.json", "loader_state-2.json", "loader_state-3.json"]
    fresh = init_train_state(cfg, "cpu", seed=5)
    assert mgr.restore(fresh, step=2)[0].step == 2 and _same(fresh.generator, state.generator)
    empty = TrainCheckpointManager(str(tmp_path / "none"))
    assert empty.restore(fresh) == (None, None)


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    """2 steps, a new trainer restored from the checkpoint with a fresh
    loader, 2 more; against 4 in one go. Dropout on: the step RNG is part
    of the checkpoint."""
    cfg = tiny_config()
    fresh_loader = lambda: loaders(cfg, n_items=16, seed=11)[0]  # noqa: E731

    trainer(cfg, tmp_path / "a").fit(fresh_loader(), None, max_steps=2)
    resumed = trainer(cfg, tmp_path / "a")
    state = resumed.init_or_restore_state()
    assert state.step == 2
    loader = fresh_loader()
    state = resumed.fit(loader, None, max_steps=4, state=state)
    assert loader._pos == 4  # resumed at batch 2, consumed batches 2 and 3

    whole = trainer(cfg, tmp_path / "b").fit(fresh_loader(), None, max_steps=4)
    assert state.step == whole.step == 4
    assert _same(state.generator, whole.generator)
    assert _same(state.discriminator, whole.discriminator)
    assert torch.equal(state.rng.get_state(), whole.rng.get_state())


def test_sigterm_checkpoints_at_the_step_boundary(tmp_path):
    cfg = tiny_config()
    train, _ = loaders(cfg)

    class Preempting:
        """Yields the loader's batches; SIGTERM arrives during the first step."""

        def __iter__(self):
            for i, batch in enumerate(train):
                if i == 0:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        def state_dict(self):
            return train.state_dict()

    handler = signal.getsignal(signal.SIGTERM)
    t = trainer(cfg, tmp_path / "run")
    state = t.fit(Preempting(), None, max_steps=10)
    assert state.step == 1 and t.ckpt.latest_step() == 1
    assert t.ckpt.loader_state(1) == {"epoch": 0, "pos": 1, "seed": 0}
    assert signal.getsignal(signal.SIGTERM) is handler


def test_wire_mel_dtype_bfloat16(tmp_path):
    cfg = tiny_config(train_args=dataclasses.replace(tiny_config().train_args,
                                                     wire_mel_dtype="bfloat16"))
    t = trainer(cfg, tmp_path / "run")
    train, _ = loaders(cfg)
    batch = t._segment_batch(t._device_batch(next(iter(train))), step=0)
    assert batch["mel"].dtype == torch.bfloat16 and "wav" not in batch
    assert t.fit(train, None, max_steps=1).step == 1


def test_trainer_fits_validates_and_resumes_in_bfloat16(tmp_path):
    """`train_args.compute_dtype: bfloat16`: G computes in bf16 (D in
    float32), 2 steps with a validation and a checkpoint, float32 parameters
    and optimiser state throughout, and a resume that takes a third step."""
    cfg = tiny_config(train_args=dataclasses.replace(tiny_config().train_args,
                                                     compute_dtype="bfloat16"),
                      val_every_n_steps=2, ckpt_every_n_steps=2, log_every_n_steps=1)
    t = trainer(cfg, tmp_path / "run")
    train, val = loaders(cfg)
    state = t.fit(train, val, max_steps=2)
    assert state.step == 2 and state.generator.compute_dtype == torch.bfloat16
    assert {p.dtype for p in state.generator.parameters()} == {torch.float32}
    moments = [v for s in state.g_opt.adamw.state.values() for v in s.values()
               if torch.is_tensor(v) and v.dim() > 0]
    assert moments and {v.dtype for v in moments} == {torch.float32}
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert any("total_loss/val_total" in r for r in rows)
    assert TrainCheckpointManager(str(tmp_path / "run" / "checkpoints")).latest_step() == 2
    resumed = trainer(cfg, tmp_path / "run").fit(train, val, max_steps=3)
    assert resumed.step == 3 and resumed.generator.compute_dtype == torch.bfloat16


def test_unported_options_raise(tmp_path, monkeypatch):
    cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        trainer(tiny_config(num_devices=2), tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, out_dir=str(tmp_path))


# the tiny sizes as command-line overrides of configs/default.yaml
CLI_OVERRIDES = [
    "data.batch_size=4", "data.text_bucket_size=16", "data.mel_bucket_size=64",
    "data.max_text_len=16", "data.max_mel_len=64", "data.features.n_feats=20",
    "data.features.n_fft=256", "data.features.hop_length=64", "data.features.win_length=256",
    "generator.dim=32", "generator.segment_size=16",
    "generator.encoder.intermediate_dim=64", "generator.encoder.num_layers=2",
    "generator.decoder.intermediate_dim=64", "generator.decoder.num_layers=2",
    "generator.vocoder.dim=48", "generator.vocoder.intermediate_dim=96",
    "generator.vocoder.num_layers=2",
    "discriminator.periods=[2, 3]", "discriminator.resolutions=[[256, 64, 256]]",
    "discriminator.mrd_channels=16", "train_args.pretraining_steps=0",
    "val_every_n_steps=2", "log_every_n_steps=1",
]


def test_cli_main_trains_and_exports(tmp_path):
    from optispeech_tpu_torch.cli.train import main

    out = tmp_path / "cli"
    assert main(["--synthetic", "--device", "cpu", "--max-steps", "2", "--out-dir", str(out),
                 "--no-print-config", *CLI_OVERRIDES]) == 0
    ckpt = TrainCheckpointManager(str(out / "checkpoints"))
    assert ckpt.latest_step() == 2
    assert (out / "inference_ckpt" / "config.json").exists()
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("total_loss/val_total" in r for r in rows)


def test_cli_main_trains_in_bfloat16(tmp_path):
    """The `train_args.compute_dtype=bfloat16` override end to end: 2 steps
    with a validation, the checkpoint and the inference export, whose
    weights are float32 and synthesise in bf16."""
    from optispeech_tpu_torch.cli.train import main
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.values import InferenceInputs

    out = tmp_path / "cli"
    assert main(["--synthetic", "--device", "cpu", "--max-steps", "2", "--out-dir", str(out),
                 "--no-print-config", *CLI_OVERRIDES,
                 "train_args.compute_dtype=bfloat16"]) == 0
    assert TrainCheckpointManager(str(out / "checkpoints")).latest_step() == 2
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("total_loss/val_total" in r for r in rows)
    model = OptiSpeech.load_from_checkpoint(str(out / "inference_ckpt"), device="cpu",
                                            compute_dtype=torch.bfloat16)
    assert model.cfg.train_args.compute_dtype == "bfloat16"
    assert {p.dtype for p in model.generator.parameters()} == {torch.float32}
    inputs = InferenceInputs.from_ids_and_lengths([[5, 9, 12, 7, 3]], [5], clean_text="",
                                                  d_factor=1.0, p_factor=1.0, e_factor=1.0)
    wav = model.synthesise_on_device(inputs, n_frames=64)["wav"]
    assert wav.dtype == torch.float32 and torch.isfinite(wav).all()


def test_cli_debug_harnesses(tmp_path):
    """--fast-dev-run (one step, logged and saved), --overfit 1 (one batch of
    items) and --profile-steps 0,0 (a torch.profiler trace of step 0)."""
    from optispeech_tpu_torch.cli.train import main

    out = tmp_path / "fdr"
    assert main(["--synthetic", "--device", "cpu", "--fast-dev-run", "--overfit", "1",
                 "--profile-steps", "0,0", "--out-dir", str(out), "--no-print-config",
                 *CLI_OVERRIDES]) == 0
    assert TrainCheckpointManager(str(out / "checkpoints")).all_steps() == [1]
    assert (out / "profile" / "trace.json").stat().st_size > 0
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]


@pytest.mark.parametrize("flag", [["--packed-train", "x.pak"], ["--device-cache"],
                                  ["--distributed"]])
def test_cli_flags_not_ported_raise(flag):
    from optispeech_tpu_torch.cli.train import main

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        main(["--synthetic", "--device", "cpu", *flag])
