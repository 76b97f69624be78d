"""A training checkpoint whose background write fails
(training/checkpoint.py): the error is logged at once, the step's loader
state is deleted so no resume can pair it with an older step, the error is
raised again at the next join, and a run resumed from the newest good step
equals an uninterrupted run bit for bit (the resume contract JAX's trainer
keeps, tests/test_torch_trainer_parity.py holding the port's fit against
JAX's)."""

import logging
import os

import pytest
import torch

from optispeech_tpu_torch.training.checkpoint import TrainCheckpointManager
from test_torch_trainer import _same, loaders, tiny_config, trainer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from optispeech_tpu_torch.training import loggers

    monkeypatch.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)


def _fail_step(monkeypatch, step: int):
    """torch.save raises for the state of checkpoint `step`."""
    real = torch.save

    def save(obj, path, *args, **kw):
        if os.path.basename(os.path.dirname(str(path))) == f"{step}.tmp":
            raise OSError(f"disk full (step {step})")
        return real(obj, path, *args, **kw)

    monkeypatch.setattr(torch, "save", save)


def test_a_failed_save_is_logged_and_drops_its_loader_state(tmp_path, monkeypatch, caplog):
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = tiny_config()
    state = init_train_state(cfg, "cpu")
    mgr = TrainCheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state, cfg, {"epoch": 0, "pos": 1}, wait=True)
    _fail_step(monkeypatch, 2)
    with caplog.at_level(logging.ERROR, logger="optispeech_tpu_torch.training.checkpoint"):
        mgr.save(2, state, cfg, {"epoch": 0, "pos": 2})
        mgr._worker.join()  # the write has ended; nothing has joined it yet
        assert "checkpoint save of step 2 failed" in caplog.text
    assert not os.path.exists(tmp_path / "ck" / "loader_state-2.json")
    assert mgr.loader_state(1) == {"epoch": 0, "pos": 1}
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_resume_after_a_failed_save_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """A checkpoint every step; the save of step 2 fails. A fresh trainer
    restores step 1 with step 1's loader state and runs to 3: the same
    weights, optimisers' steps and RNG as 3 steps in one go."""
    cfg = tiny_config(ckpt_every_n_steps=1)
    fresh_loader = lambda: loaders(cfg, n_items=16, seed=11)[0]  # noqa: E731

    _fail_step(monkeypatch, 2)
    broken = trainer(cfg, tmp_path / "a").fit(fresh_loader(), None, max_steps=2)
    assert broken.step == 2
    monkeypatch.undo()
    ckpt = TrainCheckpointManager(str(tmp_path / "a" / "checkpoints"))
    assert ckpt.all_steps() == [1] and ckpt.loader_state(2) is None

    resumed = trainer(cfg, tmp_path / "a")
    state = resumed.init_or_restore_state()
    assert state.step == 1
    loader = fresh_loader()
    state = resumed.fit(loader, None, max_steps=3, state=state)
    whole = trainer(cfg, tmp_path / "b").fit(fresh_loader(), None, max_steps=3)
    assert state.step == whole.step == 3
    assert loader.state_dict() == {"epoch": 0, "pos": 3, "seed": 11}
    assert _same(state.generator, whole.generator)
    assert _same(state.discriminator, whole.discriminator)
    assert torch.equal(state.rng.get_state(), whole.rng.get_state())
