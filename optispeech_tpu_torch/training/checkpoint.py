"""Training and inference checkpoints (port of
`optispeech_tpu/training/checkpoint.py`, in the port's own format).

A training checkpoint directory holds one subdirectory per saved step,
`<step>/state.pt` (`torch.save` of `TrainState.state_dict()` on the host:
G and D state dicts, both optimisers with their update count and
accumulation buffers, `state.step` and the step RNG's state), beside
`config.json` and `loader_state-<step>.json` for every kept step. Only the
newest `keep` steps are kept.

`save` copies the state to the host before it returns (the next train step
updates the parameters in place) and writes the files on a thread; `wait()`
returns once the checkpoint is durable. A step's directory is written
under a temporary name and renamed, so a save cut short leaves no step
behind. A write that fails is logged at once, its step's loader state is
deleted (no resume can then pair it with an older step), and the error is
raised again at the next join.

In a process group (`rank`, `world` of the manager; `world=None` without
one) every rank calls `save`: the ranks' step RNG states are gathered to rank 0
(`all_gather_object`), which alone writes the step, with them under
`rngs`, and the loader state (the same on every rank). Every rank restores
the same files on the host and copies them into its own device's tensors;
rank r then takes saved RNG state r, or, where the checkpoint has fewer
ranks, keeps the RNG of its seed and logs so.

An inference checkpoint directory holds `config.json` (config and speaker
list) and `generator.pt`, G's state dict; `OptiSpeech.load_from_checkpoint`
reads it.
"""

import json
import os
import shutil
import threading

import torch
import torch.distributed as dist

from ..config import ExperimentConfig, from_dict, to_dict
from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)

STATE_FILE = "state.pt"
GENERATOR_FILE = "generator.pt"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def to_host(tree):
    """A copy of `tree` (nested dicts, lists and tuples) with every tensor
    on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_inference_checkpoint(path: str, cfg: ExperimentConfig, generator_state: dict,
                              speakers=None):
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"config": to_dict(cfg), "speakers": speakers or []}, f, indent=2)
    torch.save(to_host(generator_state), os.path.join(path, GENERATOR_FILE))


def load_inference_checkpoint(path: str):
    """Returns (config, G's state dict on the CPU, the metadata dict)."""
    path = _abs(path)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    cfg = from_dict(ExperimentConfig, meta["config"])
    state = torch.load(os.path.join(path, GENERATOR_FILE), map_location="cpu",
                       weights_only=True)
    return cfg, state, meta


def is_train_checkpoint_dir(path: str) -> bool:
    """A training checkpoint directory has numbered step subdirectories."""
    path = _abs(path)
    return os.path.isdir(path) and any(d.isdigit() for d in os.listdir(path))


class TrainCheckpointManager:
    """Rolling training checkpoints: keep the newest `keep`, write on a
    thread; in a group of `world` ranks, rank 0 writes."""

    def __init__(self, directory: str, keep: int = 10, rank: int = 0,
                 world: int | None = None):
        self.directory = _abs(directory)
        self.keep = keep
        self.rank = rank
        self.world = world
        os.makedirs(self.directory, exist_ok=True)
        self._worker: threading.Thread | None = None
        self._worker_error: BaseException | None = None

    def _join_worker(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state, cfg: ExperimentConfig, loader_state: dict | None = None,
             wait: bool = False):
        """Checkpoint `state` (a `TrainState`) as step `step`. The host copy
        is taken before this returns; the write runs on a thread that the
        next save, `wait()`, `latest_step()` or `restore()` joins. In a
        group every rank calls this (it gathers the RNG states); only rank
        0 writes."""
        rngs = None
        if self.world is not None:
            rngs = [None] * self.world
            dist.all_gather_object(rngs, state.rng.get_state())
        if self.rank != 0:
            return
        self._join_worker()
        with open(os.path.join(self.directory, "config.json"), "w") as f:
            json.dump({"config": to_dict(cfg)}, f, indent=2)
        if loader_state is not None:
            # one file per kept step: resuming from any kept checkpoint
            # restores its own data-iterator position
            with open(self._loader_state_path(step), "w") as f:
                json.dump({"step": step, "loader": loader_state}, f)
        host = to_host(state.state_dict())
        if rngs is not None:
            host["rngs"] = rngs

        def _work():
            try:
                final = os.path.join(self.directory, str(step))
                tmp = final + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                torch.save(host, os.path.join(tmp, STATE_FILE))
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
                self._prune(keep_step=step)
            except BaseException as e:  # raised again at the next join
                log.error(f"checkpoint save of step {step} failed: {e!r}")
                try:
                    os.remove(self._loader_state_path(step))
                except OSError:
                    pass
                self._worker_error = e

        self._worker = threading.Thread(target=_work, name=f"ckpt-save-{step}", daemon=True)
        self._worker.start()
        if wait:
            self._join_worker()

    def _loader_state_path(self, step: int) -> str:
        return os.path.join(self.directory, f"loader_state-{step}.json")

    def _prune(self, keep_step: int):
        steps = self.all_steps()
        kept = set(steps[-self.keep:]) | {keep_step}
        for s in steps:
            if s not in kept:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.startswith("loader_state-") and name.endswith(".json"):
                try:
                    s = int(name[len("loader_state-"):-len(".json")])
                except ValueError:
                    continue
                if s not in kept:
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass

    def loader_state(self, step: int) -> dict | None:
        """The data-iterator state saved with checkpoint `step` (None if
        that save carried none)."""
        path = self._loader_state_path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["loader"]

    def latest_step(self):
        self._join_worker()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: int | None = None):
        """(the saved state dict on the CPU, its step) for `step` (default:
        the newest), or (None, None) when there is none."""
        self._join_worker()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        saved = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        return saved, step

    def restore(self, state, step: int | None = None):
        """Load checkpoint `step` (default: the newest) into `state` in
        place. Returns (state, step), or (None, None) when there is none."""
        saved, step = self.read(step)
        if saved is None:
            return None, None
        own = state.rng.get_state()  # this rank's seeded RNG
        state.load_state_dict(saved)
        rngs = saved.get("rngs") or [saved["rng"]]
        if self.rank < len(rngs):
            state.rng.set_state(rngs[self.rank])
        else:
            state.rng.set_state(own)
            log.info(f"rank {self.rank}: checkpoint {step} holds the RNG states of "
                     f"{len(rngs)} ranks; this rank's RNG starts from its seed")
        return state, step

    def wait(self):
        self._join_worker()
