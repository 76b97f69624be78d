"""Pluggable metric-sink registry (the port's own copy of
`optispeech_tpu/training/loggers.py`).

Each backend (tensorboard, wandb, mlflow, neptune, comet, aim) is a named
sink accepting (step, metrics) dicts. CSV + JSONL live in
trainer.MetricLogger and are always on; every sink here is import-gated:
requesting a backend whose package is not installed logs a warning and is
skipped. TensorBoard goes through `torch.utils.tensorboard`.

Third-party code can register custom sinks:

    from optispeech_tpu_torch.training.loggers import register_sink

    @register_sink("mybackend")
    def make_my_sink(out_dir, run_name, config):
        return MySink(...)

A sink factory returns an object with `.log(step, metrics)` and `.close()`,
or None to signal "unavailable" (already warned).
"""

from typing import Callable, Optional

from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)

_SINK_REGISTRY: dict[str, Callable] = {}


def register_sink(name: str):
    def deco(factory: Callable):
        _SINK_REGISTRY[name] = factory
        return factory

    return deco


def available_sinks() -> list[str]:
    return sorted(_SINK_REGISTRY)


def make_sink(name: str, out_dir: str, run_name: Optional[str] = None,
              config: Optional[dict] = None):
    """Instantiate a named sink; unknown names raise, unavailable backends
    warn and return None."""
    if name not in _SINK_REGISTRY:
        raise KeyError(
            f"unknown logger sink `{name}`; available: {available_sinks()}"
        )
    return _SINK_REGISTRY[name](out_dir, run_name, config)


class _CallableSink:
    def __init__(self, log_fn, close_fn=None):
        self._log = log_fn
        self._close = close_fn

    def log(self, step: int, metrics: dict):
        self._log(step, metrics)

    def close(self):
        if self._close is not None:
            self._close()


@register_sink("tensorboard")
def _tensorboard(out_dir, run_name, config):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        log.warning("logger `tensorboard` requested but the tensorboard package is not installed")
        return None
    tb = SummaryWriter(out_dir)

    def _log(step, metrics):
        for k, v in metrics.items():
            tb.add_scalar(k, v, step)

    sink = _CallableSink(_log, tb.close)
    sink.writer = tb  # trainer audio/mel panels attach here
    return sink


@register_sink("wandb")
def _wandb(out_dir, run_name, config):
    try:
        import wandb
    except ImportError:
        log.warning("logger `wandb` requested but wandb is not installed")
        return None
    project = (config or {}).get("wandb_project") or "optispeech-tpu"
    run = wandb.init(project=project, name=run_name, dir=out_dir, config=config)
    return _CallableSink(lambda step, m: run.log(m, step=step), run.finish)


@register_sink("mlflow")
def _mlflow(out_dir, run_name, config):
    try:
        import mlflow
    except ImportError:
        log.warning("logger `mlflow` requested but mlflow is not installed")
        return None
    mlflow.start_run(run_name=run_name)
    if config:
        # mlflow params must be flat strings
        mlflow.log_params({k: str(v)[:250] for k, v in _flatten(config).items()})

    def _log(step, metrics):
        mlflow.log_metrics({k.replace("/", "."): v for k, v in metrics.items()},
                           step=step)

    return _CallableSink(_log, mlflow.end_run)


@register_sink("neptune")
def _neptune(out_dir, run_name, config):
    try:
        import neptune
    except ImportError:
        log.warning("logger `neptune` requested but neptune is not installed")
        return None
    run = neptune.init_run(name=run_name)
    if config:
        run["parameters"] = _flatten(config)

    def _log(step, metrics):
        for k, v in metrics.items():
            run[k].append(v, step=step)

    return _CallableSink(_log, run.stop)


@register_sink("comet")
def _comet(out_dir, run_name, config):
    try:
        from comet_ml import Experiment
    except ImportError:
        log.warning("logger `comet` requested but comet_ml is not installed")
        return None
    exp = Experiment()
    if run_name:
        exp.set_name(run_name)
    if config:
        exp.log_parameters(_flatten(config))
    return _CallableSink(lambda step, m: exp.log_metrics(m, step=step), exp.end)


@register_sink("aim")
def _aim(out_dir, run_name, config):
    try:
        from aim import Run
    except ImportError:
        log.warning("logger `aim` requested but aim is not installed")
        return None
    run = Run(experiment=run_name)
    if config:
        run["hparams"] = config

    def _log(step, metrics):
        for k, v in metrics.items():
            run.track(v, name=k, step=step)

    return _CallableSink(_log, run.close)


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out
