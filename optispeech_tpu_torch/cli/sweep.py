"""Hyper-parameter sweep CLI (port of `optispeech_tpu/cli/sweep.py`):
random search over dotted config overrides.

Each trial launches `python -m optispeech_tpu_torch.cli.train` in a fresh
subprocess, reads the objective metric from the trial's metrics.jsonl, and
appends one JSON line per trial to `sweep_results.jsonl`; the best trial is
reported (and printed again with `--report`). Trials train on the card
unless the spec's `train_args` hold `--device cpu`.

Sweep spec YAML:

    base_config: default          # configs/<name>.yaml or a path
    trials: 8
    seed: 0
    objective: total_loss/val_total   # metric name in metrics.jsonl
    direction: min                # or max
    train_args: ["--packed-train", "train.pak", "--max-steps", "200"]  # extra CLI args
    overrides: ["val_every_n_steps=100"]               # fixed for all trials
    space:
      optimizer.lr: {log_uniform: [1.0e-5, 1.0e-3]}
      scheduler.warmup_steps: {int_uniform: [100, 2000]}
      generator.decoder.num_layers: {choice: [2, 4, 6]}
      train_args.pretraining_steps: {uniform: [100.0, 1000.0]}
    pruning:                      # optional early stopping
      enabled: true               # median stopping rule over partial curves
      min_evals: 2                # evals before a trial is prunable
      min_completed: 2            # completed trials before pruning activates
      poll_s: 5                   # metrics.jsonl poll interval
    constraints:                  # optional winner filter
      - {metric: "val/f1_score", op: ">=", value: 0.15}
      # a trial whose FINAL value violates any constraint cannot win, however
      # good its objective

Trial pruning is the median stopping rule (Golovin et al. 2017): a running
trial is sent SIGTERM (the trainer checkpoints at the step boundary and
exits) once its best objective so far is worse than the median of the
completed trials' at the same eval index. `--resume` continues an
interrupted sweep: completed trials are loaded from sweep_results.jsonl and
the seeded sampler replays the same draws, so the remaining trials get
their original parameters.

Usage:
    python -m optispeech_tpu_torch.cli.sweep SPEC.yaml --out-dir sweeps/lr_search
    python -m optispeech_tpu_torch.cli.sweep SPEC.yaml --out-dir sweeps/lr_search --resume
    python -m optispeech_tpu_torch.cli.sweep SPEC.yaml --out-dir sweeps/lr_search --report
"""

import argparse
import json
import math
import os
import random
import subprocess
import sys
import time

import yaml

from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)


def sample_space(space: dict, rnd: random.Random) -> dict:
    """One random draw from the search space (one sampler key per param)."""
    draw = {}
    for param, spec in space.items():
        if not isinstance(spec, dict) or len(spec) != 1:
            raise ValueError(f"space entry {param!r} must be one {{sampler: args}} mapping")
        (kind, args), = spec.items()
        if kind == "choice":
            draw[param] = rnd.choice(list(args))
        elif kind == "uniform":
            lo, hi = args
            draw[param] = rnd.uniform(float(lo), float(hi))
        elif kind == "log_uniform":
            lo, hi = args
            draw[param] = math.exp(rnd.uniform(math.log(float(lo)), math.log(float(hi))))
        elif kind == "int_uniform":
            lo, hi = args
            draw[param] = rnd.randint(int(lo), int(hi))
        else:
            raise ValueError(
                f"unknown sampler {kind!r} for {param!r} "
                "(choice | uniform | log_uniform | int_uniform)"
            )
    return draw


def read_objective(out_dir: str, metric: str):
    """Last value of `metric` in the trial's metrics.jsonl (None if absent)."""
    curve = objective_curve(out_dir, metric)
    return curve[-1] if curve else None


def objective_curve(out_dir: str, metric: str) -> list[float]:
    """All values of `metric` in eval order from the trial's metrics.jsonl
    (possibly mid-run — the pruner polls this)."""
    path = os.path.join(out_dir, "metrics.jsonl")
    curve = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    break  # a partially-written trailing line mid-run
                if metric in row:
                    curve.append(float(row[metric]))
    return curve


def should_prune(curve: list[float], completed_curves: list[list[float]],
                 direction: str = "min", min_evals: int = 2,
                 min_completed: int = 2) -> bool:
    """Median stopping rule (Golovin et al. 2017, Google Vizier): prune a
    running trial whose best-objective-so-far at eval k is worse than the
    median of the completed trials' best-so-far at the same eval index.
    Conservative gates: at least `min_evals` evals observed and at least
    `min_completed` completed comparison curves long enough at k."""
    k = len(curve)
    if k < min_evals:
        return False
    sign = 1.0 if direction == "min" else -1.0
    best_here = min(sign * v for v in curve)
    peers = [
        min(sign * v for v in c[:k])
        for c in completed_curves
        if len(c) >= k
    ]
    if len(peers) < min_completed:
        return False
    peers.sort()
    median = peers[len(peers) // 2]
    return best_here > median


def run_trial(i: int, spec: dict, draw: dict, trial_dir: str,
              completed_curves: list | None = None) -> dict:
    overrides = list(spec.get("overrides", [])) + [
        f"{k}={v}" for k, v in draw.items()
    ]
    cmd = [
        sys.executable, "-m", "optispeech_tpu_torch.cli.train",
        "--config", str(spec.get("base_config", "default")),
        "--out-dir", trial_dir, "--no-print-config",
        *map(str, spec.get("train_args", [])),
        *overrides,
    ]
    log.info(f"trial {i}: {draw}")
    # the subprocess must import the package whether or not it is installed:
    # prepend the repo root to PYTHONPATH rather than replace it
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    metric = spec.get("objective", "total_loss/val_total")
    direction = spec.get("direction", "min")
    prune_cfg = spec.get("pruning") or {}
    prune = bool(prune_cfg.get("enabled", False)) and completed_curves is not None
    pruned = False
    with open(os.path.join(os.path.dirname(trial_dir) or ".",
                           f"_trial_{i:03d}.log"), "wb") as sink:
        proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT, env=env)
        if prune:
            poll_s = float(prune_cfg.get("poll_s", 5.0))
            min_evals = int(prune_cfg.get("min_evals", 2))
            min_completed = int(prune_cfg.get("min_completed", 2))
            while proc.poll() is None:
                time.sleep(poll_s)
                curve = objective_curve(trial_dir, metric)
                if should_prune(curve, completed_curves, direction,
                                min_evals=min_evals, min_completed=min_completed):
                    log.info(f"trial {i}: pruned at eval {len(curve)} "
                             f"(median stopping rule)")
                    proc.terminate()  # SIGTERM: the trainer checkpoints and exits
                    try:
                        proc.wait(timeout=120)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    pruned = True
                    break
        proc.wait()
    value = read_objective(trial_dir, metric)
    if proc.returncode != 0 and not pruned:
        log.warning(f"trial {i} failed rc={proc.returncode}")
    # final values of every constraint metric, recorded as evidence
    extra = {
        c["metric"]: read_objective(trial_dir, c["metric"])
        for c in spec.get("constraints", []) or []
    }
    return {
        "trial": i, "params": draw, "objective": value,
        "returncode": 0 if pruned else proc.returncode, "pruned": pruned,
        "out_dir": trial_dir, **({"constraint_metrics": extra} if extra else {}),
    }


CONSTRAINT_OPS = (">=", "<=", ">", "<")


def check_constraints(constraints) -> list[dict]:
    """The spec's constraints, each checked before any trial runs: a
    mapping with a `metric`, a numeric `value` and an `op` among
    CONSTRAINT_OPS (default ">="). Raises ValueError naming the first bad
    one."""
    constraints = constraints or []
    if not isinstance(constraints, list):
        raise ValueError(f"constraints must be a list, got {constraints!r}")
    for c in constraints:
        if not isinstance(c, dict) or not c.get("metric"):
            raise ValueError(f"constraint {c!r} needs a `metric`")
        if c.get("op", ">=") not in CONSTRAINT_OPS:
            raise ValueError(f"constraint {c!r}: op must be one of {', '.join(CONSTRAINT_OPS)}")
        value = c.get("value")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"constraint {c!r} needs a numeric `value`")
    return constraints


def _meets(value, op: str, target: float) -> bool:
    if value is None:
        return False
    return {
        ">=": value >= target, "<=": value <= target,
        ">": value > target, "<": value < target,
    }[op]


def satisfies_constraints(result: dict, constraints: list[dict]) -> bool:
    """A trial can win only if the FINAL value of every constraint metric
    meets its bound (read from the trial's directory where the results row
    lacks it)."""
    for c in constraints or []:
        value = (result.get("constraint_metrics") or {}).get(c["metric"])
        if value is None:
            value = read_objective(result["out_dir"], c["metric"])
        if not _meets(value, c.get("op", ">="), float(c["value"])):
            return False
    return True


def best_of(results: list[dict], direction: str,
            constraints: list[dict] | None = None) -> dict | None:
    scored = [r for r in results if r.get("objective") is not None and r["returncode"] == 0]
    if constraints:
        ok = [r for r in scored if satisfies_constraints(r, constraints)]
        for r in scored:
            if r not in ok:
                log.info(f"trial {r['trial']}: excluded by constraints "
                         f"({r.get('constraint_metrics')})")
        scored = ok
    if not scored:
        return None
    key = lambda r: r["objective"]
    return min(scored, key=key) if direction == "min" else max(scored, key=key)


def main(argv=None):
    p = argparse.ArgumentParser(description="Random-search hyperparameter sweep")
    p.add_argument("spec", help="sweep spec YAML (see module docstring)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--report", action="store_true",
                   help="just re-print results from a finished sweep")
    p.add_argument("--resume", action="store_true",
                   help="skip trials already recorded in sweep_results.jsonl "
                        "(same seed replays the identical parameter draws, so "
                        "an interrupted sweep continues where it stopped)")
    args = p.parse_args(argv)

    with open(args.spec) as f:
        spec = yaml.safe_load(f)
    direction = spec.get("direction", "min")
    metric = spec.get("objective", "total_loss/val_total")
    # a bad constraint fails here, not in best_of after every trial has run
    try:
        constraints = check_constraints(spec.get("constraints"))
    except ValueError as e:
        raise SystemExit(f"{args.spec}: {e}") from e
    results_path = os.path.join(args.out_dir, "sweep_results.jsonl")

    if args.report:
        with open(results_path) as f:
            results = [json.loads(l) for l in f]
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        results = []
        if os.path.exists(results_path):
            if args.resume:
                with open(results_path) as f:
                    results = [json.loads(l) for l in f]
                log.info(f"resuming: {len(results)} completed trials loaded")
            else:
                # a fresh sweep must not mix with a previous run's trials
                # (duplicate trial indices would corrupt --report / best_of)
                os.replace(results_path, results_path + ".old")
                log.info(f"previous results moved to {results_path}.old")
        done = {r["trial"] for r in results}
        rnd = random.Random(spec.get("seed", 0))
        for i in range(int(spec.get("trials", 8))):
            # draw unconditionally: the seeded stream replays the same
            # parameters for completed trials, keeping resume deterministic
            draw = sample_space(spec.get("space", {}), rnd)
            if i in done:
                continue
            trial_dir = os.path.join(args.out_dir, f"trial_{i:03d}")
            completed_curves = [
                objective_curve(r["out_dir"], metric) for r in results
                if r.get("returncode") == 0
            ]
            result = run_trial(i, spec, draw, trial_dir,
                               completed_curves=completed_curves)
            results.append(result)
            with open(results_path, "a") as f:
                f.write(json.dumps(result) + "\n")
            log.info(f"trial {i}: objective={result['objective']}"
                     + (" (pruned)" if result.get("pruned") else ""))

    best = best_of(results, direction, constraints=constraints)
    if best is None:
        raise SystemExit("no trial produced the objective metric "
                         "(or every trial violated the constraints)")
    print(json.dumps({"best_trial": best["trial"], "objective": best["objective"],
                      "params": best["params"], "out_dir": best["out_dir"]}), flush=True)
    return best


if __name__ == "__main__":
    main()
