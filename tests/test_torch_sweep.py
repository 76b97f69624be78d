"""The port's hyper-parameter sweep (cli/sweep.py) against the JAX
package's: the samplers' draws, the median stopping rule, the objective
curve of a partial metrics line, `best_of` with constraints and `--resume`
each equal JAX's on the same inputs; then a real 2-trial, 2-step sweep of
`optispeech_tpu_torch.cli.train` subprocesses on the CPU, and `--report`."""

import json
import random

import numpy as np
import pytest
import yaml

from optispeech_tpu.cli import sweep as jax_sweep
from optispeech_tpu_torch.cli import sweep

SPACE = {
    "optimizer.lr": {"log_uniform": [1e-5, 1e-3]},
    "scheduler.warmup_steps": {"int_uniform": [100, 2000]},
    "generator.decoder.num_layers": {"choice": [2, 4, 6]},
    "train_args.pretraining_steps": {"uniform": [100.0, 1000.0]},
}


def test_samplers_draw_what_jax_draws():
    for seed in range(16):
        ours, theirs = random.Random(seed), random.Random(seed)
        for _ in range(3):  # a seeded stream: trial after trial
            assert sweep.sample_space(SPACE, ours) == jax_sweep.sample_space(SPACE, theirs)
    a = sweep.sample_space(SPACE, random.Random(7))
    assert 1e-5 <= a["optimizer.lr"] <= 1e-3 and isinstance(a["scheduler.warmup_steps"], int)
    for bad in ({"x": {"grid": [1, 2]}}, {"x": [1, 2]}):
        with pytest.raises(ValueError) as ours:
            sweep.sample_space(bad, random.Random(0))
        with pytest.raises(ValueError) as theirs:
            jax_sweep.sample_space(bad, random.Random(0))
        assert str(ours.value) == str(theirs.value)


def test_pruning_decisions_equal_jax():
    rng = np.random.default_rng(0)
    decisions = []
    for _ in range(400):
        completed = [list(rng.normal(5, 2, int(rng.integers(0, 6))))
                     for _ in range(int(rng.integers(0, 5)))]
        curve = list(rng.normal(5, 2, int(rng.integers(0, 6))))
        kw = dict(direction=str(rng.choice(["min", "max"])),
                  min_evals=int(rng.integers(1, 4)), min_completed=int(rng.integers(1, 4)))
        ours = sweep.should_prune(curve, completed, **kw)
        assert ours == jax_sweep.should_prune(curve, completed, **kw)
        decisions.append(ours)
    assert any(decisions) and not all(decisions)
    done = [[10.0, 8.0, 6.0], [9.0, 7.0, 5.0], [12.0, 9.0, 8.0]]
    assert sweep.should_prune([15.0, 14.0], done, "min")
    assert not sweep.should_prune([9.5, 7.5], done, "min")


def test_objective_curve_of_a_partial_line_equals_jax(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    (d / "metrics.jsonl").write_text(
        json.dumps({"step": 1, "m": 5.0}) + "\n" + json.dumps({"step": 2, "other": 1.0}) + "\n"
        + json.dumps({"step": 2, "m": 4.0}) + "\n" + '{"step": 3, "m": 3.')
    assert sweep.objective_curve(str(d), "m") == jax_sweep.objective_curve(str(d), "m") == [5, 4]
    assert sweep.read_objective(str(d), "m") == 4.0
    assert sweep.read_objective(str(d), "missing") is None
    assert sweep.objective_curve(str(tmp_path / "none"), "m") == []


def test_best_of_with_constraints_equals_jax(tmp_path):
    rows = []
    for i, (mcd, f1, rc) in enumerate([(50.0, 0.05, 0), (60.0, 0.4, 0), (70.0, 0.9, 0),
                                       (40.0, 0.9, 1), (None, 0.9, 0)]):
        d = tmp_path / f"trial_{i:03d}"
        d.mkdir()
        (d / "metrics.jsonl").write_text(json.dumps({"step": 100, "val/f1_score": f1}) + "\n")
        rows.append({"trial": i, "objective": mcd, "returncode": rc, "out_dir": str(d),
                     "params": {}})
    rows[2]["constraint_metrics"] = {"val/f1_score": 0.9}
    for direction in ("min", "max"):
        for cons in (None, [{"metric": "val/f1_score", "op": ">=", "value": 0.3}],
                     [{"metric": "val/f1_score", "op": "<", "value": 0.3}],
                     [{"metric": "val/f1_score", "op": ">=", "value": 0.95}]):
            ours = sweep.best_of(rows, direction, constraints=cons)
            assert ours == jax_sweep.best_of(rows, direction, constraints=cons)
    assert sweep.best_of(rows, "min", [{"metric": "val/f1_score", "value": 0.3}])["trial"] == 1
    assert sweep.best_of(rows, "min", [{"metric": "val/f1_score", "value": 0.95}]) is None


@pytest.mark.parametrize("constraint,match", [
    ({"metric": "val/f1_score", "op": "=>", "value": 0.3}, "op must be one of"),
    ({"op": ">=", "value": 0.3}, "needs a `metric`"),
    ({"metric": "val/f1_score", "op": ">="}, "numeric `value`"),
    ({"metric": "val/f1_score", "value": "high"}, "numeric `value`")])
def test_bad_constraint_exits_before_any_trial(tmp_path, constraint, match):
    """A constraint with a bad op, or without a metric or a numeric value,
    stops the sweep when its spec is read: no trial directory, no results
    file, no trial subprocess."""
    spec = {"base_config": "default", "trials": 2, "seed": 0,
            "space": {"optimizer.lr": {"log_uniform": [1e-5, 1e-3]}},
            "constraints": [{"metric": "val/mcd", "op": "<=", "value": 9}, constraint]}
    spec_path = tmp_path / "spec.yaml"
    spec_path.write_text(yaml.safe_dump(spec))
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match=match):
        sweep.main([str(spec_path), "--out-dir", str(out)])
    assert not out.exists() or not any(out.iterdir())
    assert sweep.check_constraints(spec["constraints"][:1]) == spec["constraints"][:1]
    assert sweep.check_constraints(None) == []


def test_resume_runs_no_recorded_trial(tmp_path, capsys):
    """Every trial recorded: --resume launches nothing and reports JAX's best."""
    spec = {"base_config": "default", "trials": 2, "seed": 0,
            "objective": "total_loss/val_total", "direction": "min",
            "space": {"optimizer.lr": {"log_uniform": [1e-5, 1e-3]}}}
    spec_path = tmp_path / "spec.yaml"
    spec_path.write_text(yaml.safe_dump(spec))
    outs = {}
    for name, module in (("ours", sweep), ("jax", jax_sweep)):
        out = tmp_path / name
        out.mkdir()
        rows = [{"trial": i, "params": {"optimizer.lr": lr}, "objective": obj, "returncode": 0,
                 "out_dir": str(out / f"trial_{i:03d}")}
                for i, (lr, obj) in enumerate([(1e-4, 3.0), (2e-4, 2.0)])]
        (out / "sweep_results.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        best = module.main([str(spec_path), "--out-dir", str(out), "--resume"])
        outs[name] = {k: v for k, v in best.items() if k != "out_dir"}
        assert len((out / "sweep_results.jsonl").read_text().splitlines()) == 2
    assert outs["ours"] == outs["jax"] and outs["ours"]["trial"] == 1


def test_two_trial_sweep_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Two trials of 2 steps at test widths, each a `cli.train` subprocess on
    the CPU: both rows recorded with return code 0, the seeded draws, the
    best reported and reported again by --report. As the in-process trainer
    tests switch the TensorBoard sink off, the trials see a `tensorflow`
    that fails to import, so TensorBoard takes its own stub (~4 s of import
    in place of ~17 s); and as the test files set one torch thread, so do
    the trials (OMP_NUM_THREADS)."""
    import os

    from optispeech_tpu_torch.config import to_dict
    from test_torch_trainer import CLI_OVERRIDES, tiny_config

    stub = tmp_path / "stub" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("tensorflow is switched off")\n')
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(stub.parent), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    base = to_dict(tiny_config())
    base["run_name"] = "sweep-tiny"
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(base))
    spec = {"base_config": str(cfg_path), "trials": 2, "seed": 0,
            "objective": "total_loss/val_total", "direction": "min",
            "train_args": ["--synthetic", "--device", "cpu", "--max-steps", "2"],
            "overrides": CLI_OVERRIDES,
            "space": {"optimizer.lr": {"log_uniform": [1e-5, 1e-3]}}}
    spec_path = tmp_path / "spec.yaml"
    spec_path.write_text(yaml.safe_dump(spec))
    out = tmp_path / "sweep"
    best = sweep.main([str(spec_path), "--out-dir", str(out)])
    rows = [json.loads(line) for line in (out / "sweep_results.jsonl").read_text().splitlines()]
    assert [r["returncode"] for r in rows] == [0, 0], (out / "_trial_000.log").read_text()[-2000:]
    assert all(np.isfinite(r["objective"]) for r in rows)
    assert rows[0]["params"]["optimizer.lr"] != rows[1]["params"]["optimizer.lr"]
    draws = random.Random(0)
    assert [r["params"] for r in rows] == [jax_sweep.sample_space(spec["space"], draws)
                                           for _ in range(2)]
    assert best["objective"] == min(r["objective"] for r in rows)
    capsys.readouterr()
    sweep.main([str(spec_path), "--out-dir", str(out), "--report"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best_trial"] == \
        best["trial"]
