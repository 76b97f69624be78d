"""Files, device checks, precision and the result line of a benchmark run.

Everything a cell needs is found by name: `workloads/<cell>.json` names its
configuration (`configs/<config>.json`) and its traffic kind
(`traffic/<kind>.py`); a configuration names its plain reference
(`reference/<file>`, `generator.py` unless it says otherwise);
`BENCHMARK.json` at the checkout's root says which metrics the cell reports;
each per-layer metric is read by `metrics/<metric>.py`.
"""

import contextlib
import importlib.util
import json
import os
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optispeech_tpu")


def checkout_env() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the program's nvcc builds already go to build/ there), and keep
    libraries from loading JAX on their own. Call before importing torch."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one host thread for the CPU's own math: the host's cores drive the card
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_generator(cfg: dict, device):
    """The configuration's plain reference generator, built on `device`:
    the `Generator` of `reference/<file>`, the file named by the
    configuration's `reference` key (default `generator.py`), built from its
    `generator` block. Its weights are torch's until `harness.weights` draws
    them from a seed."""
    import torch

    file = cfg.get("reference", "generator.py")
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*\.py", file):
        raise ValueError(f"reference {file!r}: a file name under benchmark/reference/")
    module = importlib.import_module(f"reference.{file[:-3]}")
    with torch.device(device):
        return module.Generator(cfg["config"]["generator"])


def cell_metrics(cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics `BENCHMARK.json` gives `cell`."""
    m = manifest()

    def applies(metric, e2e_names=None):
        if "workloads" in metric:
            return cell in metric["workloads"]
        return e2e_names is None or metric["moves"] in e2e_names

    e2e = [x for x in m["end_to_end"] if applies(x)]
    names = {x["name"] for x in e2e}
    return e2e, [x for x in m["per_layer"] if applies(x, names)]


def program_config(cfg: dict):
    """The program's ExperimentConfig of a configuration file."""
    from optispeech_tpu_torch.config import ExperimentConfig, from_dict

    return from_dict(ExperimentConfig, cfg["config"])


def apply_precision(cfg: dict) -> None:
    """The precision the configuration states, for the program's run."""
    import torch

    p = cfg["precision"]
    torch.backends.cudnn.allow_tf32 = p["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_allow_tf32"]
    torch.backends.cudnn.benchmark = p["cudnn_benchmark"]


@contextlib.contextmanager
def reference_mode():
    """TF32 off: the reference's products and convolutions in float32."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def require_cards(chips: int) -> str | None:
    """None when `chips` CUDA cards are visible, else the reason."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible"
    return None


def device_record(chips: int, device: str = "cuda") -> dict:
    """The result's device record; a run on the CPU (the tests) says so and
    has no device memory."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def forbidden_loaded() -> list[str]:
    """Modules in sys.modules whose top-level name is forbidden, compared whole."""
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN)


def process_start() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None) -> str:
    """The run's last stdout line; the compared numbers come last, each beside
    its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)


@dataclass
class Context:
    """What a traffic module is given: the cell's name, its workload and
    configuration files, the seed and the device. `control` builds the
    program's lower-precision path in place of the stated one (the control
    run that the comparison's limits are set against)."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float = 10.0  # the window's length
    device: str = "cuda"
    control: bool = False
    log: object = print


def text_width(n: int, bucket: int) -> int:
    """The program's padded text width: n rounded up to its text bucket."""
    return max(-(-max(n, 1) // bucket) * bucket, bucket)
