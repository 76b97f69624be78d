"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface, `build/lib<name>-<hash>.so` beside the package, at
first use. The hash covers the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edit rebuilds.
`build_kernels()` starts one nvcc per missing library, all at once, and
waits for all of them; `load(name)` builds one if needed and opens it with
ctypes. Nothing is compiled or loaded when a module is imported.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, source: Path | None = None) -> Path:
    parts = [(source or CSRC / f"{name}.cu").read_bytes()]
    parts += [header.read_bytes() for header in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=None, sources=None) -> dict:
    """Compile the named kernels (default: every source in csrc/) unless a
    build of the same source exists; one nvcc per source, run in parallel.
    `sources` maps further names to .cu files outside csrc/ (a measuring
    script's probes), built beside them the same way.

    Returns {name: {"path", "seconds", "log"}}; `log` holds nvcc's output
    (ptxas register and shared-memory counts), empty when nothing was built."""
    names = kernel_names() if names is None else list(names)
    sources = {**{name: CSRC / f"{name}.cu" for name in names}, **(sources or {})}
    result, running = {}, {}
    for name, source in sources.items():
        path = library_path(name, source)
        if path.exists():
            result[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())

    def finish(item):  # each build's output and its own seconds, read on a thread
        name, (proc, tmp, path, t0) = item
        log, _ = proc.communicate()
        return name, proc, tmp, path, log, time.perf_counter() - t0

    failed = []
    with ThreadPoolExecutor(max_workers=max(1, len(running))) as pool:
        done = list(pool.map(finish, running.items()))
    for name, proc, tmp, path, log, seconds in done:
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
        result[name] = {"path": str(path), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    return ctypes.CDLL(build_kernels([name])[name]["path"])
