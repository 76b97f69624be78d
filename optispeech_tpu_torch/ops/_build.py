"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface, `build/lib<name>-<hash>.so` beside the package, at
first use. The hash covers the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edit rebuilds. The host C++ sources (`csrc/*.cpp`,
the packed data path's collator) are built the same way by the host
compiler (`CXX`, else g++): `build_host(name)` and `load_host(name)`.
`build_kernels()` starts one nvcc per missing library, all at once, and
waits for all of them; `load(name)` builds one if needed and opens it with
ctypes, one thread at a time for a first load (two threads of one process
would otherwise both run nvcc into the same temporary file). Nothing is
compiled or loaded when a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
# --split-compile=8 runs the optimiser's passes on 8 threads: B1's 32
# instantiations build in 55.4 s in place of 201.6 (chip_smoke.py phase 2,
# with and without the flag, on an H100 machine with CUDA 12.9)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=8", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no -march=native: one build serves any x86-64 host that shares build/
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


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


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def host_library_path(name: str) -> Path:
    """build/lib<name>-<hash>.so of csrc/<name>.cpp, hashed over the source,
    the compiler's name and the flags."""
    flags = " ".join([_cxx(), *CXX_FLAGS]).encode()
    digest = hashlib.sha1((CSRC / f"{name}.cpp").read_bytes() + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_host(name: str) -> dict:
    """Compile csrc/<name>.cpp with the host compiler unless a build of the
    same source exists. Returns {"path", "seconds", "log"}; raises with the
    compiler's output when it fails (there is no other path to fall back on)."""
    path = host_library_path(name)
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{name}: the host compiler {_cxx()!r} could not run: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}: {_cxx()} failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    return {"path": str(path), "seconds": time.perf_counter() - t0, "log": log}


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


_LIBRARIES: dict = {}  # name -> the opened library
_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed. A first load holds
    a lock through the build, so that threads that launch a kernel for the
    first time at once (a server's batcher and its streams) build it once."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBRARIES.get(name)
            if lib is None:
                lib = _LIBRARIES[name] = ctypes.CDLL(build_kernels([name])[name]["path"])
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The host library csrc/<name>.cpp, built first if needed, under the
    same lock as `load`."""
    key = f"host:{name}"
    lib = _LIBRARIES.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBRARIES.get(key)
            if lib is None:
                lib = _LIBRARIES[key] = ctypes.CDLL(build_host(name)["path"])
    return lib
