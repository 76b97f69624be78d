"""Launching the port's data- and tensor-parallel tests on the CPU: a few
processes of one `torch.distributed` group over gloo, each with its own
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
one torch thread. Every process has its own time limit; when one runs out,
the whole cohort is killed, so that a dead peer fails the test and never
hangs the suite."""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 60  # a collective waits this long for a dead peer, then raises
LAUNCH_TIMEOUT_S = 240  # one process of a cohort, start to end


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def base_env(tf_stub: Path | None = None) -> dict:
    """The environment of a launched process: the repo and the tests on the
    path (and, where given, a `tensorflow` stub that fails to import, so
    that rank 0's TensorBoard sink takes its own stub), one thread."""
    env = dict(os.environ)
    paths = [str(REPO), str(REPO / "tests")] + ([str(tf_stub)] if tf_stub else [])
    env["PYTHONPATH"] = os.pathsep.join(paths + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


def tf_stub(root: Path) -> Path:
    """A directory holding a `tensorflow` package that raises ImportError."""
    stub = root / "tf_stub" / "tensorflow"
    stub.mkdir(parents=True, exist_ok=True)
    (stub / "__init__.py").write_text('raise ImportError("tensorflow is switched off")\n')
    return stub.parent


def _run_cohort(procs, timeout_s):
    outs, failed = [], None
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout_s)
            outs.append(out)
    except subprocess.TimeoutExpired:
        failed = "timed out"
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    if failed:
        raise AssertionError(f"a process of the cohort {failed} after {timeout_s} s; all killed")
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"processes failed {bad}:\n" + "\n".join(
        f"--- process {i}\n{outs[i][-4000:]}" for i, _ in bad)
    return outs


def launch_ranks(world: int, argv: list, env: dict | None = None,
                 timeout_s: float = LAUNCH_TIMEOUT_S) -> list:
    """Start `world` processes of `python argv...` as ranks 0..world-1 of one
    group on a free port; returns their outputs (stdout and stderr)."""
    env = dict(env or base_env())
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env={**env, "RANK": str(rank),
                                                    "LOCAL_RANK": str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    return _run_cohort(procs, timeout_s)


def torchrun(nproc: int, module_argv: list, env: dict | None = None,
             timeout_s: float = LAUNCH_TIMEOUT_S) -> str:
    """`python -m torch.distributed.run --standalone --nproc_per_node nproc
    -m module_argv...`: the launcher and its workers in one session, killed
    together on a timeout. Returns the output."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), "-m", *module_argv], cwd=REPO, env=env or base_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    return _run_cohort([proc], timeout_s)[0]
