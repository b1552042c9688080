"""Start N processes of one worker script as one launch of the port (a
gloo group over a ``TCPStore`` on a free local port), for the tests of the
port's multi-process modules. Each worker reads the launcher's variables
(``parallel.mesh.initialize_multihost``). A launch that fails or outlives
its time limit is killed whole, so a stuck worker cannot hang the suite."""

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Sequence

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_env(n: int, rank: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    return env


def run_workers(n: int, script: str, args: Sequence[str] = (), timeout_s: float = 120.0) -> List[str]:
    """Run ``python -c script *args`` as ranks ``0..n-1`` of one launch;
    returns each rank's output. Raises (with every rank's output tail) if a
    rank fails or the launch outlives ``timeout_s``; once one rank fails,
    or at the deadline, every rank still running is killed."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, "-c", script, *args], env=launch_env(n, r, port), cwd=ROOT,
                                  stdout=logs[r], stderr=subprocess.STDOUT, text=True) for r in range(n)]
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed or timed out ({timeout_s:.0f} s):\n" + "\n".join(
            f"rank {r} exit {procs[r].returncode}:\n{outs[r][-3000:]}" for r in range(n)))
    return outs
