"""Run the trainer as N coordinated processes on one machine (port of
``hyperscalees_t2i_tpu/tools/launch_local.py``).

A launch over several machines starts one trainer process a machine, each
told where process 0's store listens::

    # machine i of N:
    python -m hyperscalees_t2i_tpu_torch.train.cli --coordinator host0:8476 \\
        --num_processes N --process_id $I ...

This tool makes that launch on one machine::

    python -m hyperscalees_t2i_tpu_torch.tools.launch_local --num_processes 2 \\
        -- --backend sana_one_step --model_scale tiny --device cpu ...

Everything after ``--`` goes to ``train.cli`` on every process, after the
launch's flags (``--coordinator 127.0.0.1:<free port> --num_processes N
--process_id i``). Without ``--device`` each process takes ``cuda:{i %
cards}``: on a host with one card every process shares it, each with its
own CUDA context. Each child's output streams to stderr prefixed with
``[p<i>]``. One failed process fails the launch: its status is the first
real child exit code in rank order (a real code beats the SIGTERM its
peers got when the launch was stopped), else the highest signal death
(128 + signal), else 0.

- ``--kill_host I --kill_after_s T``: SIGKILL child ``I`` after ``T``
  seconds (an external hard failure).
- ``--grace_s G``: after a child fails, wait up to ``G`` seconds for the
  others to exit on their own before stopping them (default 0: stop at
  once).
- ``--relaunch_num_processes M``: after the first launch exits, launch the
  same arguments again as ``M`` processes (a fresh coordinator port), with
  ``--relaunch_args`` appended and ``HYPERSCALEES_FAULTS`` cleared, and
  return that launch's status.

``--devices_per_process D``: a JAX process of D local devices is D
processes of the port (a process drives one device), so the launch starts
``num_processes × D`` children with ``HYPERSCALEES_PROCESSES_PER_HOST=D``:
the trainer groups them into ``num_processes`` hosts of D consecutive ranks,
each host one member slice split over a pop × data mesh of its D processes
(``train.cli --pop_shards``). ``--kill_host I`` then kills every process of
host ``I``.

:func:`die_with_parent` is the first call of a child that must not outlive
the process that started it (the rung runner's children, ``chip_smoke.py``'s).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

CLI = ("-m", "hyperscalees_t2i_tpu_torch.train.cli")


def die_with_parent(parent: int) -> None:
    """Have the kernel SIGKILL this process when the thread that started it
    ends (Linux ``PR_SET_PDEATHSIG``), however it ended; leave at once if
    ``parent``, the process that started it, has already gone. Raises
    where the call fails."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent:
        os._exit(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(proc: subprocess.Popen, prefix: str) -> None:
    for line in proc.stdout:  # text mode
        sys.stderr.write(f"{prefix} {line}")
        sys.stderr.flush()


def run_pod(
    num_processes: int,
    fwd: List[str],
    *,
    timeout_s: float = 900.0,
    grace_s: float = 0.0,
    kill_host: Optional[int] = None,
    kill_after_s: float = 0.0,
    clear_faults: bool = False,
    port: int = 0,
    entry: Sequence[str] = CLI,
    env: Optional[Dict[str, str]] = None,
    devices_per_process: int = 1,
) -> int:
    """One coordinated launch of ``num_processes`` hosts of
    ``devices_per_process`` children each, every child ``python <entry>
    --coordinator 127.0.0.1:<port> --num_processes N·D --process_id i
    <fwd>`` (``entry``: the train CLI's module; another entry must run the
    CLI's ``main`` on those arguments) in this process's environment plus
    ``env`` and ``HYPERSCALEES_PROCESSES_PER_HOST=D``; returns the launch's
    exit status. ``kill_host`` names a host: all its children are killed."""
    if devices_per_process < 1:
        raise ValueError(f"--devices_per_process must be >= 1, got {devices_per_process}")
    per_host = devices_per_process
    num_processes = num_processes * per_host
    port = port or _free_port()
    procs: List[subprocess.Popen] = []
    pumps: List[threading.Thread] = []
    killer: Optional[threading.Timer] = None
    try:
        for pid in range(num_processes):
            child_env = {**os.environ, **(env or {}), "HYPERSCALEES_PROCESSES_PER_HOST": str(per_host)}
            if clear_faults:  # a relaunch replays armed epochs: faults would fire again
                child_env.pop("HYPERSCALEES_FAULTS", None)
            cmd = [sys.executable, *entry, "--coordinator", f"127.0.0.1:{port}",
                   "--num_processes", str(num_processes), "--process_id", str(pid), *fwd]
            procs.append(subprocess.Popen(cmd, env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
            t = threading.Thread(target=_pump, args=(procs[-1], f"[p{pid}]"), daemon=True)
            t.start()
            pumps.append(t)
        if kill_host is not None and 0 <= kill_host * per_host < len(procs):
            victims = procs[kill_host * per_host:(kill_host + 1) * per_host]

            def _kill():
                if any(v.poll() is None for v in victims):
                    print(f"[launch_local] KILL: SIGKILL host {kill_host} after {kill_after_s:.1f}s",
                          file=sys.stderr, flush=True)
                    for v in victims:
                        if v.poll() is None:
                            v.kill()

            killer = threading.Timer(max(0.0, kill_after_s), _kill)
            killer.daemon = True
            killer.start()

        deadline = time.monotonic() + timeout_s
        failed_at: Optional[float] = None
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes):
                bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
                if failed_at is None:
                    failed_at = time.monotonic()
                    print(f"[launch_local] process(es) {bad} failed — "
                          + (f"grace window {grace_s:.0f}s for the survivors" if grace_s > 0
                             else "stopping the launch"), file=sys.stderr, flush=True)
                # a dead process leaves its peers blocked in a gather: stop
                # them after the grace window, not at the timeout
                if time.monotonic() - failed_at >= grace_s:
                    break
            time.sleep(0.2)
        else:
            print("[launch_local] TIMEOUT — stopping the launch", file=sys.stderr, flush=True)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(137)
        for t in pumps:
            t.join(timeout=5)
        # real exit codes beat signal deaths; a signal death reads as the
        # shell's 128 + signal
        normalized = [rc if rc >= 0 else 128 - rc for rc in rcs]
        real = [rc for rc in normalized if 0 < rc < 128]
        return real[0] if real else max(normalized)
    finally:
        if killer is not None:
            killer.cancel()
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                    p.wait(timeout=20)
                except Exception:
                    p.kill()
                    p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Launch N coordinated local trainer processes")
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--devices_per_process", type=int, default=1,
                    help="devices of each launched host: D processes of one device each")
    ap.add_argument("--coordinator_port", type=int, default=0, help="0 = pick a free one")
    ap.add_argument("--timeout_s", type=float, default=900.0)
    ap.add_argument("--kill_host", type=int, default=None,
                    help="SIGKILL this child after --kill_after_s seconds (an external hard failure)")
    ap.add_argument("--kill_after_s", type=float, default=5.0, help="wall-clock delay before --kill_host fires")
    ap.add_argument("--grace_s", type=float, default=0.0,
                    help="after one child fails, wait this long for the others to exit on their own before "
                         "stopping them")
    ap.add_argument("--relaunch_num_processes", type=int, default=0,
                    help="after the launch exits, launch the same arguments as M processes (fresh coordinator; "
                         "faults cleared) and return its exit status")
    ap.add_argument("--relaunch_args", default="", help="extra train.cli flags for the relaunch only")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER, help="arguments after -- go to train.cli")
    args = ap.parse_args(argv)
    fwd = args.cli_args
    if fwd and fwd[0] == "--":
        fwd = fwd[1:]

    rc = run_pod(args.num_processes, fwd, timeout_s=args.timeout_s, grace_s=args.grace_s,
                 kill_host=args.kill_host, kill_after_s=args.kill_after_s, port=args.coordinator_port,
                 devices_per_process=args.devices_per_process)
    if args.relaunch_num_processes > 0:
        print(f"[launch_local] first launch exited rc={rc} — relaunching at {args.relaunch_num_processes} "
              "process(es)", file=sys.stderr, flush=True)
        rc = run_pod(args.relaunch_num_processes, fwd + shlex.split(args.relaunch_args),
                     timeout_s=args.timeout_s, clear_faults=True, devices_per_process=args.devices_per_process)
    return rc


if __name__ == "__main__":
    sys.exit(main())
