"""Measurement window: a budgeted, prioritised, resumable queue of the
port's measurement commands on the card (port of
``hyperscalees_t2i_tpu/tools/window.py``)::

    python -m hyperscalees_t2i_tpu_torch.tools.window --budget_s 3600 \\
        --rungs tiny,flaggen,flagship --out_dir window_runs/w1

Items run in value order; an item whose estimate exceeds the budget left is
skipped loudly (``skipped_budget``, never started and wasted), so the first
minutes bank the most valuable numbers:

1. ``preflight``    — each rung's program measured on the card
   (``tools/preflight.py``; the verdict is against this card);
2. ``bench_ladder`` — the rung ladder (``tools/bench.py``);
3. ``scaling``      — one rung at 1, 2, 4 processes (``--scaling``);
4. ``dispatch_tax`` — the single, chained and eager epoch
   (``tools/dispatch_tax.py``);
5. ``profiled``     — one rung under ``--profile``: the ``torch.profiler``
   window, reconciled at once (``obs/calib.py``) into ``CALIB_r*.json``;
6. ``capacity``     — an open-loop capacity sweep (``tools/loadgen.py
   --sweep``).

The JAX queue's ``cache_warm`` has no counterpart: a CUDA graph cannot be
serialized, so there is no persistent program cache to warm. ``est_s`` are
the card's (NVIDIA H100 80GB HBM3, 700.00 W), about twice what
``chip_smoke.py`` measured for each command or its parts: the ladder of the
default rungs from ``rungs.RUNG_EST_S``, the scaling run's 1 and 2
processes (≈ 70 s on a loaded host) with 4 added, one tiny rung with its
process start (≈ 20 s) for the profiled item, the preflight children and
the capacity sweep's windows from the run-tools and serving-tier phases.

``window_state.json`` is rewritten atomically after every transition, so a
window stopped by SIGTERM, an OOM kill or Ctrl-C resumes where it stopped:
the same command again skips the finished items (their artifacts and
timestamps kept) and runs the rest. The parent imports no torch: device
work happens in children it can stop. With ``--manifest`` each artifact is
checked by ``tools/sentry.py`` as it lands (the port's sentry has no
default manifest). The ``WINDOW_r*.json`` rollup holds the per-item ledger,
the sentry verdicts and the calibration payload, with one schema whether
the window was interrupted or not.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..obs import calib as _calib
from .bench import artifact_stamp

WINDOW_SCHEMA_VERSION = 1
STATE_FILE = "window_state.json"
EXIT_INTERRUPTED = 130

_REPO_ROOT = Path(__file__).resolve().parents[2]
_PKG = "hyperscalees_t2i_tpu_torch"

# terminal item states: resume never re-runs these
_TERMINAL = {"completed", "failed", "skipped_budget", "timeout_budget"}


def _log(msg: str) -> None:
    print(f"[window] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def default_plan(out_dir: Path, rungs: List[str], device: Optional[str] = None) -> List[Dict[str, Any]]:
    """The priority-ordered queue. ``est_s`` are the card's seconds for
    each command (module note); the budget rule reads them, so an
    over-estimate skips early rather than stranding the window mid-item.
    ``stdout_artifact`` items print their result as the last JSON line on
    stdout (the runner's contract); the runner lands it at ``artifact``,
    the rest write ``--out`` themselves. ``device`` (``cpu`` in a CPU
    rehearsal) is passed to every command."""
    first = rungs[0]
    dev = ["--device", device] if device else []
    bench = [sys.executable, "-m", f"{_PKG}.tools.bench"]
    return [
        {
            "name": "preflight", "est_s": 120,
            "argv": [sys.executable, "-m", f"{_PKG}.tools.preflight", "--rungs", ",".join(rungs),
                     "--out", str(out_dir / "preflight"), "--report", str(out_dir / "PREFLIGHT_window.txt"), *dev],
            "artifact": str(out_dir / "preflight" / "programs.jsonl"),
        },
        {
            "name": "bench_ladder", "est_s": 300,
            "argv": [*bench, *dev],
            "env": {"BENCH_RUNGS": ",".join(rungs), "BENCH_BUDGET_S": "540"},
            "artifact": str(out_dir / "BENCH_window.json"),
            "stdout_artifact": True,
        },
        {
            "name": "scaling", "est_s": 180,
            "argv": [*bench, "--scaling", "--rungs", first, "--out", str(out_dir / "SCALING_window.json"), *dev],
            "artifact": str(out_dir / "SCALING_window.json"),
        },
        {
            "name": "dispatch_tax", "est_s": 90,
            "argv": [sys.executable, "-m", f"{_PKG}.tools.dispatch_tax", "--rung", first,
                     "--out", str(out_dir / "DISPATCH_window.json"), *dev],
            "artifact": str(out_dir / "DISPATCH_window.json"),
        },
        {
            "name": "profiled", "est_s": 60,
            "argv": [*bench, "--rung", first, "--profile", str(out_dir / "profile"), *dev],
            "artifact": str(out_dir / "PROFILED_window.json"),
            "stdout_artifact": True,
            "post": "calib",
        },
        {
            "name": "capacity", "est_s": 90,
            "argv": [sys.executable, "-m", f"{_PKG}.tools.loadgen", "--sweep", "--rung", first,
                     "--rates", "4,16,64", "--window_s", "3", "--out", str(out_dir / "CAPACITY_window.json"), *dev],
            "artifact": str(out_dir / "CAPACITY_window.json"),
        },
    ]


def _fresh_item(spec: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "name": spec["name"],
        "est_s": float(spec.get("est_s", 120)),
        "argv": list(spec["argv"]),
        "env": dict(spec.get("env", {})),
        "artifact": spec.get("artifact"),
        "stdout_artifact": bool(spec.get("stdout_artifact", False)),
        "post": spec.get("post"),
        "status": "pending",
        "rc": None,
        "t_start": None,
        "t_end": None,
        "duration_s": None,
        "skip_reason": None,
        "sentry_rc": None,
        "sentry_verdict": None,
        "calib_artifact": None,
    }


# ---------------------------------------------------------------------------
# state persistence (atomic; rewritten after every transition)
# ---------------------------------------------------------------------------

def save_state(state: Dict[str, Any], out_dir: Path) -> None:
    path = out_dir / STATE_FILE
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(state, indent=2, default=str) + "\n")
    os.replace(tmp, path)


def load_state(out_dir: Path) -> Optional[Dict[str, Any]]:
    path = out_dir / STATE_FILE
    if not path.exists():
        return None
    try:
        state = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(
            f"[window] corrupt {path}: {e} — pass --fresh to discard it"
        )
    if state.get("schema") != WINDOW_SCHEMA_VERSION:
        raise SystemExit(
            f"[window] {path} has schema {state.get('schema')!r} != "
            f"{WINDOW_SCHEMA_VERSION} — pass --fresh to discard it"
        )
    return state


def _stamp() -> Dict[str, Any]:
    """The rung runner's provenance stamp (``bench.artifact_stamp``) but its
    schema version: the rollup keeps its own."""
    return {k: v for k, v in artifact_stamp().items() if k != "schema_version"}


# ---------------------------------------------------------------------------
# item execution
# ---------------------------------------------------------------------------

class _Interrupted(Exception):
    pass


def run_item(
    item: Dict[str, Any],
    out_dir: Path,
    remaining_s: float,
    sig: Dict[str, bool],
    extra_env: Dict[str, str],
    persist=None,
) -> None:
    """Run one queue item as a child process, bounded by the remaining
    budget. Mutates ``item`` in place (status/rc/timestamps); ``persist``
    is called right after the item is marked running so a hard kill
    leaves that fact on disk. Raises :class:`_Interrupted` when a signal
    arrived — the caller persists state and exits so resume re-runs this
    item."""
    logs = out_dir / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    log_path = logs / f"{item['name']}.log"
    env = dict(os.environ)
    env.update(extra_env)
    env.update(item.get("env") or {})
    item["status"] = "running"
    item["t_start"] = time.time()
    if persist is not None:
        persist()
    _log(f"item {item['name']}: start (est {item['est_s']:.0f}s, "
         f"{remaining_s:.0f}s budget left)")
    with open(log_path, "ab") as logf:
        logf.write(f"\n==== {item['name']} @ {time.time():.0f} ====\n".encode())
        logf.flush()
        proc = subprocess.Popen(
            item["argv"], stdout=subprocess.PIPE, stderr=logf,
            env=env, cwd=str(_REPO_ROOT), text=True,
        )
        deadline = time.monotonic() + remaining_s
        stdout_lines: List[str] = []
        import threading

        def _pump() -> None:
            for line in proc.stdout:
                stdout_lines.append(line)
                logf.write(line.encode())

        t = threading.Thread(target=_pump, daemon=True)
        t.start()
        interrupted = False
        timed_out = False
        while proc.poll() is None:
            if sig["flag"]:
                interrupted = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.3)
        if sig["flag"]:
            # a group-delivered signal (timeout(1), interactive shells,
            # k8s) kills the child directly, so the poll loop can see it
            # exit before this process's handler ran — the item was
            # interrupted either way, and resume must re-run it rather
            # than record a phantom failure
            interrupted = True
        if interrupted or timed_out:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        t.join(timeout=5)
    item["t_end"] = time.time()
    item["duration_s"] = item["t_end"] - item["t_start"]
    if interrupted:
        item["status"] = "interrupted"
        item["rc"] = None
        raise _Interrupted(item["name"])
    if timed_out:
        item["status"] = "timeout_budget"
        item["rc"] = None
        item["skip_reason"] = (
            f"budget exhausted after {item['duration_s']:.0f}s running"
        )
        _log(f"item {item['name']}: budget exhausted mid-item; terminated")
        return
    item["rc"] = proc.returncode
    if item.get("stdout_artifact") and item.get("artifact"):
        # the runner's contract: the result is the last JSON line on stdout
        # (heartbeats/logs ride stderr)
        last_json = None
        for line in stdout_lines:
            s = line.strip()
            if s.startswith("{"):
                last_json = s
        if last_json is not None:
            Path(item["artifact"]).write_text(last_json + "\n")
    artifact_ok = (not item.get("artifact")
                   or Path(item["artifact"]).exists())
    item["status"] = ("completed"
                      if proc.returncode == 0 and artifact_ok else "failed")
    if item["status"] == "failed" and not artifact_ok:
        item["skip_reason"] = "child exited 0 but artifact missing" \
            if proc.returncode == 0 else None
    _log(f"item {item['name']}: {item['status']} rc={item['rc']} "
         f"in {item['duration_s']:.1f}s")


def run_sentry(
    artifact: str, manifest: Optional[str], out_dir: Path
) -> Dict[str, Any]:
    """Sentry-check one artifact the moment it lands (non-gating here: the
    verdict is recorded in the state/rollup; rc 2 means a breach the
    operator sees while the window still has budget)."""
    if not manifest:
        return {"rc": None, "verdict": None}
    verdict_path = str(out_dir / "verdicts" /
                       (Path(artifact).name + ".verdict.json"))
    Path(verdict_path).parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", f"{_PKG}.tools.sentry", "check", artifact,
         "--manifest", manifest, "--out", verdict_path],
        capture_output=True, text=True, cwd=str(_REPO_ROOT), timeout=300,
    )
    for stream in (proc.stdout, proc.stderr):
        for line in stream.splitlines():
            if line.strip():
                _log(f"sentry[{Path(artifact).name}]: {line}")
    return {"rc": proc.returncode, "verdict": verdict_path}


def run_calib(out_dir: Path, item: Dict[str, Any],
              round_no: int) -> Optional[str]:
    """Reconcile the profiled rung in-process (``obs/calib.py`` reads the
    ``torch.profiler`` traces under ``out_dir`` with the standard library):
    the ``bench/<rung>`` ranges join the rung's ledger record; the profiled
    artifact's ``step_time_s`` is the host-wall fallback."""
    host_measured: Dict[str, float] = {}
    try:
        doc = json.loads(Path(item["artifact"]).read_text())
        if isinstance(doc.get("step_time_s"), (int, float)) and doc.get("rung"):
            host_measured[f"bench/{doc['rung']}"] = float(doc["step_time_s"])
    except (OSError, json.JSONDecodeError, TypeError):
        pass
    payload = _calib.calibrate_run(out_dir, host_measured=host_measured)
    if not payload["rows"] and not payload["trace_files"]:
        _log("calib: no profiler trace and no joinable measurements; skipped")
        return None
    out = out_dir / f"CALIB_r{round_no:02d}.json"
    _calib.write_calib(payload, out)
    head = payload["headline"]
    _log(f"calib: {head['rows']} row(s), {head['device_rows']} device-timed, "
         f"max_error_ratio={head['max_error_ratio']} → {out.name}")
    return str(out)


# ---------------------------------------------------------------------------
# the window loop
# ---------------------------------------------------------------------------

def write_rollup(state: Dict[str, Any], out_dir: Path) -> Path:
    """The committed WINDOW_r*.json: per-item ledger + embedded calib
    payload + sentry worst-case. Schema is identical whether the window
    ran straight through or resumed N times (``incarnations`` counts)."""
    calib_payload = None
    for it in state["items"]:
        if it.get("calib_artifact"):
            calib_payload = _calib.load_calib(it["calib_artifact"])
    sentry_rcs = [it["sentry_rc"] for it in state["items"]
                  if it.get("sentry_rc") is not None]
    rollup = {
        "mode": "window",
        "schema_version": WINDOW_SCHEMA_VERSION,
        "window_id": state["window_id"],
        "round": state["round"],
        "budget_s": state["budget_s"],
        "spent_s": state["spent_s"],
        "incarnations": state["incarnations"],
        "items": state["items"],
        "completed": [it["name"] for it in state["items"]
                      if it["status"] == "completed"],
        "skipped": [it["name"] for it in state["items"]
                    if it["status"] in ("skipped_budget", "timeout_budget")],
        "failed": [it["name"] for it in state["items"]
                   if it["status"] == "failed"],
        "calib": calib_payload,
        "sentry_worst_rc": max(sentry_rcs) if sentry_rcs else None,
        "ts": time.time(),
        **_stamp(),
    }
    out = out_dir / f"WINDOW_r{state['round']:02d}.json"
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(rollup, indent=2, default=str) + "\n")
    os.replace(tmp, out)
    return out


def run_window(args: argparse.Namespace) -> int:
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]

    if args.plan:
        plan_specs = json.loads(Path(args.plan).read_text())
        if not isinstance(plan_specs, list):
            raise SystemExit("[window] --plan must be a JSON list of items")
    else:
        plan_specs = default_plan(out_dir, rungs, args.device)
    if args.items:
        wanted = [s.strip() for s in args.items.split(",") if s.strip()]
        by_name = {p["name"]: p for p in plan_specs}
        unknown = [w for w in wanted if w not in by_name]
        if unknown:
            raise SystemExit(f"[window] unknown items {unknown} "
                             f"(have: {sorted(by_name)})")
        plan_specs = [by_name[w] for w in wanted]

    state = None if args.fresh else load_state(out_dir)
    if state is not None:
        # resume: keep completed/terminal items verbatim (artifacts reused,
        # timestamps untouched); re-queue pending/interrupted ones. The
        # plan's item NAMES must match — a different plan is a different
        # window and must not silently inherit half of another's state.
        names_state = [it["name"] for it in state["items"]]
        names_plan = [p["name"] for p in plan_specs]
        if names_state != names_plan:
            raise SystemExit(
                f"[window] {STATE_FILE} plan {names_state} != requested "
                f"{names_plan} — pass --fresh (or --out_dir elsewhere)"
            )
        state["incarnations"] += 1
        plan_by_name = {p["name"]: p for p in plan_specs}
        for it in state["items"]:
            if it["status"] not in _TERMINAL:
                it["status"] = "pending"
                # re-queued items take their spec from the plan just
                # passed: an operator who edited argv/env/est_s between
                # incarnations means the new spec to apply (terminal
                # items above stay verbatim — their record is history)
                fresh = _fresh_item(plan_by_name[it["name"]])
                for k in ("est_s", "argv", "env", "artifact",
                          "stdout_artifact", "post"):
                    it[k] = fresh[k]
        done = [it["name"] for it in state["items"]
                if it["status"] in _TERMINAL]
        _log(f"resuming window {state['window_id']} "
             f"(incarnation {state['incarnations']}; done: {done or 'none'}; "
             f"{state['spent_s']:.0f}s of {state['budget_s']:.0f}s spent)")
    else:
        round_no = args.round
        if round_no is None:
            taken = [int(p.stem.split("_r")[-1])
                     for p in out_dir.glob("WINDOW_r*.json")
                     if p.stem.split("_r")[-1].isdigit()]
            round_no = (max(taken) + 1) if taken else 1
        state = {
            "schema": WINDOW_SCHEMA_VERSION,
            "window_id": f"w{int(time.time())}",
            "round": int(round_no),
            "budget_s": float(args.budget_s),
            "spent_s": 0.0,
            "incarnations": 1,
            "rungs": rungs,
            "device": args.device,
            "items": [_fresh_item(p) for p in plan_specs],
        }
        save_state(state, out_dir)
        _log(f"window {state['window_id']} round {state['round']}: "
             f"{len(state['items'])} item(s), budget {args.budget_s:.0f}s")

    manifest = "" if args.no_sentry else (args.manifest or "")

    # one ledger for the whole window: every bench child appends here, and
    # the calib join reads it back next to the profile capture
    extra_env = {"BENCH_PROGRAMS_JSONL": str(out_dir / "programs.jsonl")}

    sig = {"flag": False}

    def _on_signal(signum: int, frame: Any) -> None:
        sig["flag"] = True
        _log(f"signal {signum}: finishing state write, then exiting "
             "(re-run the same command to resume)")

    old_term = signal.signal(signal.SIGTERM, _on_signal)
    old_int = signal.signal(signal.SIGINT, _on_signal)
    try:
        for item in state["items"]:
            if item["status"] in _TERMINAL:
                continue
            if sig["flag"]:
                save_state(state, out_dir)
                return EXIT_INTERRUPTED
            remaining = state["budget_s"] - state["spent_s"]
            if item["est_s"] > remaining:
                item["status"] = "skipped_budget"
                item["skip_reason"] = (
                    f"est {item['est_s']:.0f}s > {remaining:.0f}s remaining"
                )
                _log(f"item {item['name']}: skipped ({item['skip_reason']})")
                save_state(state, out_dir)
                continue
            try:
                # run_item persists status=running so it survives hard kills
                run_item(item, out_dir, remaining, sig, extra_env,
                         persist=lambda: save_state(state, out_dir))
            except _Interrupted:
                state["spent_s"] += item["duration_s"] or 0.0
                save_state(state, out_dir)
                _log("interrupted; state persisted — resume with the same "
                     "command")
                return EXIT_INTERRUPTED
            state["spent_s"] += item["duration_s"] or 0.0
            if item["status"] == "completed" and item.get("post") == "calib":
                try:
                    item["calib_artifact"] = run_calib(
                        out_dir, item, state["round"]
                    )
                except Exception as e:
                    _log(f"WARNING: calibration failed "
                         f"({type(e).__name__}: {e})")
            if (item["status"] == "completed" and item.get("artifact")
                    and manifest):
                try:
                    res = run_sentry(item["artifact"], manifest, out_dir)
                    item["sentry_rc"] = res["rc"]
                    item["sentry_verdict"] = res["verdict"]
                    if item.get("calib_artifact"):
                        run_sentry(item["calib_artifact"], manifest, out_dir)
                except Exception as e:
                    _log(f"WARNING: sentry check failed "
                         f"({type(e).__name__}: {e})")
            save_state(state, out_dir)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)

    rollup = write_rollup(state, out_dir)
    done = sum(1 for it in state["items"] if it["status"] == "completed")
    _log(f"window complete: {done}/{len(state['items'])} item(s) done, "
         f"{state['spent_s']:.0f}s of {state['budget_s']:.0f}s spent "
         f"→ {rollup}")
    failed = [it["name"] for it in state["items"]
              if it["status"] == "failed"]
    if failed:
        _log(f"FAILED items: {failed}")
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperscalees_t2i_tpu_torch.tools.window",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--budget_s", type=float, required=True,
                    help="total window budget in seconds — the queue runs "
                         "in priority order and skips items whose estimate "
                         "no longer fits")
    ap.add_argument("--out_dir", default="window_runs/window",
                    help="artifact + state dir (resume = re-run with the "
                         "same dir)")
    ap.add_argument("--rungs", default="tiny",
                    help="comma rung list for the ladder/preflight items "
                         "(first rung drives the single-rung items)")
    ap.add_argument("--device", default=None,
                    help="device of every default item (default: the card; cpu for a CPU rehearsal)")
    ap.add_argument("--round", type=int, default=None,
                    help="WINDOW_r<round>.json rollup number (default: "
                         "next free in out_dir)")
    ap.add_argument("--items", default="",
                    help="comma subset of plan items to run (default: all)")
    ap.add_argument("--plan", default=None,
                    help="JSON file overriding the default plan: a list of "
                         '{"name", "est_s", "argv", "artifact", ...} items '
                         "(tests/CI inject cheap commands here)")
    ap.add_argument("--manifest", default=None,
                    help="sentry baseline manifest for the per-artifact "
                         "checks (default: none, no checks)")
    ap.add_argument("--no_sentry", action="store_true",
                    help="skip the per-artifact sentry checks")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore (discard) an existing window_state.json")
    args = ap.parse_args(argv)
    return run_window(args)


if __name__ == "__main__":
    sys.exit(main())
