"""Cross-run regression sentry: gate a new run against prior runs (port of
``hyperscalees_t2i_tpu/tools/sentry.py``).

Usage::

    # a candidate against prior runs
    python -m hyperscalees_t2i_tpu_torch.tools.sentry check runs/new \\
        --baseline runs/prior1 --baseline runs/prior2

    # against a manifest written earlier by `baseline`
    python -m hyperscalees_t2i_tpu_torch.tools.sentry check runs/new --manifest baseline.json

    # write a manifest from known-good runs
    python -m hyperscalees_t2i_tpu_torch.tools.sentry baseline --out baseline.json runs/good1 runs/good2

Sources are those of ``obs/regress.ingest``: run dirs, ``*.jsonl`` ledgers
and ``BENCH_*``/``CAPACITY_*``/``DEGRADE_*``/``CALIB_*``/``WINDOW_r*``/
``QUALITY_*``/``FLEET_*`` artifacts. A manifest is read only when
``--manifest`` names it: there is no default file (the JAX package's
``SENTRY_BASELINE.json`` holds TPU numbers).

``check`` writes ``sentry_verdict.json`` into the candidate run dir (``--out``
elsewhere; the trainer's ``/healthz`` reports that file as
``sentry_verdict``), prints each breach naming the metric, its baseline and
the observed value, and exits 2 on a breach, 1 on a usage or ingest error, 0
on a pass.

Write a manifest only from runs whose change of speed was intended and
reviewed: a baseline that follows every regression never fires.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from ..obs import regress

EXIT_BREACH = 2


def _ingest_sources(paths: List[str]) -> List[List[regress.Observation]]:
    out = []
    for p in paths:
        obs = regress.ingest(p)
        if not obs:
            print(f"[sentry] WARNING: no observations in {p}", file=sys.stderr)
        out.append(obs)
    return out


def cmd_baseline(args: argparse.Namespace) -> int:
    baselines = regress.build_baselines(_ingest_sources(args.sources))
    excluded = {m.strip() for m in (args.exclude or "").split(",") if m.strip()}
    baselines = [b for b in baselines if b.metric not in excluded]
    if not baselines:
        print("[sentry] ERROR: no observations in any baseline source", file=sys.stderr)
        return 1
    merged = 0
    if args.merge:
        # keep the manifest's entries that the new sources did not observe again
        fresh = {(b.metric, b.key) for b in baselines}
        kept = [b for b in regress.load_manifest(args.out)["baselines"]
                if (b.metric, b.key) not in fresh and b.metric not in excluded]
        merged = len(kept)
        baselines = sorted(kept + baselines, key=lambda b: (b.metric, b.key))
    out = regress.write_manifest(args.out, baselines, note=args.note)
    print(f"sentry manifest → {out} ({len(baselines)} baselines"
          + (f", kept {merged} existing" if args.merge else "")
          + (f", excluded {sorted(excluded)}" if excluded else "")
          + f", gen_torch={regress.running_torch_version()})")
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    baselines: List[regress.Baseline] = []
    baseline_torch = None
    if args.manifest:
        m = regress.load_manifest(args.manifest)
        baselines.extend(m["baselines"])
        baseline_torch = m["gen_torch"]
    if args.baseline:
        baselines.extend(regress.build_baselines(_ingest_sources(args.baseline)))
        # ingested under the running torch: no skip
        if baseline_torch is None:
            baseline_torch = regress.running_torch_version()
    if not baselines:
        print("[sentry] ERROR: need --baseline and/or --manifest", file=sys.stderr)
        return 1

    candidate = Path(args.candidate)
    verdict = regress.evaluate(baselines, regress.ingest(candidate), torch_version=regress.running_torch_version(),
                               baseline_torch=baseline_torch)
    verdict["candidate"] = str(candidate)
    out = Path(args.out) if args.out else (
        candidate / regress.VERDICT_FILE if candidate.is_dir() else Path(regress.VERDICT_FILE))
    regress.write_verdict(verdict, out)

    print(f"# sentry verdict: {out}")
    print(f"checked {verdict['checked']} baselines ({len(verdict['skipped'])} skipped) against {candidate}")
    for s in verdict["skipped"]:
        print(f"  skip {s['metric']}[{s['key']}]: {s['reason']}")
    if verdict["breaches"]:
        for b in verdict["breaches"]:
            worse = "above" if b["direction"] == "upper" else "below"
            print(f"BREACH {b['metric']}[{b['key']}]: observed {b['observed']:.6g} is {worse} bound {b['bound']:.6g} "
                  f"(baseline {b['baseline']:.6g} ± MAD {b['baseline_mad']:.3g} over {b['baseline_n']} run(s); "
                  f"from {b['source']})")
        print(f"VERDICT: FAIL — {len(verdict['breaches'])} regression(s)")
        return EXIT_BREACH
    print("VERDICT: pass")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("baseline", help="write a baseline manifest from known-good runs")
    b.add_argument("sources", nargs="+", help="run dirs / *.jsonl ledgers / *.json artifacts")
    b.add_argument("--out", required=True, help="the manifest to write")
    b.add_argument("--note", default="", help="free-text provenance stored in the manifest")
    b.add_argument("--exclude", default="",
                   help="comma list of metric classes to leave out (e.g. step_time_s,compile_s for a manifest "
                        "checked on another machine)")
    b.add_argument("--merge", action="store_true",
                   help="merge into the --out manifest: entries the new sources observe again are replaced")
    b.set_defaults(fn=cmd_baseline)

    c = sub.add_parser("check", help="check a candidate against baselines")
    c.add_argument("candidate", help="run dir / ledger / artifact to check")
    c.add_argument("--baseline", action="append", default=[], help="prior-run source (repeatable)")
    c.add_argument("--manifest", default=None, help="a manifest written by `baseline`")
    c.add_argument("--out", default=None, help="verdict path (default: <candidate>/sentry_verdict.json)")
    c.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"[sentry] ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
