"""Markdown report from the rung runner's documents (port of
``hyperscalees_t2i_tpu/tools/bench_report.py``): no hand-copied numbers.

Usage::

    python -m hyperscalees_t2i_tpu_torch.tools.bench_report BENCH.json [...]
    python -m hyperscalees_t2i_tpu_torch.tools.bench_report --log rungs.log
    python -m hyperscalees_t2i_tpu_torch.tools.bench_report --trend BENCH_a.json SCALING.json SERVE.json ...

Reads the runner's final documents (the one-line JSON with a ``rungs``
map, ``tools/bench.py``) and/or its child's logs (one JSON object a line,
heartbeats ignored) and prints one markdown row per completed rung:
throughput, step time with the single-dispatch/chained split, MFU and the
honesty fields (platform, floor, bound). ``--trend`` renders one row per
document in the order given, with the provenance stamp (schema, git sha,
torch version, platform) and each rung's images/s side by side, then the
scaling, serve, capacity, calibration and quality documents' own tables.
The text is the JAX tool's on the same documents, the stamp column's
version (``torch_version`` here) apart; the reference's records render
their Pallas marks through ``rungs.kernel_marks``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List


def iter_rungs(paths: Iterable[str], logs: Iterable[str]) -> List[Dict]:
    """Completed rung records from artifacts and/or serve logs, in order;
    later records for the same rung name win (retries overwrite)."""
    by_name: Dict[str, Dict] = {}
    for p in paths:
        doc = json.loads(Path(p).read_text())
        if "rungs" not in doc and isinstance(doc.get("parsed"), dict):
            # the wrapper format ({"n", "cmd", "rc", "tail", "parsed"}):
            # the bench's own JSON line lives under "parsed"
            doc = doc["parsed"]
        for name, rec in (doc.get("rungs") or {}).items():
            if "imgs_per_sec" in rec:
                # the map key is authoritative for the rung name (a record
                # without its own "rung" field must not crash the renderer)
                by_name[name] = {**rec, "rung": rec.get("rung", name), "_src": Path(p).name}
    for p in logs:
        for line in Path(p).read_text().splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "imgs_per_sec" in rec and "rung" in rec:
                by_name[rec["rung"]] = {**rec, "_src": Path(p).name}
    return list(by_name.values())


def _fmt(v):
    """Verbatim-enough formatting: the runner already rounds its own fields,
    so render every stored digit (a shorter display would re-introduce the
    hand-transcription mismatch class this tool exists to prevent)."""
    if v is None:
        return "—"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _knobs(r: Dict) -> str:
    """Compact optimization-knob summary for a rung record (schema-additive:
    pre-knob artifacts render "—"). Shares ``rungs.knobs_str`` with the
    preflight report so bench rows and ledger rows read the same."""
    if "remat" not in r and "base_quant" not in r:
        return "—"
    from ..rungs import knobs_str

    return knobs_str(r)


def _trend_marks(rec: Dict) -> str:
    """Kernel/knob markers for a rung's trend cell — the shared
    ``rungs.kernel_marks`` derivation (fuse/q8/uq-/P:...), the fields that
    decide whether two artifacts' throughputs are comparable at all.
    Schema-additive: absent fields render nothing."""
    from ..rungs import kernel_marks

    marks = kernel_marks(rec)
    return f" ({','.join(marks)})" if marks else ""


def render(rungs: List[Dict]) -> str:
    head = (
        "| rung | geometry | pop | knobs | imgs/sec | step s | single-dispatch s | "
        "chain | MFU | TFLOP/step | platform | floor ok | bound | source |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for r in rungs:
        floor = r.get("physical_floor_s")
        step = r.get("step_time_s")
        floor_ok = "—" if floor is None or step is None else ("yes" if step >= floor else "NO")
        rows.append(
            "| {rung} | {geom} | {pop} | {knobs} | {ips} | {st} | {sd} | {ch} | {mfu} | "
            "{tf} | {plat} | {fl} | {bd} | {src} |".format(
                knobs=_knobs(r),
                rung=r.get("rung", "?"),
                geom=r.get("geometry", "?"),
                pop=_fmt(r.get("pop")),
                ips=_fmt(r.get("imgs_per_sec")),
                st=_fmt(step),
                sd=_fmt(r.get("step_time_single_dispatch_s")),
                ch=_fmt(r.get("chain", 0)),
                mfu=_fmt(r.get("mfu")),
                tf=_fmt(r.get("step_tflops")),
                plat=r.get("platform", "?"),
                fl=floor_ok,
                # schema-3 roofline verdict; v1/v2 artifacts render "—"
                bd=_fmt(r.get("roofline_bound")),
                src=r.get("_src", "?"),
            )
        )
    extras = []
    for r in rungs:
        if r.get("kernel_parity_maxdiff") is not None:
            extras.append(
                f"- `{r['rung']}`: Pallas kernel vs fallback max |Δ| = "
                f"{_fmt(r['kernel_parity_maxdiff'])}"
            )
    out = head + "\n" + "\n".join(rows)
    if extras:
        out += "\n\n" + "\n".join(extras)
    return out


def load_artifact(path: str) -> Dict:
    """One artifact document (unwrapping the wrapper format like iter_rungs)."""
    doc = json.loads(Path(path).read_text())
    if "rungs" not in doc and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    return doc


def _is_scaling_doc(doc: Dict) -> bool:
    """SCALING documents (``tools/bench.py --scaling``): a summary list
    keyed by process count instead of a rungs map."""
    return "device_counts" in doc and "summary" in doc


def _is_serve_doc(doc: Dict) -> bool:
    """SERVE documents (``tools/bench.py --serve``): adapter-batched vs
    sequential serving throughput on one rung."""
    return doc.get("mode") == "serve"


def _is_capacity_doc(doc: Dict) -> bool:
    """CAPACITY documents (``tools/loadgen.py --sweep``): the open-loop
    capacity curve with knee + store-churn stats."""
    return doc.get("mode") == "capacity"


def _is_calib_doc(doc: Dict) -> bool:
    """CALIB documents (``obs/calib.py``): measured-vs-model
    reconciliation rows."""
    return doc.get("mode") == "calib"


def _is_quality_doc(doc: Dict) -> bool:
    """QUALITY documents (``obs/quality.py``): the sample-efficiency
    summary of a training run's reward curve."""
    return doc.get("mode") == "quality"


def render_quality(docs: List) -> str:
    """Quality-artifact table: the sample-efficiency headline (final
    combined reward, AUC-over-images, images-to-threshold,
    reward-per-device-second) plus the per-term finals — the trend answers
    "did a PR make the MODEL worse" the same way the rung table answers
    imgs/sec. These columns are higher-is-better (except images-to-
    threshold), the direction the quality sentry gates."""
    term_names: List[str] = []
    for _, doc in docs:
        for k in (doc.get("per_term_final") or {}):
            if k != "combined" and k not in term_names:
                term_names.append(k)
    head_cols = [
        "artifact", "chip", "epochs", "images", "final reward",
        "AUC/images", "imgs→90%", "reward/device-s", "device-s src",
    ] + [f"final {t}" for t in term_names]
    head = ("| " + " | ".join(head_cols) + " |\n"
            "|" + "---|" * len(head_cols))
    rows = []
    for name, doc in docs:
        terms = doc.get("per_term_final") or {}
        cells = [
            name,
            _fmt(doc.get("chip_kind")),
            _fmt(doc.get("epochs")),
            _fmt(doc.get("images_total")),
            _fmt(doc.get("final_reward")),
            _fmt(doc.get("auc_over_images")),
            _fmt(doc.get("images_to_threshold")),
            _fmt(doc.get("reward_per_device_s")),
            _fmt(doc.get("device_s_source")),
        ] + [_fmt(terms.get(t)) for t in term_names]
        rows.append("| " + " | ".join(cells) + " |")
    return head + "\n" + "\n".join(rows)


def render_calib(docs: List) -> str:
    """Calibration-artifact table: one row per reconciled program with the
    roofline prediction next to the profiler measurement — the trend
    answers "is the perf model still honest on this chip" across PRs the
    same way the rung table answers imgs/sec. ``error ratio`` is
    measured/predicted (1.0 = honest; the sentry gates it UP-only)."""
    head = (
        "| artifact | chip | program | source | measured s | predicted s | "
        "error ratio | MFU claimed | MFU measured |\n"
        "|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for name, doc in docs:
        chip = doc.get("chip_kind") or "?"
        for r in doc.get("rows") or []:
            if not isinstance(r, dict):
                continue
            rows.append(
                "| {a} | {c} | {k} | {src} | {m} | {p} | {er} | {mc} | {mm} |"
                .format(
                    a=name, c=chip, k=r.get("key", "?"),
                    src=r.get("measured_source", "?"),
                    m=_fmt(r.get("measured_s")),
                    p=_fmt(r.get("predicted_s")),
                    er=_fmt(r.get("error_ratio")),
                    mc=_fmt(r.get("mfu_claimed")),
                    mm=_fmt(r.get("mfu_measured")),
                )
            )
    return head + "\n" + "\n".join(rows)


def render_capacity(docs: List) -> str:
    """Capacity-artifact table: the headline req/s-at-SLO number plus the
    knee and the store churn that produced it — the trend answers "did a
    PR move the knee" the same way the rung table answers imgs/sec."""
    head = (
        "| artifact | rung | capacity req/s | goodput req/s | knee | "
        "knee p99 | SLO p99 | zipf s | adapters | store budget | "
        "hit rate | evictions | platform |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for name, doc in docs:
        knee = doc.get("knee") or {}
        store = doc.get("store") or {}
        h = store.get("hits") or 0
        m = store.get("misses") or 0
        rows.append(
            "| {a} | {r} | {cap} | {good} | {knee} | {kp99} | {slo} | {z} | "
            "{pop} | {bud} | {hr} | {ev} | {plat} |".format(
                a=name, r=doc.get("rung", "?"),
                cap=_fmt(doc.get("capacity_rps")),
                good=_fmt(doc.get("goodput_rps")),
                knee=(f"{_fmt(knee.get('rate_rps'))} "
                      f"({knee.get('reason', '?')})" if knee else "none"),
                kp99=_fmt(knee.get("p99_open_s")) if knee else "—",
                slo=_fmt(doc.get("slo_p99_s")),
                z=_fmt(doc.get("zipf_s")),
                pop=_fmt(doc.get("population")),
                bud=_fmt(doc.get("store_budget_adapters")),
                hr=_fmt(round(h / (h + m), 4)) if h + m else "—",
                ev=_fmt(store.get("evictions")),
                plat=doc.get("platform", "?"),
            )
        )
    return head + "\n" + "\n".join(rows)


def render_serve(docs: List) -> str:
    """Serve-artifact table: batched vs the naive per-adapter composition
    (the headline ratio) and vs the engine's own one-slot AOT program (the
    batching-only ablation), plus the parity/hot-swap honesty fields."""
    head = (
        "| artifact | rung | adapters | batched img/s | sequential img/s | "
        "ratio | AOT img/s | vs AOT | parity | hot-swap | platform |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for name, doc in docs:
        parity = (
            "bitwise" if doc.get("parity_bitwise")
            else _fmt(doc.get("parity_max_abs_diff"))
        )
        rows.append(
            "| {a} | {r} | {n} | {b} | {s} | {ratio}x | {sa} | {ra}x | {p} | "
            "{hs} | {plat} |".format(
                a=name, r=doc.get("rung", "?"), n=_fmt(doc.get("adapters")),
                b=_fmt(doc.get("batched_imgs_per_sec")),
                s=_fmt(doc.get("sequential_imgs_per_sec")),
                ratio=_fmt(doc.get("batched_vs_sequential")),
                sa=_fmt(doc.get("sequential_aot_imgs_per_sec")),
                ra=_fmt(doc.get("batched_vs_sequential_aot")),
                p=parity,
                hs="yes" if doc.get("hot_swap_effective") else "NO",
                plat=doc.get("platform", "?"),
            )
        )
    return head + "\n" + "\n".join(rows)


def render_scaling(docs: List) -> str:
    """Scaling-artifact table: one row per (artifact, device count) with the
    efficiency column — the 1→N trajectory the plain trend table can't
    carry (its unit is rungs, not device counts)."""
    head = (
        "| artifact | rung | devices | mesh | imgs/sec | imgs/sec/chip | "
        "efficiency | coll bytes/step | coll share | digest |\n"
        "|---|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for name, doc in docs:
        for s in doc.get("summary") or []:
            if s.get("error"):
                rows.append(f"| {name} | {doc.get('rung', '?')} | "
                            f"{s.get('devices', '?')} | — | — | — | — | — | — "
                            f"| {s['error']} |")
                continue
            mesh = s.get("mesh_shape")
            rows.append(
                "| {a} | {r} | {n} | {mesh} | {ips} | {pc} | {eff} | {cb} | "
                "{cs} | {dg} |".format(
                    a=name, r=doc.get("rung", "?"), n=_fmt(s.get("devices")),
                    mesh=("×".join(f"{k}{v}" for k, v in mesh.items())
                          if isinstance(mesh, dict) else "—"),
                    ips=_fmt(s.get("imgs_per_sec")),
                    pc=_fmt(s.get("imgs_per_sec_per_chip")),
                    eff=_fmt(s.get("efficiency")),
                    cb=_fmt(s.get("collective_bytes")),
                    cs=_fmt(s.get("collective_time_share_est")),
                    dg=_fmt(s.get("opt_scores_digest")),
                )
            )
    return head + "\n" + "\n".join(rows)


def render_trend(paths: List[str]) -> str:
    """Cross-PR trajectory table: one row per artifact, in the order given
    (the caller's order IS the timeline — pass files oldest-first).
    Scaling artifacts (``tools/bench.py --scaling``) render as their own table after
    the rung trend — mixing them into the rung columns would compare
    imgs/sec at different device counts as if they were the same unit."""
    all_docs = [(Path(p).name, load_artifact(p)) for p in paths]
    docs = [(n, d) for n, d in all_docs
            if not _is_scaling_doc(d) and not _is_serve_doc(d)
            and not _is_capacity_doc(d) and not _is_calib_doc(d)
            and not _is_quality_doc(d)]
    scaling_docs = [(n, d) for n, d in all_docs if _is_scaling_doc(d)]
    serve_docs = [(n, d) for n, d in all_docs if _is_serve_doc(d)]
    capacity_docs = [(n, d) for n, d in all_docs if _is_capacity_doc(d)]
    calib_docs = [(n, d) for n, d in all_docs if _is_calib_doc(d)]
    quality_docs = [(n, d) for n, d in all_docs if _is_quality_doc(d)]
    # union of rung names that completed anywhere, in ladder-ish order
    rung_names: List[str] = []
    for _, doc in docs:
        for name, rec in (doc.get("rungs") or {}).items():
            if "imgs_per_sec" in rec and name not in rung_names:
                rung_names.append(name)
    out_parts = []
    if docs:
        head_cols = ["artifact", "schema", "git sha", "torch", "platform", "headline imgs/s"]
        head = (
            "| " + " | ".join(head_cols + rung_names) + " |\n"
            "|" + "---|" * (len(head_cols) + len(rung_names))
        )
        rows = []
        for name, doc in docs:
            rungs = doc.get("rungs") or {}
            cells = [
                name,
                _fmt(doc.get("schema_version")),
                _fmt(doc.get("git_sha")),
                _fmt(doc.get("torch_version")),
                _fmt(doc.get("platform")),
                _fmt(doc.get("value")),
            ] + [
                # schema-additive comparability markers (fuse/q8/uq-/P:...):
                # a kernel-on or int8-base rung's throughput only compares
                # to rows with the same marks (_trend_marks)
                _fmt(rungs.get(r, {}).get("imgs_per_sec"))
                + _trend_marks(rungs.get(r, {}))
                for r in rung_names
            ]
            rows.append("| " + " | ".join(cells) + " |")
        out_parts.append(head + "\n" + "\n".join(rows))
    if scaling_docs:
        out_parts.append(render_scaling(scaling_docs))
    if serve_docs:
        out_parts.append(render_serve(serve_docs))
    if capacity_docs:
        out_parts.append(render_capacity(capacity_docs))
    if calib_docs:
        out_parts.append(render_calib(calib_docs))
    if quality_docs:
        out_parts.append(render_quality(quality_docs))
    return "\n\n".join(out_parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifacts", nargs="*", help="the runner's BENCH documents")
    ap.add_argument("--log", action="append", default=[],
                    help="serve-mode log with one JSON line per rung")
    ap.add_argument("--trend", action="store_true",
                    help="cross-PR trajectory: one row per artifact (ordered "
                         "as given), stamp columns + per-rung imgs/sec")
    args = ap.parse_args(argv)
    if args.trend:
        if not args.artifacts:
            print("--trend needs at least one artifact", file=sys.stderr)
            return 1
        print(render_trend(args.artifacts))
        return 0
    rungs = iter_rungs(args.artifacts, args.log)
    if not rungs:
        print("no completed rungs found", file=sys.stderr)
        return 1
    print(render(rungs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
