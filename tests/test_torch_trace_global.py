"""The process's tracer and span observer (``obs/trace.py``) against the JAX
package's, on the CPU.

- The same nested sequence through both packages' module-level ``span``,
  ``traced`` (decorated before a tracer is installed, so it resolves at the
  call) and ``get_tracer().event`` writes the same lines: ``name``,
  ``depth``, ``parent``, ``attrs`` and ``process_index`` equal, times, pids
  and tids aside.
- ``set_tracer(None)`` installs the disabled tracer, which writes nothing;
  the span observer sees every span on it, in the JAX order; an observer
  that raises is ignored and the span's body runs to its end.
- ``process_tracer`` installs a tracer for a block and the disabled one
  after it, also when the block raises.
"""

import json

import pytest
import torch

from hyperscalees_t2i_tpu.obs import trace as jtrace
from hyperscalees_t2i_tpu_torch.obs import trace

torch.set_num_threads(1)
TIMING = ("t0_s", "dur_s", "pid", "tid")


def _sequence(mod):
    """Nested spans, a decorated function and a retroactive event through
    ``mod``'s module-level surface; returns the spans the observer saw."""
    seen = []

    @mod.traced("work", kind="decorated")
    def work(x):
        with mod.span("work/inner", x=x):
            return x + 1

    @mod.traced()
    def bare():
        return None

    mod.set_span_observer(lambda name, dur: seen.append(name))
    try:
        with mod.span("outer", epoch=3, label="a"):
            with mod.span("middle"):
                assert work(1) == 2
            bare()
            t0 = __import__("time").perf_counter()
            mod.get_tracer().event("request", t0, t0 + 0.01, parent="outer", request_id="r0", batch=2)
    finally:
        mod.set_span_observer(None)
    return seen


def _lines(path):
    out = []
    for line in path.read_text().splitlines():
        ev = json.loads(line)
        if ev.get("meta") == "trace_start":
            out.append({"meta": ev["meta"], "process_index": ev["process_index"]})
        else:
            out.append({k: v for k, v in ev.items() if k not in TIMING})
    return out


def test_module_level_spans_write_the_jax_lines(tmp_path):
    got = {}
    for name, mod in (("jax", jtrace), ("port", trace)):
        path = tmp_path / name / "trace.jsonl"
        assert mod.set_tracer(mod.Tracer(path)) is mod.get_tracer()
        try:
            seen = _sequence(mod)
        finally:
            assert not mod.set_tracer(None).enabled
        got[name] = (_lines(path), seen)
    (jlines, jseen), (lines, seen) = got["jax"], got["port"]
    assert lines == jlines
    bare = "_sequence.<locals>.bare"  # traced() without a name: the function's qualified name
    assert seen == jseen == ["work/inner", "work", "middle", bare, "outer"]
    assert [(ln["name"], ln["depth"], ln["parent"]) for ln in lines[1:]] == [
        ("work/inner", 3, "work"), ("work", 2, "middle"), ("middle", 1, "outer"), (bare, 1, "outer"),
        ("request", 0, "outer"), ("outer", 0, None)]
    assert lines[2]["attrs"] == {"kind": "decorated"} and lines[-1]["attrs"] == {"epoch": 3, "label": "a"}


def test_disabled_tracer_writes_nothing_and_the_observer_still_sees(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod in (jtrace, trace):
        assert mod.get_tracer() is mod.set_tracer(None) and not mod.get_tracer().enabled
    assert _sequence(trace) == _sequence(jtrace)
    assert list(tmp_path.iterdir()) == []


def test_a_raising_observer_does_not_stop_the_span(tmp_path):
    ran = []

    def broken(name, dur):
        raise RuntimeError("observer down")

    for mod in (jtrace, trace):
        mod.set_tracer(mod.Tracer(tmp_path / f"{mod.__name__}.jsonl"))
        mod.set_span_observer(broken)
        try:
            with mod.span("a"):
                ran.append(mod.__name__)
        finally:
            mod.set_span_observer(None)
            mod.set_tracer(None)
    assert ran == [jtrace.__name__, trace.__name__]
    for mod in (jtrace, trace):
        assert [e["name"] for e in mod.load_events(tmp_path / f"{mod.__name__}.jsonl")] == ["a"]


def test_process_tracer_resets_however_the_block_ends(tmp_path):
    with trace.process_tracer(tmp_path / "a.jsonl") as tr:
        assert trace.get_tracer() is tr and tr.enabled
        with trace.span("x"):
            pass
    assert not trace.get_tracer().enabled
    with pytest.raises(ValueError):
        with trace.process_tracer(tmp_path / "b.jsonl"):
            raise ValueError("the block fails")
    assert not trace.get_tracer().enabled
    assert [e["name"] for e in trace.load_events(tmp_path / "a.jsonl")] == ["x"]
