"""``obs/profile_trace.live_events``: a live ``torch.profiler`` run read
from the profiler's raw results names and times every event as
``prof.events()`` does, on the CPU (a CPU run has host events only, so the
host's device type stands in for the card's), and ``device_kernels`` reads
the same per-name table through it."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyperscalees_t2i_tpu_torch.obs import profile_trace


def _table(pairs):
    out = collections.defaultdict(lambda: [0, 0.0])
    for name, ms in pairs:
        out[name][0] += 1
        out[name][1] += ms
    return dict(out)


def _run(n):
    x, y = torch.zeros(64), torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            x.add_(1.0)
            x = y @ x
    return prof


@pytest.mark.parametrize("n", [1, 50])
def test_live_events_name_and_time_as_the_event_list(n):
    prof = _run(n)
    cpu = torch.autograd.DeviceType.CPU
    fast = _table(profile_trace.live_events(torch, prof, cpu))
    slow = _table((e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
                  if e.device_type == cpu)
    assert fast.keys() == slow.keys() and "aten::add_" in fast
    for name, (count, ms) in slow.items():
        assert fast[name][0] == count, name
        assert fast[name][1] == pytest.approx(ms, rel=1e-9, abs=1e-9), name


def test_live_events_fall_back_to_the_event_list():
    prof = _run(3)

    class EventsOnly:  # a profiler object without raw results
        def events(self):
            return prof.events()

    cpu = torch.autograd.DeviceType.CPU
    got = _table(profile_trace.live_events(torch, EventsOnly(), cpu))
    want = _table(profile_trace.live_events(torch, prof, cpu))
    assert got.keys() == want.keys()
    for name, (count, ms) in want.items():
        assert got[name][0] == count, name
        assert got[name][1] == pytest.approx(ms, rel=1e-9, abs=1e-9), name


def test_device_kernels_of_a_host_only_run_is_empty():
    kernels, busy, n, top = profile_trace.device_kernels(torch, _run(5))
    assert (kernels, busy, n, top) == ({}, 0, 0, [])
