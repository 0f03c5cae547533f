"""The program's spans (tpu_reid_torch.runtime.observe.span) in the trace
reduction: they reach it as host operations of the window's thread, never
as device events, so they change none of busy time, idle time, `complete`
or the device operations, and they name the idle gaps in which the host ran
no traced operation."""

import contextlib

import pytest
import torch

from portbench.tests.test_portbench_trace import CPU, EVENTS, ev
from portbench.trace import TraceData, Tracer

SPANS = [ev("reid.extract.batch", 50, 999), ev("reid.extract.upload", 60, 320),
         ev("reid.extract.wait", 600, 990)]


def _numbers(t: TraceData):
    return t.busy_s, t.window_s, t.complete, t.launches, t.device_ops()


def test_spans_change_no_number_and_name_the_gaps():
    bare = TraceData.from_events(EVENTS, "bench.window")
    spanned = TraceData.from_events(EVENTS + SPANS, "bench.window")
    assert _numbers(spanned) == _numbers(bare)
    gaps = dict(spanned.idle_gaps())
    # the gap in which the host ran no op is the wait's; the copy's stays
    assert gaps["bench.window / reid.extract.wait"] == pytest.approx(97e-6)
    assert gaps["bench.window / aten::copy_"] == pytest.approx(200e-6)
    assert not any("no traced op" in k for k in gaps)
    assert sum(gaps.values()) == pytest.approx(sum(dict(bare.idle_gaps()).values()))


def test_a_span_on_another_thread_is_not_the_windows():
    other = [ev("reid.train.step", 902, 999, thread=2)]
    t = TraceData.from_events(EVENTS + other, "bench.window")
    assert "bench.window / host: no traced op" in dict(t.idle_gaps())


def test_the_programs_span_is_a_host_op_in_a_profiled_window():
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_reid_torch.runtime.observe import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with span("reid.train.step", step=1):
                torch.ones(8) + 1
    events = prof.events()
    (rec,) = [e for e in events if e.name == "reid.train.step"]
    assert rec.device_type == CPU
    t = TraceData.from_events(events, "bench.window")
    assert "reid.train.step" in [n for n, _, _ in t.host]
    assert not t.device


@pytest.mark.card
def test_spans_leave_no_device_event_on_the_card(card):
    from tpu_reid_torch.runtime.observe import span

    x = torch.randn(512, 512, device=card)

    def window(spanned):
        tr = Tracer("bench.window")
        tr.start()
        for i in range(4):
            with span("reid.extract.batch", batch=i) if spanned else contextlib.nullcontext():
                x @ x
        tr.stop()
        return tr.reduce()

    window(True)  # warm
    t, bare = window(True), window(False)
    assert t.complete and bare.complete
    assert not any(n.startswith("reid.") for n, _, _ in t.device)
    assert [n for n, _, _ in t.host].count("reid.extract.batch") == 4
    assert (t.launches, len(t.device)) == (bare.launches, len(bare.device))

