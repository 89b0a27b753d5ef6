"""The readers of the idle time charged to the program's own spans, fed
hand-built traces: the division by frames or calls, two spans summed,
0 for a span that ran outside the ten largest idle entries, None for a
span that did not run and None without the calls' records."""

import pytest

from portbench import harness as H
from portbench.trace import Trace

# metric → (its spans, the record it divides by)
READERS = {
    "track_setup_idle_ms": (("track.setup",), "track_frames"),
    "track_flush_idle_ms": (("track.pack", "track.deliver"), "track_frames"),
    "track_step_idle_ms": (("track.step",), "track_frames"),
    "refine_data_idle_ms": (("refine.data",), "refine_calls"),
    "refine_setup_idle_ms": (("refine.setup", "refine.finish"),
                             "refine_calls"),
    "refine_iter_idle_ms": (("refine.iteration",), "refine_calls"),
}
BENCH = H.read_json(H.ROOT / "BENCHMARK.json")


def _reader(name):
    return H.load_module(H.HERE / "metrics" / f"{name}.py")


def _layer(per, n):
    """The calls' records of ``n`` frames (tracking) or ``n`` calls."""
    if per == "track_frames":
        return {"track_frames": [(4, 8192, 5)] * n}
    return {"refine_calls": n}


def _trace(gaps, ran):
    labels = {k: 0.0 for k in ran}
    labels["bench.window"] = 0.0
    return Trace(5.0, 4.0, labels, {}, [[n, s] for n, s in gaps])


@pytest.mark.parametrize("name", sorted(READERS))
def test_divided_by_frames_or_calls(name):
    spans, per = READERS[name]
    gaps = [("bench.deliver", 0.5), (spans[0], 0.3), ("host", 0.1)]
    for n in (1, 4):
        ctx = H.Ctx(_trace(gaps, spans), _layer(per, n))
        assert _reader(name).read(ctx) == pytest.approx(300.0 / n)


@pytest.mark.parametrize("name", sorted(n for n, (s, _) in READERS.items()
                                        if len(s) == 2))
def test_two_spans_summed(name):
    spans, per = READERS[name]
    gaps = [(spans[0], 0.2), ("host", 0.1), (spans[1], 0.05)]
    ctx = H.Ctx(_trace(gaps, spans), _layer(per, 2))
    assert _reader(name).read(ctx) == pytest.approx(125.0)
    # One of the two ran alone: it alone is read.
    ctx = H.Ctx(_trace(gaps[:2], spans[:1]), _layer(per, 2))
    assert _reader(name).read(ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_zero_where_the_span_ran_outside_the_largest_entries(name):
    spans, per = READERS[name]
    gaps = [(f"aten::op{i}", 0.01 * (10 - i)) for i in range(10)]
    ctx = H.Ctx(_trace(gaps, spans), _layer(per, 3))
    assert _reader(name).read(ctx) == 0.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_no_span_ran(name):
    """The parent's program opens none of the spans: its traced runs
    leave the metric out, whatever the gaps hold."""
    spans, per = READERS[name]
    gaps = [(spans[0], 0.3), ("host", 0.1)]
    ctx = H.Ctx(_trace(gaps, ("refine.raycast", "aten::mm")),
                _layer(per, 3))
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_without_the_calls_records(name):
    spans, per = READERS[name]
    trace = _trace([(spans[0], 0.3)], spans)
    assert _reader(name).read(H.Ctx(trace, {})) is None
    assert _reader(name).read(H.Ctx(trace, _layer(per, 0))) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_listed_for_its_cell(name):
    """Each reader's entry names the cell whose calls record what it
    divides by, and a layer of the entries in PERF.md's list."""
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    per = READERS[name][1]
    cell = "track.buddha1m" if per == "track_frames" else "refine.buddha1m"
    assert entry["workloads"] == [cell]
    assert entry["layer"] == ("Tracking entry" if per == "track_frames"
                              else "Refine entry")
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "ms", "lower", "device_trace")
    assert name in H.resolve(BENCH, cell).metric_files
