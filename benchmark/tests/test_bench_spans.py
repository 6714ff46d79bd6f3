"""``harness/spans.py`` and ``spans_report.py`` on a synthetic Chrome
trace."""
from __future__ import annotations

import pytest


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2.0, tid,
              correlation=corr)


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, tid=7, correlation=corr)


def synthetic():
    """A step with a forward (a transformer around an attention) and a
    backward whose launch comes from a second thread; a launch after the
    step; a gpu_user_annotation over the attention's kernel; idle gaps
    at 0-60 (in the transformer), 240-320 (in the backward) and after the
    step."""
    return [
        _x("user_annotation", "bench.window", 0.0, 1000.0),
        _x("user_annotation", "md.train.step", 10.0, 490.0),
        _x("user_annotation", "md.train.forward", 20.0, 180.0),
        _x("user_annotation", "md.transformer", 25.0, 125.0),
        _x("user_annotation", "md.attn", 40.0, 40.0),
        _x("user_annotation", "bench.attn", 41.0, 30.0),
        _x("user_annotation", "md.train.backward", 210.0, 270.0),
        _x("cpu_op", "aten::mm", 45.0, 20.0),
        _launch(50.0, 1), _kernel(60.0, 100.0, 1),
        _x("gpu_user_annotation", "md.attn", 60.0, 100.0, tid=7),
        _launch(100.0, 2), _kernel(160.0, 50.0, 2),
        _launch(170.0, 3), _kernel(210.0, 30.0, 3),
        _launch(300.0, 4, tid=2), _kernel(320.0, 200.0, 4),
        _launch(600.0, 5), _kernel(610.0, 10.0, 5),
    ]


def test_device_time_goes_to_the_innermost_span():
    from benchmark.harness import spans

    att = spans.attribute(synthetic())
    p = att["paths"]
    fwd = "md.train.step/md.train.forward"
    assert p[fwd + "/md.transformer/md.attn"] == {
        "calls": 1, "device_s": pytest.approx(100e-6),
        "self_s": pytest.approx(100e-6)}
    assert p[fwd + "/md.transformer"]["self_s"] == pytest.approx(50e-6)
    assert p[fwd + "/md.transformer"]["device_s"] == pytest.approx(150e-6)
    assert p[fwd]["self_s"] == pytest.approx(30e-6)
    assert p[fwd]["device_s"] == pytest.approx(180e-6)
    # the second thread's launch falls in the main thread's backward
    assert p["md.train.step/md.train.backward"]["self_s"] == \
        pytest.approx(200e-6)
    assert p["md.train.step"] == {"calls": 1,
                                  "device_s": pytest.approx(380e-6),
                                  "self_s": pytest.approx(0.0)}
    assert att["outside_s"] == pytest.approx(10e-6)
    assert att["device_s"] == pytest.approx(390e-6)
    s = att["spans"]
    assert s["md.transformer"]["self_s"] == pytest.approx(50e-6)
    assert s["md.transformer"]["host_s"] == pytest.approx(125e-6)
    assert set(s) == {"md.train.step", "md.train.forward", "md.transformer",
                      "md.attn", "md.train.backward"}
    assert spans.device_s(att, "md.attn", inside="md.train.forward") == \
        pytest.approx(100e-6)
    assert spans.device_s(att, "md.attn", inside="md.train.backward") == 0
    assert spans.device_s(att, "md.transformer", own=True) == \
        pytest.approx(50e-6)


def test_idle_gaps_take_the_innermost_span_or_outside():
    from benchmark.harness import spans

    gaps = dict(spans.attribute(synthetic())["idle_gaps"])
    assert gaps == {"md.transformer": pytest.approx(60e-6),
                    "md.train.backward": pytest.approx(80e-6),
                    spans.OUTSIDE: pytest.approx(470e-6)}


def test_a_trace_without_spans_puts_everything_outside():
    from benchmark.harness import spans

    events = [e for e in synthetic()
              if not e["name"].startswith("md.")]
    att = spans.attribute(events)
    assert att["paths"] == {} and att["spans"] == {}
    assert att["outside_s"] == pytest.approx(att["device_s"])
    assert [k for k, _ in att["idle_gaps"]] == [spans.OUTSIDE]


@pytest.mark.parametrize("unit", [None, "md.transformer"])
def test_spans_report_reads_a_trace_file(tmp_path, unit):
    """The report of the synthetic trace's file, a step at a time by
    default (one step there), or a unit the caller names."""
    import json

    from benchmark import spans_report

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": synthetic()}))
    argv = [str(path)] + ([] if unit is None else ["--unit", unit])
    out = spans_report.main(argv)
    assert out["unit"] == (unit or "md.train.step") and out["units"] == 1
    s = out["spans"]
    assert s["md.train.step"]["device_ms"] == pytest.approx(0.38)
    assert s["md.transformer"] == {
        "calls": 1, "device_ms": pytest.approx(0.15),
        "self_ms": pytest.approx(0.05), "host_ms": pytest.approx(0.125)}
    assert out["device_ms"] == pytest.approx(0.39)
    assert out["outside_ms"] == pytest.approx(0.01)
    assert dict(out["idle_gaps_ms"])["md.train.backward"] == \
        pytest.approx(0.08)
