"""The port's observability rest (``repro_torch.obs.summarize``, the
``profile=`` mode and ``export_chrome`` of ``repro_torch.obs.trace``)
against the reference's ``repro.obs``.

* ``load_events``, ``summarize``, ``format_table`` and ``main`` (with
  ``--require`` met and missed) on the same trace files give the
  reference's rows, table and output character for character: a
  hand-written trace (ties, instants, a bare event list) and one the
  port's tracer recorded and exported.
* ``export_chrome`` writes ``chrome_trace()`` and returns the event
  count, as the reference's does.
* ``configure(profile=...)`` and ``configure(trace=...)`` reject an
  unknown mode with the reference's message.
* A ``profile=True`` span under ``profile="on"`` shows in a CPU
  ``torch.profiler`` run as a ``record_function`` event of its name;
  with the mode off, or tracing off, it does not.
"""
import json

import pytest

torch = pytest.importorskip("torch")

HAND = [
    {"name": "cc.frontier.level", "ph": "X", "ts": 0.0, "dur": 120.5},
    {"name": "cc.frontier.level", "ph": "X", "ts": 130.0, "dur": 80.25},
    {"name": "serve.wave", "ph": "X", "ts": 300.0, "dur": 200.75},
    {"name": "serve.quarantine", "ph": "i", "s": "t", "ts": 310.0},
    {"name": "a.tie", "ph": "X", "ts": 400.0, "dur": 200.75},
    {"name": "list_rank.rs3", "ph": "X", "ts": 700.0},
]


def _write(path, payload):
    with open(path, "w") as f:
        json.dump(payload, f)
    return str(path)


def _traces(tmp_path):
    from repro_torch.obs.trace import Tracer

    tr = Tracer(trace="on")
    for i in range(3):
        with tr.span("cc.frontier.level", bucket=4096) as sp:
            sp.tag(rounds=i)
    with tr.span("serve.wave", wave=0):
        tr.event("serve.quarantine", uid=7)
    recorded = tmp_path / "recorded.json"
    assert tr.export_chrome(str(recorded)) == 5
    return {
        "hand": _write(tmp_path / "hand.json", {"traceEvents": HAND}),
        "bare": _write(tmp_path / "bare.json", HAND),
        "recorded": str(recorded),
        "empty": _write(tmp_path / "empty.json", {"traceEvents": []}),
    }


@pytest.mark.parametrize("which", ["hand", "bare", "recorded", "empty"])
def test_summarize_and_format_table_match_the_reference(tmp_path, which):
    from repro.obs import summarize as js
    from repro_torch.obs import summarize as ts

    path = _traces(tmp_path)[which]
    events = ts.load_events(path)
    assert events == js.load_events(path)
    rows = ts.summarize(events)
    assert rows == js.summarize(events)
    assert ts.format_table(rows) == js.format_table(rows)


@pytest.mark.parametrize("require,code", [([], 0), (["cc.frontier"], 0),
                                          (["cc.frontier", "serve.wave"], 0),
                                          (["cc.frontier", "no.such.span"], 1)])
def test_main_with_require_matches_the_reference(tmp_path, capsys, require, code):
    from repro.obs import summarize as js
    from repro_torch.obs import summarize as ts

    path = _traces(tmp_path)["recorded"]
    argv = [path] + [a for r in require for a in ("--require", r)]
    assert ts.main(argv) == code
    got = capsys.readouterr()
    assert js.main(argv) == code
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


def test_load_events_rejects_a_non_trace_as_the_reference(tmp_path):
    from repro.obs import summarize as js
    from repro_torch.obs import summarize as ts

    path = _write(tmp_path / "bad.json", {"events": []})
    with pytest.raises(ValueError) as got:
        ts.load_events(path)
    with pytest.raises(ValueError) as want:
        js.load_events(path)
    assert str(got.value) == str(want.value)


def test_export_chrome_writes_the_chrome_trace(tmp_path):
    from repro_torch.obs import trace

    tr = trace.Tracer(trace="on")
    with tr.span("train.step", step=0):
        pass
    tr.event("serve.quarantine", uid=3)
    path = tmp_path / "t.json"
    assert tr.export_chrome(str(path)) == len(tr.events) == 2
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(tr.chrome_trace(), default=str))
    assert trace.export_chrome is not None and callable(trace.export_chrome)


@pytest.mark.parametrize("knob", ["trace", "profile"])
def test_an_unknown_mode_raises_the_references_message(knob):
    from repro.obs.trace import Tracer as JTracer
    from repro_torch.obs.trace import PROFILE_MODES, TRACE_MODES, Tracer

    from repro.obs.trace import PROFILE_MODES as JP, TRACE_MODES as JT

    assert (TRACE_MODES, PROFILE_MODES) == (JT, JP)
    with pytest.raises(ValueError) as got:
        Tracer().configure(**{knob: "always"})
    with pytest.raises(ValueError) as want:
        JTracer().configure(**{knob: "always"})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("trace_mode,profile_mode,seen", [
    ("on", "on", True), ("on", "off", False), ("off", "on", False)])
def test_a_profile_span_is_a_record_function_event(trace_mode, profile_mode, seen):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import Tracer

    tr = Tracer(trace=trace_mode, profile=profile_mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("cc.frontier.level", profile=True):
            torch.ones(8).sum()
        with tr.span("serve.wave"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert ("cc.frontier.level" in names) == seen
    assert "serve.wave" not in names
    assert len(tr.events) == (2 if trace_mode == "on" else 0)
