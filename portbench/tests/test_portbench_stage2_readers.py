"""The readers of the stage-2 step's spans (``posterior_ms``,
``stage2_embed_ms``, ``flow_train_ms``, ``flow_train_host_ms``,
``flow_train_launches``, ``stage2_optimizer_ms``) against a hand-built
Chrome trace, None without a trace or without the spans; and the port's
``train_step`` opens each of those spans once a step."""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, tracing
from portbench.runners import stage2_train
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SPANS = ("stage2/posterior", "stage2/embedder", "stage2/flow", "stage2/optimizer")


def _span(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _op(corr, a, b):
    return {"ph": "X", "cat": "kernel", "name": f"op{corr}", "ts": a, "dur": b - a,
            "args": {"correlation": corr}}


def stage2_events(program: bool = True) -> list[dict]:
    """Two steps of 100 us in a 200 us window. In each (times from the step's
    start): the posterior [0, 10] launches [5, 25]; the embedder [10, 20]
    launches [25, 30]; the flow [20, 80] launches [30, 34] and [34, 40] from
    the calling thread and [60, 70] from autograd's (thread 2, launched at
    50); the optimizer [80, 90] launches [85, 95]."""
    ev = [_span("bench/window", 0, 200)]
    for k, t in enumerate((0, 100)):
        c = 10 * k
        if program:
            ev += [_span("stage2/posterior", t, t + 10), _span("stage2/embedder", t + 10, t + 20),
                   _span("stage2/flow", t + 20, t + 80), _span("stage2/optimizer", t + 80, t + 90)]
        for corr, at, a, b, tid in ((1, 2, 5, 25, 1), (2, 12, 25, 30, 1), (3, 22, 30, 34, 1),
                                    (4, 24, 34, 40, 1), (5, 50, 60, 70, 2), (6, 82, 85, 95, 1)):
            ev += [_launch(c + corr, t + at, tid), _op(c + corr, t + a, t + b)]
    return ev


WANT = {"posterior_ms": 0.02, "stage2_embed_ms": 0.005, "flow_train_ms": 0.02,
        "flow_train_host_ms": 0.06, "flow_train_launches": 3.0, "stage2_optimizer_ms": 0.01}


def context(tmp_path, events) -> harness.Context:
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return harness.Context(tracing.Trace(path), 2, [], {}, 0)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_hand_built_trace(metric, tmp_path):
    got = harness.reader_of(ROOT, metric).read(context(tmp_path, stage2_events()))
    assert got == pytest.approx(WANT[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_nothing_without_the_spans(metric, tmp_path):
    reader = harness.reader_of(ROOT, metric)
    assert reader.read(harness.Context(None, 2, [], {}, 0)) is None
    assert reader.read(context(tmp_path, stage2_events(program=False))) is None


def test_each_step_opens_the_spans_the_readers_read(tmp_path, two_threads):
    cfg = tiny.tiny_config()
    traffic = json.loads((ROOT / "portbench" / "traffic" / "stage2-train-b50.json").read_text())
    traffic.update(tiny.TRAFFIC["tiny-stage2"], checked_steps=1)
    drv = stage2_train.Runner(cfg, traffic, 5, torch.device("cpu"))
    drv.setup(lambda name: None)
    path = tmp_path / "t.json"
    with tracing.profiled(path, torch.device("cpu")):
        for i in range(2):
            drv.call(i)
        drv.fetch()
    spans = tracing.Trace(path).spans
    assert {s: len(spans.get(s, [])) for s in SPANS} == {s: 2 for s in SPANS}
