"""The port's own spans (``utils/profiling.annotate``) and the benchmark's
readers of them, on the CPU.

* Outside a profiler ``annotate`` returns one shared null context (under
  one, a span: ``test_torch_port_convert.py``).
* ``Model.sample`` and ``Model.transfer_sample`` at the tiny preset under a
  CPU profiler, on the kernel path and on the plain flow: each ``model/...``
  span appears as often as the call does that work (``model/chain`` once a
  launch of at most ``MAX_BATCH`` rows on the kernel path, once a chain on
  the plain flow; ``model/decode`` once a chunk of the decoder's frames)
  and lies inside the call's root span.
* ``Stage1Step``: ``stage1/step`` encloses the seven phase spans, and each
  discriminator's parts lie inside their phase; ``data/augment`` wraps the
  train transform.
* ``portbench/program_spans.py`` and the eleven readers of the program's
  spans against hand-built Chrome traces, and None without a trace or
  without the program's spans (the benchmark runs them on a program that
  has none).
"""

import contextlib
import json
import math
from pathlib import Path

import pytest
import torch

from image2video_synthesis_using_cinns_tpu_torch import testing
from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment, draw_augment
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda.flow_kernel import MAX_BATCH
from image2video_synthesis_using_cinns_tpu_torch.train import stage1
from image2video_synthesis_using_cinns_tpu_torch.train.stage1_step import (
    Stage1Step, StepDraws, make_optimizers)
from image2video_synthesis_using_cinns_tpu_torch.utils import profiling
from portbench import count, harness, program_spans, tracing
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ROWS = MAX_BATCH + 1  # two kernel launches a reverse chain
VID = 12
AUG = {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.0, "prob_hflip": 0.5}


def traced(path: Path, fn) -> tracing.Trace:
    """``fn()`` under a CPU profiler, read back as the benchmark reads it."""
    with tracing.profiled(path, torch.device("cpu")):
        fn()
    return tracing.Trace(path)


def inside(iv, outer) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def test_annotate_is_one_null_context_outside_a_profiler(tmp_path):
    off = profiling.annotate("port/phase")
    assert isinstance(off, contextlib.nullcontext) and off is profiling.annotate("other")
    spans = []
    tr = traced(tmp_path / "t.json", lambda: spans.append(profiling.annotate("port/phase")))
    assert spans[0] is not off and "port/phase" not in tr.spans  # made, never entered
    assert profiling.annotate("port/phase") is off


@pytest.fixture(scope="module")
def models():
    return {k: testing.build_model("tiny", vid_length=VID, transfer=True, use_kernel=k,
                                   device="cpu") for k in (True, False)}


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("call", ["sample", "transfer"])
def test_serving_spans_nest_in_their_root(models, call, use_kernel, tmp_path):
    m = models[use_kernel]
    gen = torch.Generator().manual_seed(0)
    x0 = torch.rand(ROWS, 3, 32, 32, generator=gen) * 2 - 1
    query = torch.rand(1, 9, 3, 32, 32, generator=gen) * 2 - 1
    run = (lambda: m.sample(x0)) if call == "sample" else (lambda: m.transfer_sample(query, x0))
    tr = traced(tmp_path / "t.json", run)
    launches = -(-ROWS // MAX_BATCH) if use_kernel else 1
    root = f"model/{call}"
    want = {root: 1, "model/embed": 1, "model/chain": launches,
            "model/decode": math.ceil(VID / m.decoder.base_frames)}
    if call == "transfer":  # the query's encode, embed and forward chain
        want.update({"model/encode": 1, "model/embed": 2, "model/chain": launches + 1})
    got = {name: len(ivs) for name, ivs in tr.spans.items() if name.startswith("model/")}
    assert got == want
    for name, ivs in tr.spans.items():
        if name.startswith("model/") and name != root:
            assert all(inside(iv, tr.spans[root]) for iv in ivs), name


def test_stage1_step_spans_nest(tmp_path):
    opt = testing.stage1_config(testing.PRESETS["tiny"])
    models = stage1.build_models(opt, weights_root=str(tmp_path / "none"))
    step = Stage1Step(models, make_optimizers(models, 1e-4, 0.0), opt.Training)
    b, t, img = 2, opt.Data["sequence_length"], opt.Data["img_size"]
    gen = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 255, (b, t, img, img, 3), dtype=torch.uint8, generator=gen)
    aug = build_augment(img, AUG, False, True)
    draws = StepDraws(torch.randn(b, opt.Decoder["z_dim"], generator=gen), 0,
                      torch.randint(0, b * (t - 1), (20,), generator=gen))

    def run():
        step(aug(raw, draws=draw_augment(b, AUG, False, gen)), int(opt.Training["pretrain"]),
             draws)

    sp = traced(tmp_path / "t.json", run).spans
    phases = ("vae_forward", "disc_t", "disc_s", "spectral", "vae_loss", "vae_backward",
              "optimizer")
    assert len(sp["stage1/step"]) == 1 and len(sp["data/augment"]) == 1
    assert not inside(sp["data/augment"][0], sp["stage1/step"])
    for p in phases:
        assert len(sp[f"stage1/{p}"]) == (2 if p == "spectral" else 1), p
        assert all(inside(iv, sp["stage1/step"]) for iv in sp[f"stage1/{p}"]), p
    parts = {"disc_t": ("forward", "penalty", "backward", "adam"),
             "disc_s": ("forward", "backward", "adam")}
    for disc, names in parts.items():
        for part in names:
            ivs = sp[f"stage1/{disc}/{part}"]
            assert len(ivs) == 1 and inside(ivs[0], sp[f"stage1/{disc}"]), (disc, part)


# -- the readers, against hand-built traces ----------------------------------------

def _span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _op(corr, a, b, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": a, "dur": b - a,
            "args": {"correlation": corr}}


def serving_events(program: bool = True) -> list[dict]:
    """Two calls of 500 us in a 1000 us window. In each (times from the
    call's start): the encode [12, 18] launches [20, 30]; the embed
    [20, 100] launches [40, 90]; two chains [100, 120], [120, 140] launch
    [110, 130], [130, 150]; two decodes [150, 300], [300, 450] launch
    [170, 270], a memcpy [270, 280] and [320, 440]; the caller launches
    [485, 488] after the root [10, 480]. ``program=False``: the same
    without the program's spans."""
    ev = [_span("bench/window", 0, 1000)]
    for k, t in enumerate((0, 500)):
        c = 10 * k
        ev += [_span("bench/call", t, t + 490), _span("bench/decoder", t + 155, t + 295)]
        if program:
            ev += [_span("model/sample", t + 10, t + 480), _span("model/encode", t + 12, t + 18),
                   _span("model/embed", t + 20, t + 100), _span("model/chain", t + 100, t + 120),
                   _span("model/chain", t + 120, t + 140),
                   _span("model/decode", t + 150, t + 300), _span("model/decode", t + 300, t + 450)]
        for corr, at, a, b, cat in ((1, 14, 20, 30, "kernel"), (2, 30, 40, 90, "kernel"),
                                    (3, 105, 110, 130, "kernel"), (4, 125, 130, 150, "kernel"),
                                    (5, 160, 170, 270, "kernel"), (6, 200, 270, 280, "gpu_memcpy"),
                                    (7, 310, 320, 440, "kernel"), (8, 482, 485, 488, "kernel")):
            ev += [_launch(c + corr, t + at), _op(c + corr, t + a, t + b, cat)]
    return ev


def training_events(program: bool = True) -> list[dict]:
    """One step in a 100 us window: the augment [5, 15] launches [10, 14],
    the step [20, 80] launches [30, 60] and [75, 85]."""
    ev = [_span("bench/window", 0, 100), _span("bench/call", 0, 90),
          _span("bench/augment", 4, 16)]
    if program:
        ev += [_span("data/augment", 5, 15), _span("stage1/step", 20, 80)]
    for corr, at, a, b in ((1, 6, 10, 14), (2, 25, 30, 60), (3, 70, 75, 85)):
        ev += [_launch(corr, at), _op(corr, a, b)]
    return ev


DECODER = {"flops": 4.0e9, "bytes": 2.0e6, "precision": "bfloat16"}
SERVING = {  # metric: value from serving_events, per call
    "embedder_ms.program": 0.05,
    "encoder_ms.program": 0.01,
    "decoder_roofline.program": 100.0 * count.roofline_s(*DECODER.values()) / 230e-6,
    "decode_host_ms": 0.3,
    "decode_launches": 3.0,
    "embed_host_ms": 0.08,
    "chain_launches": 2.0,
    # idle stretches that start in a program span: 10 after the encode's
    # op, 20 after the embed's, 20 after the chains', 40 between the
    # decodes' ops, 45 after the last decode; not [0, 20], [488, 520] or
    # [988, 1000], which start in the caller
    "program_idle_ms.serve": 0.135,
}
TRAINING = {
    "augment_ms.program": 0.004,
    "step_host_ms": 0.06,
    "program_idle_ms.train": 0.031,  # [14, 30] after the augment's op and [60, 75]
}


def context(tmp_path, events, calls, counts=None) -> harness.Context:
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return harness.Context(tracing.Trace(path), calls, [], counts or {}, 0)


@pytest.mark.parametrize("metric", sorted(SERVING) + sorted(TRAINING))
def test_reader_on_a_hand_built_trace(metric, tmp_path):
    if metric in SERVING:
        ctx = context(tmp_path, serving_events(), 2, {"decoder": DECODER})
        want = SERVING[metric]
    else:
        ctx = context(tmp_path, training_events(), 1)
        want = TRAINING[metric]
    assert harness.reader_of(ROOT, metric).read(ctx) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(SERVING) + sorted(TRAINING))
def test_reader_reads_nothing_without_the_program_spans(metric, tmp_path):
    reader = harness.reader_of(ROOT, metric)
    assert reader.read(harness.Context(None, 2, [], {"decoder": DECODER}, 0)) is None
    events = serving_events(False) if metric in SERVING else training_events(False)
    assert reader.read(context(tmp_path, events, 2, {"decoder": DECODER})) is None


def test_program_span_helpers(tmp_path):
    tr = context(tmp_path, serving_events(), 2).trace
    assert program_spans.merged([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    assert program_spans.host_s(tr, "model/chain") == pytest.approx(80e-6)
    assert program_spans.host_s(tr, "model/decode", "model/sample") == pytest.approx(940e-6)
    assert program_spans.host_s(tr, "model/none") is None
    ops = program_spans.launched(tr, "model/decode")
    assert sorted(e["args"]["correlation"] for e in ops) == [5, 6, 7, 15, 16, 17]
    assert program_spans.launched(tr, "model/none") is None
    gaps = program_spans.idle_stretches(tr)
    assert gaps[0] == (0, 20) and gaps[-1] == (988, 1000) and len(gaps) == 13
    assert sum(b - a for a, b in gaps) / 1e6 == pytest.approx(tr.window_s - tr.busy_s())
    assert program_spans.program_idle_s(tr) == pytest.approx(270e-6)
    # the benchmark's spans alone are the caller's
    assert program_spans.program_idle_s(context(tmp_path, serving_events(False), 2).trace) is None
