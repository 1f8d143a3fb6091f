"""Whole runs of the four runners at the tiny preset on the CPU, past the
harness's look for a card: a sound run is correct, and a run with the timed
path broken underneath is not, once for each fault a cell can have. A cell
added by new files and entries alone runs without an edit to any file."""

import json
import shutil
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CPU = torch.device("cpu")
# the tiny cells' limits, between their sound readings (sample z 5e-4, video
# 1.1e-2; transfer z 2e-7; training loss 0, gradient 2e-6, change 6e-2;
# stage 2 loss 0, gradient 0, change 3.4e-7) and their fp8/TF32 controls'
# (6e-3, 0.12; 1.5e-3, 0.11; 5e-3, 0.2, 0.17; 1.5e-3, 2.2e-3, 4.7e-3)
LIMITS = {"sample": {"z_gap": 2e-3, "video_gap": 4e-2},
          "transfer": {"z_gap": 5e-4, "video_gap": 4e-2},
          "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.12},
          "stage2": {"loss_gap": 2e-4, "grad_gap": 2e-4, "change_gap": 1e-3}}
CELLS = ["tiny-sample", "tiny-transfer", "tiny-train", "tiny-stage2"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("bench"), LIMITS)


def run(root, workload, trace=False, seed=2 ** 31 + 7):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(root, workload, seed, 0.5, trace, CPU, time.perf_counter(),
                                root / "out")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(root, workload):
    out = run(root, workload)
    assert out.correct, out.checks
    assert set(out.metrics) >= {"setup_s"} and out.attempted >= 1
    assert all(v["value"] > 0 for v in out.metrics.values())


def _half_sample(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

    sample = Model.sample

    def half(self, x0, cond=None, residual=None):
        h = x0.shape[0] // 2
        video, z = sample(self, x0[:h], cond, residual[:h])
        pad = x0.shape[0] - h
        return torch.cat([video, video[:1].expand(pad, *video.shape[1:])]), \
            torch.cat([z, z[:1].expand(pad, -1)])

    monkeypatch.setattr(Model, "sample", half)


def _half_transfer(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

    transfer = Model.transfer_sample

    def half(self, query, x0):
        h = x0.shape[0] // 2
        video, z = transfer(self, query, x0[:h])
        pad = x0.shape[0] - h
        return torch.cat([video, video[:1].expand(pad, *video.shape[1:])]), \
            torch.cat([z, z[:1].expand(pad, -1)])

    monkeypatch.setattr(Model, "transfer_sample", half)


def _altered_chain(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel

    reverse = flow_kernel.flow_reverse_fused

    def altered(p, x, emb):
        out = reverse(p, x, emb).clone()
        out[0] *= 1.1
        return out

    monkeypatch.setattr(flow_kernel, "flow_reverse_fused", altered)


def _unchanged_state(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.train.optim import Adam

    def no_step(self, closure=None):
        self.count += 1

    monkeypatch.setattr(Adam, "step", no_step)


def _half_batch(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step

    call = stage1_step.Stage1Step.__call__

    def half(self, seq, epoch, draws):
        h = seq.shape[0] // 2
        frames = seq.shape[1] - 1
        return call(self, seq[:h], epoch, stage1_step.StepDraws(
            draws.eps[:h], draws.start, draws.patches % (h * frames)))

    monkeypatch.setattr(stage1_step.Stage1Step, "__call__", half)


def _altered_loss(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step

    hinge = stage1_step.hinge_loss
    monkeypatch.setattr(stage1_step, "hinge_loss", lambda *a: 1.1 * hinge(*a))


def _half_stage2(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2

    step = stage2.train_step

    def half(network, optimizer, encoder, seq, cond, eps, ref):
        h = seq.shape[0] // 2
        return step(network, optimizer, encoder, seq[:h], [c[:h] for c in cond], eps[:h],
                    ref[:h])

    monkeypatch.setattr(stage2, "train_step", half)


def _altered_flow_loss(monkeypatch):
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2

    flow_loss = stage2.flow_loss

    def altered(gauss, logdet, **kw):
        loss, aux = flow_loss(gauss, logdet, **kw)
        return 1.1 * loss, {k: 1.1 * v for k, v in aux.items()}

    monkeypatch.setattr(stage2, "flow_loss", altered)


@pytest.mark.parametrize("workload,fault", [
    ("tiny-sample", _half_sample), ("tiny-sample", _altered_chain),
    ("tiny-transfer", _half_transfer), ("tiny-transfer", _altered_chain),
    ("tiny-train", _unchanged_state), ("tiny-train", _half_batch),
    ("tiny-train", _altered_loss), ("tiny-stage2", _unchanged_state),
    ("tiny-stage2", _half_stage2), ("tiny-stage2", _altered_flow_loss),
], ids=["sample-half", "sample-altered", "transfer-half", "transfer-altered",
        "train-unchanged", "train-half", "train-altered", "stage2-unchanged", "stage2-half",
        "stage2-altered"])
def test_a_broken_timed_path_is_not_correct(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(root, workload)
    assert not out.correct, out.checks


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_its_metrics(root, workload):
    out = run(root, workload, trace=True)
    assert out.correct, out.checks
    if workload not in ("tiny-train", "tiny-stage2"):
        assert out.metrics["host_ms_per_call"]["value"] > 0  # the one not from the device


def test_a_new_cell_needs_new_files_only(tmp_path):
    """One configuration file, one traffic file, one metric file and new
    entries in BENCHMARK.json; no file that was there is edited."""
    root = tiny.write_root(tmp_path, LIMITS)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    cfg = tiny.tiny_config(Flow={"n_flows": 2, "flow_hidden_depth": 2,
                                 "flow_mid_channels_factor": 2})
    (root / "portbench" / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "portbench" / "traffic" / "tiny-sample.json").read_text())
    traffic.update(batch=2)
    (root / "portbench" / "traffic" / "tiny2-sample-b2.json").write_text(json.dumps(traffic))
    (root / "portbench" / "metrics" / "chain_kernels_per_call.py").write_text(
        "def read(ctx):\n    return float(ctx.calls) if ctx.calls else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "tests",
                             "file": "portbench/configs/tiny2.json", "reduced": [],
                             "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "tiny2-sample-b2", "config": "tiny2",
                               "traffic": "tiny2-sample-b2", "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "tiny-sample" in m.get("workloads", []):
            m["workloads"].append("tiny2-sample-b2")
    bench["per_layer"].append({"name": "chain_kernels_per_call", "unit": "1", "better": "lower",
                               "source": "device_trace", "layer": "flow chain",
                               "moves": "frames_per_s", "workloads": ["tiny2-sample-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run(root, "tiny2-sample-b2")
    assert out.correct and set(out.metrics) == {"setup_s", "frames_per_s", "call_ms_p95"}
    traced = run(root, "tiny2-sample-b2", trace=True)
    assert traced.metrics["chain_kernels_per_call"]["value"] == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())
    shutil.rmtree(root / "out", ignore_errors=True)
