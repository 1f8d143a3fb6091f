"""The port's convergence drive (``cli/convergence_drive.py``) and config
emitter (``cli/gen_configs.py``) against the JAX package's scripts, on the CPU.

* ``moving_squares`` and the drive's chunk pool equal the JAX drive's
  bitwise: the pool is read from the JAX drive's own ``device_put`` calls,
  with its model builds stubbed out (nothing is compiled).
* ``steps_to`` and ``compare`` give the JAX drive's results on seeded
  series and on the three recorded ``docs/evidence/convergence_*_r5.json``
  artifacts, unchanged and doctored field by field (the same REGRESSION
  strings).
* The tiny-preset AE override is the JAX drive's config.
* One CLI run of each drive at ``--preset tiny -device cpu`` for 2 x k steps
  (k 2; bs 1, and 4 for stage 2): finite metrics with the recorded
  artifact's keys, the ``--json`` payload's layout, and ``--compare``'s exit
  codes (0 against the run's own artifact, 1 with REGRESSION lines against a
  copy with one field made better beyond its slack, an error against another
  drive's artifact). Without ``-device`` the drive asks for the card.
* ``gen_configs --out`` writes the committed ``configs/`` byte for byte, as
  the JAX script does, and every file loads to equal dicts in both packages.

Slow (``-m slow``), the JAX gates of ``tests/test_convergence.py`` at their
sizes and thresholds, through the port's drives: stage 2 closes >= 55% of its
init-to-reference gap in 300 steps at bs 16; the AE (48 steps, bs 2) stays
finite with the gate open, ``d_weight`` <= 1e4, max |L_disc| < 25 after the
first chunk and recon below 0.9 of its start; stage 1 (48 steps, bs 2, fp32)
stays finite, |Loss_Disc_*| < 25, L1 below 0.9 of its start and PSNR up by
more than 0.5 dB. And the stage-2 drive for 2 x k steps against the JAX
drive, with the JAX initial variables carried across and the JAX drive's
draws injected: each step's loss terms to 1e-4 relative.
"""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import image2video_synthesis_using_cinns_tpu.models.stage2.biggan as jbiggan
from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.cli import convergence_drive as drive
from image2video_synthesis_using_cinns_tpu_torch.cli import gen_configs
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EVIDENCE = ROOT / "docs" / "evidence"
WHICH = ("stage1", "stage2", "ae")
# one field of each artifact made better beyond its slack, so that a run
# equal to the artifact reads as a regression
BETTER = {"stage1": ("l1_last100", lambda v: v / 2), "stage2": ("nll_final", lambda v: v - 20),
          "ae": ("recon_last100", lambda v: v / 2)}


def _script(name: str):
    """A module of ``scripts/`` (imported by path; importing compiles nothing)."""
    spec = importlib.util.spec_from_file_location(f"scripts_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jdrive():
    return _script("convergence_drive")


def _artifact(which: str) -> dict:
    return json.loads((EVIDENCE / f"convergence_{which}_r5.json").read_text())


# -- the drives' data, thresholds and regression diff --------------------------------------

class _Stop(Exception):
    pass


class _JaxProxy:
    """``jax`` for the JAX drive, with its programs stubbed: ``jit`` returns
    empty variables, ``device_put`` records what it is given, and
    ``block_until_ready`` (reached once the chunks are placed) stops the drive."""

    def __init__(self):
        self.put = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        return lambda *a, **k: {"params": {"flow": {}, "embedder": {}}, "buffers": {}}

    def device_put(self, x):
        self.put.append(np.asarray(x))
        return x

    def block_until_ready(self, x):
        raise _Stop


class _BigAEStub:
    configs = []

    def __init__(self, config):
        self.configs.append(dict(config))
        self.init = None


def _jax_drive_setup(jdrive, monkeypatch, which: str, **kw) -> tuple[list, list]:
    """The JAX drive ``which`` run up to its placed chunks: (the arrays it
    placed on the device, the AE configs it built)."""
    proxy = _JaxProxy()
    monkeypatch.setattr(jdrive, "jax", proxy)
    monkeypatch.setattr(jbiggan, "BigAE", _BigAEStub)
    _BigAEStub.configs = []
    fn = jdrive.drive_ae if which == "ae" else jdrive.drive_stage2
    with pytest.raises(_Stop):
        fn("tiny", **kw)
    return proxy.put, _BigAEStub.configs


@pytest.mark.parametrize("which", ["stage2", "ae"])
def test_clips_and_chunk_pool_match_the_jax_drive(jdrive, monkeypatch, which):
    """The chunks (k, bs, T, H, W, 3) the JAX drive places, and the port's."""
    k, bs, pool = 3, 5, 4
    kw = dict(steps=6, bs=bs, k=k, pool=pool)
    put, _ = _jax_drive_setup(jdrive, monkeypatch, which, **(dict(kw, lr=1e-4)
                                                             if which == "stage2" else kw))
    T, img = (1, 64) if which == "ae" else (9, 32)
    clips = drive.moving_squares(drive.N_CLIPS, T, img)
    np.testing.assert_array_equal(clips, jdrive.moving_squares(64, T, img))
    ours = drive.chunk_pool(clips, k, bs, pool, "cpu")
    assert len(ours) == pool and all(c.dtype == torch.uint8 for c in ours)
    for a, b in zip(ours, put[:pool]):
        assert a.shape == b.shape == (k, bs, T, img, img, 3)
        np.testing.assert_array_equal(a.numpy(), b)


def test_ae_override_matches_the_jax_drive(jdrive, monkeypatch):
    _, configs = _jax_drive_setup(jdrive, monkeypatch, "ae", steps=2, bs=2, k=2, pool=1)
    ae_cfg, img = drive.ae_config("tiny")
    assert img == 64 and dict(ae_cfg.AE) == configs[0]
    assert drive.ae_config("bair")[0].AE["in_size"] == 64  # full size: no override


def test_steps_to_matches_the_jax_drive(jdrive):
    rng = np.random.default_rng(0)
    for trial in range(20):
        series = np.cumsum(rng.standard_normal(rng.integers(5, 120))) * 0.1 + 1.0
        thresh = float(rng.uniform(0.5, 1.5))
        for window in (1, 5, 20):
            for below in (True, False):
                assert (drive.steps_to(series, thresh, window, below)
                        == jdrive.steps_to(series, thresh, window, below)), (trial, window, below)


def _doctored(metrics: dict):
    """Copies of ``metrics`` with one field moved each way, and non-finite; a
    steps-to-threshold field also never reached (None)."""
    yield dict(metrics)
    yield dict(metrics, finite=False)
    for key, v in metrics.items():
        if isinstance(v, bool):
            continue
        for moved in (v * 0.5, v * 2.0, v * 4.0, v - 20.0, v + 20.0, v + 0.5):
            yield dict(metrics, **{key: moved})
        if key.startswith("steps_to"):
            yield dict(metrics, **{key: None})


@pytest.mark.parametrize("which", WHICH)
def test_compare_matches_the_jax_drive(jdrive, which):
    """Both diffs give the same strings for every doctored run against the
    recorded artifact, and for the artifact against every doctored record."""
    old = _artifact(which)["metrics"]
    assert drive.compare(which, old, old) == jdrive.compare(which, old, old) == []
    regressions = 0
    for new in _doctored(old):
        for a, b in ((new, old), (old, new)):
            ours = drive.compare(which, a, b)
            assert ours == jdrive.compare(which, a, b), (a, b)
            regressions += bool(ours)
    assert regressions > 5


# -- the CLI ----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One CLI run of each drive at the tiny preset on the CPU: 2 x k steps,
    k 2, small batches."""
    root = tmp_path_factory.mktemp("convergence")
    runs = {}
    for which, bs in (("stage1", 1), ("stage2", 4), ("ae", 1)):
        path = root / f"{which}.json"
        out = drive.main([which, "--preset", "tiny", "--steps", "4", "--k", "2", "--bs", str(bs),
                          "-device", "cpu", "--json", str(path)])
        runs[which] = (out, path)
    return runs


@pytest.mark.parametrize("which", WHICH)
def test_cli_run_writes_the_jax_drives_artifact(cli_runs, which):
    out, path = cli_runs[which]
    payload = json.loads(path.read_text())
    assert payload == json.loads(json.dumps(out["payload"]))
    recorded = _artifact(which)
    assert list(payload) == list(recorded) == ["which", "preset", "steps", "bs", "k", "metrics"]
    assert (payload["which"], payload["preset"], payload["steps"], payload["k"]) == (
        which, "tiny", 4, 2)
    assert list(payload["metrics"]) == list(recorded["metrics"])
    assert payload["metrics"]["finite"] is True
    assert all(np.isfinite(np.asarray(v)).all() for v in out["run"]["hist"].values())
    assert all(len(v) == 4 for v in out["run"]["hist"].values())


@pytest.mark.parametrize("which", WHICH)
def test_cli_compare_exit_codes(cli_runs, which, tmp_path, monkeypatch, capsys):
    """``--compare`` after a drive (the drive replayed from the run above)."""
    out, path = cli_runs[which]
    summary = out["payload"]["metrics"]
    monkeypatch.setattr(drive, "drive", lambda *a, **k: (copy.deepcopy(summary), out["run"]))
    args = [which, "--preset", "tiny", "--steps", "4", "--k", "2", "-device", "cpu"]
    drive.main(args + ["--compare", str(path)])
    assert "PASS: no convergence regression" in capsys.readouterr().out

    key, moved = BETTER[which]
    better = json.loads(path.read_text())
    m = better["metrics"]
    m[key] = moved(m[key])
    doctored = tmp_path / "better.json"
    doctored.write_text(json.dumps(better))
    with pytest.raises(SystemExit) as e:
        drive.main(args + ["--compare", str(doctored)])
    assert e.value.code == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("REGRESSION")]
    assert lines and all(key in ln for ln in lines), lines

    other = next(w for w in WHICH if w != which)
    with pytest.raises(SystemExit, match="artifact is for"):
        drive.main(args + ["--compare", str(EVIDENCE / f"convergence_{other}_r5.json")])


def test_cli_defaults_to_cuda():
    """Without -device the drive asks for the card; this CPU-only build has none."""
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        drive.main(["stage2", "--preset", "tiny", "--steps", "2", "--k", "2"])


# -- the config emitter -------------------------------------------------------------------------

def test_gen_configs_writes_the_committed_configs(tmp_path, monkeypatch):
    """The port's emitter, the JAX script (run in another directory) and the
    committed files: byte for byte; each file loads to equal dicts in both
    packages."""
    written = gen_configs.main(["--out", str(tmp_path / "port")])
    committed = sorted((ROOT / "configs").rglob("*.yaml"))
    assert len(written) == len(committed) == 22
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repository
    _script("gen_configs")
    for path in committed:
        rel = path.relative_to(ROOT)
        ours, theirs = tmp_path / "port" / rel, tmp_path / rel
        assert ours.read_bytes() == theirs.read_bytes() == path.read_bytes(), rel
        assert tcfg.load(str(ours)).to_dict() == jcfg.load(str(path)).to_dict(), rel


# -- slow: the JAX gates through the port's drives -----------------------------------------------

@pytest.mark.slow
def test_stage2_nll_closes_gap_to_reference():
    """tests/test_convergence.py's stage-2 gate: 300 steps at bs 16 on 48
    clips, a fresh chunk every 10 steps, lr 1e-4."""
    run = drive.train_stage2("tiny", steps=300, bs=16, k=10, pool=30, lr=1e-4, device="cpu",
                             n_clips=48)
    losses, refs = np.asarray(run["hist"]["Loss"]), np.asarray(run["hist"]["reference_nll_loss"])
    assert np.isfinite(losses).all(), "NLL diverged to non-finite"
    l0, lf, lref = float(losses[:10].mean()), float(losses[-30:].mean()), float(refs.mean())
    gap_closed = (l0 - lf) / max(l0 - lref, 1e-9)
    assert gap_closed >= 0.55, (gap_closed, l0, lf, lref)


@pytest.mark.slow
def test_stage2_ae_adversarial_trajectory_stability():
    """tests/test_convergence.py's AE gate: 48 steps at bs 2 on 16 frames,
    k 8, no colour augment, the gate open."""
    K = 8
    hist = drive.train_ae("tiny", steps=48, bs=2, k=K, pool=6, device="cpu", n_clips=16,
                          augment={})["hist"]
    for key, v in hist.items():
        assert np.isfinite(np.asarray(v)).all(), f"{key} went non-finite"
    assert (np.asarray(hist["Disc_factor"]) == 1.0).all()
    dw = np.asarray(hist["Disc_weight"])
    assert dw.max() <= 1e4 + 1e-6, dw.max()
    ld = np.asarray(hist["L_disc"])[K:]
    assert np.abs(ld).max() < 25.0, np.abs(ld).max()
    rec = np.asarray(hist["Loss_recon"])
    r0, rf = float(rec[:8].mean()), float(rec[-8:].mean())
    assert rf < 0.9 * r0, (r0, rf)


@pytest.mark.slow
def test_stage1_adversarial_trajectory_stability():
    """tests/test_convergence.py's stage-1 gate: 48 steps at bs 2 on 16
    clips, k 8, fp32, the config's lr, the gates open."""
    hist = drive.train_stage1("tiny", steps=48, bs=2, k=8, pool=6, device="cpu", n_clips=16,
                              compute_dtype="float32")["hist"]
    for key, v in hist.items():
        assert np.isfinite(np.asarray(v)).all(), f"{key} went non-finite"
    for key in ("Loss_Disc_T", "Loss_Disc_S"):
        assert np.abs(np.asarray(hist[key])).max() < 25.0, (key, np.abs(hist[key]).max())
    l1, psnr = np.asarray(hist["Loss_L1"]), np.asarray(hist["PSNR"])
    l1_0, l1_f = float(l1[:8].mean()), float(l1[-8:].mean())
    ps_0, ps_f = float(psnr[:8].mean()), float(psnr[-8:].mean())
    assert l1_f < 0.9 * l1_0, (l1_0, l1_f)
    assert ps_f > ps_0 + 0.5, (ps_0, ps_f)


@pytest.mark.slow
def test_stage2_drive_matches_the_jax_drive(jdrive, monkeypatch):
    """2 x k steps (k 2) of both stage-2 drives at the tiny preset: the JAX
    drive's per-step metrics (read at its ``device_get``) against the port's,
    with the JAX drive's initial variables and draws; loss terms to 1e-4
    relative."""
    import jax.numpy as jnp

    from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
    from image2video_synthesis_using_cinns_tpu.models.stage2.inn import (
        SupervisedTransformer as JST,
    )
    from image2video_synthesis_using_cinns_tpu.testing import (PRESETS, stage1_config,
                                                               stage2_ae_config, stage2_config)
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2 as tstage2
    from image2video_synthesis_using_cinns_tpu_torch.utils import convert
    from test_torch_port_stage1_step import jax_eps
    from test_torch_port_train_augment import jax_draws

    steps, k, bs = 4, 2, 8
    fetched = []

    class Recording:
        def __getattr__(self, name):
            return getattr(jax, name)

        def device_get(self, x):
            fetched.append(jax.device_get(x))
            return fetched[-1]

    monkeypatch.setattr(jdrive, "jax", Recording())
    jdrive.drive_stage2("tiny", steps, bs, k, 4, 1e-4)
    want = {key: np.concatenate([np.asarray(f[key], np.float64) for f in fetched])
            for key in fetched[0]}

    # the JAX drive's initial variables (its inits, repeated)
    p = PRESETS["tiny"]
    img, T, z = p["img_size"], p["seq_length"], p["z_dim"]
    s1, ae = stage1_config(p), stage2_ae_config(p)
    enc_vars = jax.jit(JEncoder.from_config(s1.Encoder).init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, T - 1, img, img, 3)))
    net_vars = jax.jit(JST.from_configs(stage2_config(p, "/tmp/s1", "/tmp/ae"), s1.Decoder,
                                        ae.AE).init)(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, z)), [jnp.zeros((1, img, img, 3))])
    build = drive.stage2_models

    def with_jax_init(preset):
        s2, encoder, network = build(preset)
        encoder.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, enc_vars)))
        network.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, {
            "params": net_vars["params"], "buffers": net_vars["buffers"]})))
        return s2, encoder, network

    class JaxDraws(tstage2.Draws):
        """The JAX drive's keys ``fold_in(PRNGKey(42), step)``: the augment
        from the key, the ActNorm eps from ``rngs={"sample": fold_in(key,
        1)}``, the step's eps and reference noise from ``split(fold_in(key, 2))``."""

        root = jax.random.PRNGKey(42)

        def augment(self, epoch, index, global_step, n, params, random_crop):
            return jax_draws(jax.random.fold_in(self.root, global_step), n, params)

        def normal(self, purpose, epoch, index, global_step, shape):
            key = jax.random.fold_in(self.root, global_step)
            if purpose == "actnorm":
                return torch.tensor(jax_eps(jax.random.fold_in(key, 1), shape))
            k_enc, k_ref = jax.random.split(jax.random.fold_in(key, 2))
            k_ = k_ref if purpose == "reference" else k_enc
            return torch.from_numpy(np.array(jax.random.normal(k_, shape)))

    monkeypatch.setattr(drive, "stage2_models", with_jax_init)
    got = drive.train_stage2("tiny", steps, bs, k, 4, 1e-4, device="cpu", draws=JaxDraws())["hist"]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


@pytest.mark.slow
def test_patch_disc_first_step_spike_follows_its_spectral_vectors(monkeypatch, capsys):
    """The cause of stage 1's first-step ``Loss_Disc_S`` (F13): the
    discriminator's ActNorm init runs on W / sigma with sigma from its random
    initial spectral vectors, as in the JAX drive, so the first step's logits
    scale with 1 / (u^T W v) of that draw. Over 8 seeds of the networks (the
    tiny preset, fp32, 3 steps at bs 2) the first step's loss spreads over
    more than a decade; with the vectors converged (50 power iterations)
    before the init, it stays below 5 for every seed."""
    from image2video_synthesis_using_cinns_tpu_torch.models import layers
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1

    build, init = stage1.build_models, layers.init_actnorm

    def converged_init(module, *inputs):
        for _ in range(50):
            layers.power_iteration_(module)
        init(module, *inputs)

    first = {}
    for converged in (False, True):
        monkeypatch.setattr(layers, "init_actnorm", converged_init if converged else init)
        for seed in range(8):
            monkeypatch.setattr(stage1, "build_models", lambda opt, s=seed: build(opt, seed=s))
            hist = drive.train_stage1("tiny", steps=3, bs=2, k=3, pool=1, device="cpu",
                                      compute_dtype="float32")["hist"]
            first.setdefault(converged, []).append(hist["Loss_Disc_S"][0])
    with capsys.disabled():
        print(f"\nLoss_Disc_S at step 0 over seeds 0-7: random vectors {first[False]}, "
              f"converged {first[True]}")
    assert max(first[False]) > 10 * min(first[False]), first[False]
    assert max(first[True]) < 5.0, first[True]
