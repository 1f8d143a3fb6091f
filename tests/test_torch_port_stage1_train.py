"""The port's stage-1 trainer end to end on the CPU (``train.stage1.main`` and
``cli/train_stage1.py -device cpu``), at the tiny preset on synthetic BAIR
train and eval splits of 2 clips (one step and one eval batch an epoch at bs
2), beside the JAX trainer.

* From the same initial variables in both trainers (in the place of the
  JAX trainer's ``build_stage1``: ``test_torch_port_stage1_step``'s numpy
  draws, LPIPS included, the spectral vectors each kernel's top singular
  pair, as a trained checkpoint holds them: random ones give sigma near 0
  and amplify rounding by its inverse) and with the JAX trainer's draws
  injected
  (``JaxDraws``: the augment, the step's eps, subsample start and patch
  frames, the validation's eps), the port's ``main`` gives the JAX
  ``main``'s CSV rows for epoch 0 (the discriminators gated, the ActNorm
  init) and ``latest_checkpoint_*`` of the same layout, collection for
  collection (``DISC_s`` keeps ``actnorm_stats`` at its init values), with
  the same counts and learning rates and weights within a few Adam steps.
* Checkpoints pass both ways: the port restores the JAX trainer's
  ``latest_checkpoint_*`` exactly and trains the open epoch 1 from them; the
  JAX trainer's resume path (its reader, its networks' trees, ``restore_into``
  for the optimizer states, its schedulers) takes the port's, value for
  value. (The open epoch's step is held against the JAX step in
  ``test_torch_port_stage1_step*.py``.)
* A port ``GEN`` checkpoint loads into JAX's ``Generator``, the port's
  serving decoder (spectral norm folded) and its trainable decoder, which
  decode alike; the run directory serves as the stage-1 model of the port's
  ``Model``.
* The CLI trains on the CPU; without I3D weights it warns once and the best
  checkpoint follows the eval L1; ``Training.distributed: true`` outside
  torchrun raises; the entry points default to ``cuda``.

The runs take a tenth of the config's lr. The CSV rows of the gated epoch 0
agree to ``CSV_TOL`` of each value (of 1 for the logits and losses that pass
near 0; measured 1.6e-5).
"""

import csv
import functools
import math
import os
import shutil
import warnings

import flax
import jax
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.models.stage1.decoder import Generator as JGenerator
from image2video_synthesis_using_cinns_tpu.testing import (
    PRESETS,
    make_bair_data_dir,
    stage1_config,
    stage2_ae_config,
    stage2_config,
)
from image2video_synthesis_using_cinns_tpu.parallel.mesh import make_mesh
from image2video_synthesis_using_cinns_tpu.train import stage1 as jstage1
from image2video_synthesis_using_cinns_tpu.train.optim import LRController, adam_torch
from image2video_synthesis_using_cinns_tpu.utils import checkpoint as jckpt
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.cli import train_stage1 as tcli
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.decoder import Generator
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step as tstep
from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as tckpt
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_stage1_step import jax_eps, stage1_variables, two_threads  # noqa: F401
from test_torch_port_train_augment import jax_draws
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

P = PRESETS["tiny"]
LR = 2e-5  # a tenth of the config's: see the module docstring
CSV_TOL = 1e-4
NETWORKS = ("GEN", "ENC", "DISC_t", "DISC_s")


class JaxDraws(ts1.Draws):
    """The JAX trainer's draws: step keys ``fold_in(PRNGKey(42), step)`` (the
    augment from the key, the step's eps, subsample start and patch frames
    from ``split(fold_in(key, 1), 3)``), validation keys ``fold_in(root,
    20_000_000 + epoch * 10_000 + i)``, the posterior FVD's ``PRNGKey(1)``."""

    root = jax.random.PRNGKey(42)

    def augment(self, epoch, index, global_step, n, params, random_crop):
        return jax_draws(jax.random.fold_in(self.root, global_step), n, params)

    def step(self, epoch, index, global_step, n, z_dim, n_frames, sub_len):
        key = jax.random.fold_in(jax.random.fold_in(self.root, global_step), 1)
        k_sample, k_sub, k_patch = jax.random.split(key, 3)
        start = (int(jax.random.randint(k_sub, (), 0, n_frames - sub_len + 1))
                 if n_frames >= 16 else 0)
        patches = np.asarray(jax.random.randint(k_patch, (tstep.N_PATCH,), 0, n * n_frames))
        return tstep.StepDraws(torch.from_numpy(jax_eps(k_sample, (n, z_dim))), start,
                               torch.from_numpy(patches.astype(np.int64)))

    def normal(self, purpose, epoch, index, global_step, shape):
        assert purpose == "eval_posterior"
        key = jax.random.fold_in(self.root, 20_000_000 + epoch * 10_000 + index)
        return torch.from_numpy(jax_eps(key, shape))

    def fvd_posterior(self, shape):
        return torch.from_numpy(jax_eps(jax.random.PRNGKey(1), shape))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1_train")
    data = make_bair_data_dir(str(root / "data") + "/", n_videos=2, img=P["img_size"],
                              modes=("train", "eval"))
    return data, root


def _opt(pkg, world, out: str, n_epochs: int, reload: str | None = None, bs: int = 2):
    data, root = world
    opt = pkg.Config(stage1_config(P).to_dict())
    opt.Data["data_path"] = data
    for k, v in dict(bs=bs, bs_eval=bs, workers=2, n_epochs=n_epochs, lr=LR,
                     save_path=str(root / out)).items():
        opt.Training[k] = v
    if reload:
        opt.Training["reload_path"] = reload
    return opt


@functools.lru_cache(maxsize=1)
def _jax_init():
    """The JAX trainer's networks and initial variables for every run here
    (``build_stage1``'s place): drawn with numpy, no XLA compile."""
    bundle, variables = stage1_variables(stage1_config(P))
    return (bundle, *[variables[name] for name in NETWORKS])


def _jax_build(opt, key):
    assert int(jax.random.key_data(key)[-1]) == 42
    return _jax_init()


def _with_jax_init(opt, *args, **kwargs):
    """The port's modules from the JAX trainer's initial variables."""
    models = BUILD(opt)
    bundle, *trees = _jax_init()
    for module, tree in zip((models.decoder, models.encoder, models.disc_t, models.disc_s), trees):
        ts1.load_variables(module, tree)
    models.lpips.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray,
                                                                    bundle.lpips_vars)))
    return models


BUILD = ts1.build_models


def _jax_main(opt):
    """The JAX trainer on one CPU device (the suite's eight virtual ones run
    a single thread each)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstage1, "build_stage1", _jax_build)
        mp.setattr(jstage1, "make_mesh", lambda: make_mesh(1))
        return jstage1.main(opt, eval_fvd=False)


def _port_main(opt):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts1, "build_models", _with_jax_init)
        return ts1.main(opt, eval_fvd=False, device="cpu", draws=JaxDraws())


@pytest.fixture(scope="module")
def runs(world):
    """The gated epoch 0 in each package, then the port's open epoch 1
    resumed from the JAX trainer's checkpoints."""
    port_a = _port_main(_opt(tcfg, world, "port_a", 1))["save_path"]
    jax_a = _jax_main(_opt(jcfg, world, "jax_a", 1))["save_path"]
    port_b = _port_main(_opt(tcfg, world, "port_b", 2, reload=jax_a))
    yield {"port_a": port_a, "jax_a": jax_a, "port_b": port_b}
    for run in (port_a, jax_a, port_b["save_path"]):  # about 0.5 GB of checkpoints each
        shutil.rmtree(run, ignore_errors=True)


def _csv(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        rows = list(csv.reader(f))
    return [dict(zip(rows[0], map(float, r))) for r in rows[1:]]


def _same_rows(got_dir, want_dir, epochs):
    for name, keys in (("log_per_epoch_train.csv", ts1.TRAIN_KEYS),
                       ("log_per_epoch_eval.csv", ts1.TEST_KEYS[:-1])):
        got, want = _csv(got_dir, name), _csv(want_dir, name)
        assert [r["Epoch"] for r in got] == [r["Epoch"] for r in want] == epochs, name
        for g, w in zip(got, want):
            assert g["LR"] == pytest.approx(w["LR"], rel=1e-7)
            if "PFVD" in w:
                assert math.isnan(g["PFVD"]) and math.isnan(w["PFVD"])
            for k in keys:
                assert abs(g[k] - w[k]) <= CSV_TOL * max(abs(w[k]), 1.0), (name, k, g[k], w[k])


def _walk(a, b, check, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _walk(a[k], b[k], check, f"{path}/{k}")
    else:
        check(path, a, b)


def _same_checkpoints(got_dir, want_dir, n_steps):
    for name in NETWORKS:
        got = tckpt.load(os.path.join(got_dir, f"latest_checkpoint_{name}.msgpack"))
        want = tckpt.load(os.path.join(want_dir, f"latest_checkpoint_{name}.msgpack"))

        def check(path, a, b):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (name, path)
            if b.dtype.kind != "f" or "actnorm_stats" in path or "hyperparams" in path:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")
            elif path.startswith("/state_dict/params"):
                assert np.abs(a - b).max() <= 2 * LR * n_steps + 1e-5 * np.abs(b).max(), (
                    name, path, np.abs(a - b).max())
            elif path.startswith("/state_dict/spectral"):
                assert np.abs(a - b).max() <= 1e-2, (name, path, np.abs(a - b).max())
            elif path.startswith("/scheduler_state_dict"):
                assert a == pytest.approx(b, rel=1e-7), (name, path)

        _walk(got, want, check)


def test_main_csv_rows_match_jax_main(runs):
    """The gated epoch 0 from the same initial variables and draws."""
    _same_rows(runs["port_a"], runs["jax_a"], [0.0])


def test_main_checkpoints_match_jax_main(runs):
    _same_checkpoints(runs["port_a"], runs["jax_a"], n_steps=1)


def test_main_writes_best_and_keeps_gated_count(runs):
    for run in ("port_a", "jax_a"):  # the eval-L1 gate at inf writes the first epoch's best
        assert all(os.path.exists(os.path.join(runs[run], f"best_PFVD_{n}.msgpack"))
                   for n in ("GEN", "ENC"))
    disc = tckpt.load(os.path.join(runs["port_a"], "latest_checkpoint_DISC_t.msgpack"))
    assert int(disc["optim_state_dict"]["count"]) == 0  # the gated step did not count


def test_port_restores_jax_checkpoints_exactly(runs):
    """Networks, optimizer states, counts and learning rates, as the port's
    resume path (``load_variables``, ``load_optimizer_states``) reads them."""
    payloads = {name: tckpt.load(os.path.join(runs["jax_a"], f"latest_checkpoint_{name}.msgpack"))
                for name in NETWORKS}
    models = BUILD(tcfg.Config(stage1_config(P).to_dict()))
    for name, module in ts1.networks(models).items():
        ts1.load_variables(module, payloads[name]["state_dict"])
    optimizers = tstep.make_optimizers(models, LR, 1e-5)
    ts1.load_optimizer_states(models, optimizers, payloads)

    def equal(path, a, b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    states = ts1.optimizer_states(models, optimizers)
    for name, module in ts1.networks(models).items():
        _walk(ts1.variables(module), payloads[name]["state_dict"], equal, name)
        _walk(states[name], payloads[name]["optim_state_dict"], equal, name)


def test_port_resumes_from_jax_checkpoints(runs):
    """The port's ``main`` resumed from the JAX trainer's epoch 0 trains the
    open epoch 1."""
    out = runs["port_b"]
    assert out["global_step"] == 1  # the resumed run's one step: epoch 1
    assert [r["Epoch"] for r in _csv(out["save_path"], "log_per_epoch_train.csv")] == [1.0]
    assert all(np.isfinite(v) for v in out["train_metrics"].values())
    gen = tckpt.load(os.path.join(out["save_path"], "latest_checkpoint_GEN.msgpack"))
    disc = tckpt.load(os.path.join(out["save_path"], "latest_checkpoint_DISC_t.msgpack"))
    # both trainers save before the epoch's scheduler step and resume the saved
    # learning rate, so the resumed autoencoder trains epoch 1 at the initial one
    assert float(gen["optim_state_dict"]["hyperparams"]["learning_rate"]) == pytest.approx(
        LR, rel=1e-6)
    assert int(disc["optim_state_dict"]["count"]) == 1 and int(gen["epoch"]) == 2


def _port_payloads_for_jax(runs) -> dict:
    """The port's ``latest_checkpoint_*`` through the JAX package's reader."""
    return {name: jckpt.load(os.path.join(runs["port_a"], f"latest_checkpoint_{name}.msgpack"))
            for name in NETWORKS}


def test_jax_trainer_reads_port_variables(runs):
    """What the JAX trainer does on resume (``train/stage1.py:192-204``): the
    variables it takes from the port's checkpoints have its networks' trees,
    shapes and dtypes."""
    _, *init = _jax_init()
    payloads = _port_payloads_for_jax(runs)
    for name, tree in zip(NETWORKS, init):
        got = payloads[name]["state_dict"]
        assert jax.tree.structure(got) == jax.tree.structure(tree), name
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert a.shape == b.shape and a.dtype == b.dtype, name


def test_jax_trainer_restores_port_optimizer_states(runs):
    """``restore_into`` rebuilds the JAX trainer's optimizer states from the
    port's checkpoints value for value, and its schedulers take the
    scheduler state (``train/stage1.py:213-267``)."""
    _, *init = _jax_init()
    tr = stage1_config(P).Training
    payloads = _port_payloads_for_jax(runs)
    mk = lambda: adam_torch(LR, betas=(0.5, 0.9), weight_decay=tr["weight_decay"])  # noqa: E731
    targets = {"GEN": mk().init((init[0]["params"], init[1]["params"])),
               "DISC_t": mk().init(init[2]["params"]), "DISC_s": mk().init(init[3]["params"])}
    for name, target in targets.items():
        saved = payloads[name]["optim_state_dict"]
        restored = jckpt.restore_into(target, saved)
        assert jax.tree.structure(restored) == jax.tree.structure(target), name
        for a, b in zip(jax.tree.leaves(flax.serialization.to_state_dict(restored)),
                        jax.tree.leaves(saved)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    sched = LRController(LR, "exponential", gamma=tr["lr_gamma"])
    sched.load_state_dict(jax.tree.map(float, payloads["GEN"]["scheduler_state_dict"]))
    assert sched.lr == pytest.approx(LR) and int(payloads["GEN"]["epoch"]) == 1


def test_gen_checkpoint_loads_three_ways_and_serves(runs, world, tmp_path):
    run = runs["port_a"]
    payload = tckpt.load(os.path.join(run, "best_PFVD_GEN.msgpack"))
    tree = payload["state_dict"]
    assert set(tree) == {"params", "spectral"}
    opt = stage1_config(P)
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, P["img_size"], P["img_size"], 3)).astype(np.float32)
    z = rng.standard_normal((2, P["z_dim"])).astype(np.float32)
    want = np.asarray(jax.jit(JGenerator.from_config(opt.Decoder).apply)(tree, img, z))
    x0 = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 1)))
    serving = Generator.from_config(opt.Decoder)
    convert.load_checkpoint(serving, os.path.join(run, "best_PFVD_GEN.msgpack"))
    trainable = Generator.from_config(opt.Decoder, trainable=True)
    ts1.load_variables(trainable, tree)
    with torch.no_grad():
        outs = [m.eval()(x0, torch.from_numpy(z)).permute(0, 2, 3, 4, 1).numpy()
                for m in (serving, trainable)]
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the run directory as the stage-1 model of a served chain (random flow)
    ae_dir, s2_dir = tmp_path / "AE", tmp_path / "stage2"
    for d in (ae_dir, s2_dir):
        d.mkdir()
    tcfg.save(tcfg.Config(stage2_ae_config(P).to_dict()), str(ae_dir / "config_stage2_AE.yaml"))
    tcfg.save(tcfg.Config(stage2_config(P, run, str(ae_dir)).to_dict()),
              str(s2_dir / "config_stage2.yaml"))
    model = Model(str(s2_dir) + "/", vid_length=8, transfer=True, use_kernel=False,
                  allow_random_init=True, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(model.decoder(x0, torch.from_numpy(z)).permute(
            0, 2, 3, 4, 1).numpy(), want, rtol=1e-5, atol=1e-5)
        video = model.forward(img.transpose(0, 3, 1, 2))
    assert video.shape == (2, 8, 3, P["img_size"], P["img_size"])
    assert torch.isfinite(video).all()


def test_cli_trains_on_cpu_and_warns_once_without_i3d(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no models/ here: the posterior FVD finds no I3D weights
    opt = _opt(tcfg, world, "port_cli", 2)
    path = str(tmp_path / "config.yaml")
    tcfg.save(opt, path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tcli.main(["-cf", path, "-device", "cpu", "-gpu", "0"])
    fvd = [w for w in caught if "I3D weights not found" in str(w.message)]
    assert len(fvd) == 1, [str(w.message) for w in caught]
    assert out["global_step"] == 2 and math.isnan(out["PFVD"])
    assert all(np.isfinite(v) for v in out["train_metrics"].values())
    files = set(os.listdir(out["save_path"]))
    assert {"config_stage1.yaml", "best_PFVD_GEN.msgpack", "best_PFVD_ENC.msgpack",
            "log_per_epoch_train.csv", "log_per_epoch_eval.csv"} <= files
    assert {f"latest_checkpoint_{n}.msgpack" for n in NETWORKS} <= files
    rows = _csv(out["save_path"], "log_per_epoch_eval.csv")
    assert out["best_metric"] == pytest.approx(min(r["Loss_L1"] for r in rows))
    written = os.path.join(out["save_path"], "config_stage1.yaml")
    assert jcfg.load(written).to_dict() == tcfg.load(written).to_dict()
    assert tcfg.load(written).Training["save_path"] == out["save_path"]
    shutil.rmtree(out["save_path"])


def test_unported_option_raises_and_entry_points_default_to_cuda(world, monkeypatch):
    opt = _opt(tcfg, world, "port_raise", 1)
    opt.Training["distributed"] = True  # torchrun's environment, which is not set here
    with pytest.raises(RuntimeError, match="torchrun"):
        ts1.main(opt, eval_fvd=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts1.main(_opt(tcfg, world, "port_cuda", 1))
    seen = {}
    monkeypatch.setattr(ts1, "main", lambda opt, device=None: seen.setdefault("d", device))
    path = os.path.join(world[1], "cuda_config.yaml")
    tcfg.save(_opt(tcfg, world, "port_cuda", 1), path)
    tcli.main(["-cf", path])
    assert seen["d"] == "cuda"
