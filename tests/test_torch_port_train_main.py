"""The port's stage-2 trainer end to end on the CPU (``train.stage2.main``
and ``cli/train_stage2.py -device cpu``), at the tiny preset on a synthetic
BAIR split of 8 clips (2 steps an epoch at bs 4: at bs 2 the ActNorm init's
std over two similar clips is ill-conditioned, and rounding alone moves the
first loss by 0.2%), beside the JAX trainer.

* With the JAX package's draws injected (``JaxDraws``: the augment, eps and
  reference-noise keys of ``train/stage2.py``), one epoch of the port's
  ``main`` gives the JAX ``main``'s per-epoch losses (train and eval, 1e-5
  of the loss) and a ``cINN_latest`` with the same layout, the same frozen
  embedder and shuffles, the optimizer's moments to 1e-4 of their largest
  and each weight within two Adam steps (2 lr) of the JAX one (Adam's
  sign(g) first step turns rounding on near-zero gradients into +-lr).
* Resume: from the JAX package's ``cINN_latest`` the port's second epoch
  matches the JAX package's own resumed epoch; from the port's own
  ``cINN_latest`` a run matches an uninterrupted one (to 1e-6).
* Missing I3D weights give exactly one warning and the best checkpoint is
  still written; the port's ``cINN.msgpack`` loads in the JAX facade and the
  port's ``Model`` from the run directory, and both give the same video at a
  fixed residual (1e-4, kernels off on both sides).
* The posterior cache (``Training.cache_posteriors`` with ``Data.aug:
  false``): with the JAX draws and initial flow, one cached epoch of the
  port's ``main`` matches the JAX package's cached ``main`` to the
  tolerances above; the port's cached run matches its own uncached run with
  aug off (losses rtol 1e-5 and the flow rtol 1e-4, atol 5e-5, the JAX
  package's bounds for the cache's encoder batch against the step's).
* The CLI trains and writes its files; a SIGTERM through ``PreemptionGuard``
  stops the run after the step it came in and writes ``cINN_latest``;
  ``Training.distributed: true`` outside torchrun raises, and so does
  ``cache_posteriors`` with the augmentation on, before any model is built;
  the entry points default to ``cuda``; the config the trainer writes reads
  back in both packages.
"""

import csv
import math
import os
import signal
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml

from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu.testing import make_bair_data_dir
from image2video_synthesis_using_cinns_tpu.train import stage2 as jstage2
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.cli import train_stage2 as tcli
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.train import stage2 as tstage2
from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as tckpt
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_train_augment import jax_draws
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

LR = 1e-5  # the tiny preset's stage-2 config
LOSS_KEYS = ("Loss", "reference_nll_loss", "nlogdet_loss", "nll_loss")


class JaxDraws(tstage2.Draws):
    """The JAX trainer's draws: train keys ``fold_in(PRNGKey(42), step)``
    (augment from the key, the ActNorm eps from ``fold_in(key, 1)``, the
    step's eps and reference noise from ``split(fold_in(key, 2))``), eval
    keys ``fold_in(root, 10_000_000 + epoch * 10_000 + i)``."""

    root = jax.random.PRNGKey(42)

    def augment(self, epoch, index, global_step, n, params, random_crop):
        return jax_draws(jax.random.fold_in(self.root, global_step), n, params)

    def normal(self, purpose, epoch, index, global_step, shape):
        if purpose.startswith("eval"):
            k_enc, k_ref = jax.random.split(
                jax.random.fold_in(self.root, 10_000_000 + epoch * 10_000 + index))
        else:
            key = jax.random.fold_in(self.root, global_step)
            k_enc, k_ref = jax.random.split(jax.random.fold_in(key, 2))
            if purpose == "actnorm":
                k_enc = jax.random.fold_in(key, 1)
        k = k_ref if purpose.endswith("reference") else k_enc
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_main")
    model_dir = make_model_dir(str(root / "ckpts"), preset="tiny")
    data = make_bair_data_dir(str(root / "data") + "/", n_videos=8, img=32,
                              modes=("train", "eval"))
    return model_dir, data, root


def _opt(pkg, world, out: str, n_epochs: int, reload: str | None = None,
         cached: bool | None = None):
    """``cached`` set (True or False) turns the augmentation off and the
    posterior cache on or off."""
    model_dir, data, root = world
    opt = pkg.load(os.path.join(model_dir, "config_stage2.yaml"))
    opt.Data["data_path"] = data
    for k, v in dict(bs=4, bs_eval=4, workers=2, n_epochs=n_epochs,
                     save_path=str(root / out)).items():
        opt.Training[k] = v
    if reload:
        opt.Training["reload_path"] = reload
    if cached is not None:
        opt.Data["aug"] = False
        opt.Training["cache_posteriors"] = cached
    return opt


@pytest.fixture(scope="module")
def jax_runs(world):
    """The JAX trainer: one epoch, then a second epoch resumed from it."""
    first = jstage2.main(_opt(jcfg, world, "jax_a", 1), eval_fvd=False)["save_path"]
    second = jstage2.main(_opt(jcfg, world, "jax_b", 2, reload=first),
                          eval_fvd=False)["save_path"]
    return first, second


def _port_main_like_jax(opt):
    """The port's ``main`` with the JAX draws, from the JAX trainer's initial
    flow (``build_models``' ``PRNGKey(0)`` init, shuffles included: torch
    cannot draw them)."""
    build = tstage2.build_models

    def with_jax_init(opt):
        models = build(opt)
        net_vars = jstage2.build_models(jcfg.Config(opt.to_dict()))[-1]
        models.network.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, {
            "params": net_vars["params"], "buffers": net_vars["buffers"]})))
        return models

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstage2, "build_models", with_jax_init)
        return tstage2.main(opt, eval_fvd=False, device="cpu", draws=JaxDraws())


@pytest.fixture(scope="module")
def port_run(world):
    """The port's first epoch, as the JAX trainer runs it."""
    return _port_main_like_jax(_opt(tcfg, world, "port_a", 1))


def _csv(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        rows = list(csv.reader(f))
    return [dict(zip(rows[0], map(float, r))) for r in rows[1:]]


def _same_losses(got_dir, want_dir):
    for name in ("log_per_epoch_train.csv", "log_per_epoch_eval.csv"):
        got, want = _csv(got_dir, name), _csv(want_dir, name)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert g["Epoch"] == w["Epoch"] and g["LR"] == pytest.approx(w["LR"], rel=1e-7)
            assert math.isnan(g["PFVD"]) and math.isnan(w["PFVD"])
            for k in LOSS_KEYS:
                assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), abs(w["Loss"])), (name, k, g, w)


def _walk(a, b, check, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _walk(a[k], b[k], check, f"{path}/{k}")
    else:
        check(path, a, b)


def _same_latest(got_dir, want_dir, n_steps):
    got = tckpt.load(os.path.join(got_dir, "cINN_latest.msgpack"))
    want = tckpt.load(os.path.join(want_dir, "cINN_latest.msgpack"))
    assert got["epoch"] == want["epoch"]

    def check(path, a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if "/embedder/" in path or "/buffers/" in path or b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=path)
        elif "optim_state_dict" in path:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4 * np.abs(b).max() + 1e-30,
                                       err_msg=path)
        else:
            assert np.abs(a - b).max() <= 2 * LR * n_steps + 1e-6 * np.abs(b).max(), path

    _walk(got, want, check)


def test_main_matches_jax_main(port_run, jax_runs):
    _same_losses(port_run["save_path"], jax_runs[0])
    _same_latest(port_run["save_path"], jax_runs[0], n_steps=2)
    assert port_run["global_step"] == 2


def test_cached_main_matches_jax_cached_main(world):
    want = jstage2.main(_opt(jcfg, world, "jax_cached", 1, cached=True),
                        eval_fvd=False)["save_path"]
    got = _port_main_like_jax(_opt(tcfg, world, "port_cached", 1, cached=True))
    assert got["global_step"] == 2
    _same_losses(got["save_path"], want)
    _same_latest(got["save_path"], want, n_steps=2)


def test_cached_main_matches_own_uncached_run(world, capsys):
    """Two epochs from the same flow and draws: the cached steps resample the
    moments the uncached steps' encoder computes, from the same eps."""
    runs = {}
    for cached in (False, True):
        out = tstage2.main(_opt(tcfg, world, f"own_cached_{cached}", 2, cached=cached),
                           eval_fvd=False, device="cpu")
        assert out["global_step"] == 4
        runs[cached] = out["save_path"]
    assert "posterior cache: 176 windows x 2 x 16 fp32" in capsys.readouterr().out
    for name in ("log_per_epoch_train.csv", "log_per_epoch_eval.csv"):
        got, want = _csv(runs[True], name), _csv(runs[False], name)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in LOSS_KEYS:
                assert g[k] == pytest.approx(w[k], rel=1e-5), (name, k)
    got = tckpt.load(os.path.join(runs[True], "cINN_latest.msgpack"))["state_dict"]["params"]
    want = tckpt.load(os.path.join(runs[False], "cINN_latest.msgpack"))["state_dict"]["params"]
    _walk(got["flow"], want["flow"], lambda path, a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=5e-5, err_msg=path))


def test_resume_from_jax_checkpoint_matches_jax_resume(world, jax_runs):
    out = tstage2.main(_opt(tcfg, world, "port_b", 2, reload=jax_runs[0]), eval_fvd=False,
                       device="cpu", draws=JaxDraws())
    _same_losses(out["save_path"], jax_runs[1])
    _same_latest(out["save_path"], jax_runs[1], n_steps=2)


def test_resume_from_own_checkpoint_matches_uninterrupted_run(world):
    whole = tstage2.main(_opt(tcfg, world, "own_whole", 2), eval_fvd=False, device="cpu")
    first = tstage2.main(_opt(tcfg, world, "own_first", 1), eval_fvd=False, device="cpu")
    rest = tstage2.main(_opt(tcfg, world, "own_rest", 2, reload=first["save_path"]),
                        eval_fvd=False, device="cpu")
    assert whole["global_step"] == 4 and first["global_step"] == rest["global_step"] == 2
    got = tckpt.load(os.path.join(rest["save_path"], "cINN_latest.msgpack"))
    want = tckpt.load(os.path.join(whole["save_path"], "cINN_latest.msgpack"))
    _walk(got, want, lambda path, a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=path))
    for name in ("log_per_epoch_train.csv", "log_per_epoch_eval.csv"):
        g, w = _csv(rest["save_path"], name)[-1], _csv(whole["save_path"], name)[-1]
        for k in ("Epoch", "LR") + LOSS_KEYS:
            assert g[k] == pytest.approx(w[k], rel=1e-6), (name, k)


def test_missing_i3d_warns_once_and_checkpoint_loads_in_both_facades(world, tmp_path,
                                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)  # no models/ here: the prior FVD finds no I3D weights
    opt = _opt(tcfg, world, "port_fvd", 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tstage2.main(opt, device="cpu")
    fvd = [w for w in caught if "I3D weights not found" in str(w.message)]
    assert len(fvd) == 1, [str(w.message) for w in caught]
    run = out["save_path"]
    for name in ("config_stage2.yaml", "cINN.msgpack", "cINN_latest.msgpack",
                 "log_per_epoch_train.csv", "log_per_epoch_eval.csv"):
        assert os.path.exists(os.path.join(run, name)), name
    assert np.isfinite(out["train_loss"]).all() and np.isfinite(out["eval_loss"]).all()
    assert out["best_metric"] == pytest.approx(min(r["Loss"] for r in _csv(
        run, "log_per_epoch_eval.csv")))
    # the config the trainer wrote reads back in both packages
    assert jcfg.load(os.path.join(run, "config_stage2.yaml")).to_dict() == opt.to_dict()

    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    residual = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(JaxModel(run + "/", vid_length=8, use_pallas=False)
                      .forward(x0, residual=residual))
    got = Model(run + "/", vid_length=8, use_kernel=False, device="cpu").forward(
        x0, residual=residual).numpy()
    assert got.shape == want.shape == (2, 8, 3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cli_trains_on_cpu(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt = _opt(tcfg, world, "port_cli", 1)
    path = str(tmp_path / "config.yaml")
    tcfg.save(opt, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the prior FVD's missing I3D weights
        out = tcli.main(["-cf", path, "-device", "cpu", "-gpu", "0"])
    assert out["global_step"] == 2
    assert {"config_stage2.yaml", "cINN.msgpack", "cINN_latest.msgpack", "videos"} <= set(
        os.listdir(out["save_path"]))


def test_sigterm_stops_the_run_and_writes_latest(world, monkeypatch):
    step = tstage2.train_step

    def step_then_sigterm(*a, **k):
        aux = step(*a, **k)
        signal.raise_signal(signal.SIGTERM)  # the guard's handler only sets its flag
        return aux

    monkeypatch.setattr(tstage2, "train_step", step_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    out = tstage2.main(_opt(tcfg, world, "port_term", 3), eval_fvd=False, device="cpu")
    assert out["global_step"] == 1  # stopped after the first of 2 x 3 steps
    latest = tckpt.load(os.path.join(out["save_path"], "cINN_latest.msgpack"))
    assert int(latest["epoch"]) == 1
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("key,value,error,match", [
    ("distributed", True, RuntimeError, "torchrun"),
    ("cache_posteriors", True, ValueError, "requires Data.aug: false")])
def test_unported_options_raise(world, monkeypatch, key, value, error, match):
    """Refused before any model is built; the cache only with aug on."""
    opt = _opt(tcfg, world, "port_raise", 1)
    opt.Training[key] = value
    opt.Data["aug"] = True
    monkeypatch.setattr(tstage2, "build_models", lambda opt: pytest.fail("a model was built"))
    with pytest.raises(error, match=match):
        tstage2.main(opt, eval_fvd=False, device="cpu")


def test_entry_points_default_to_cuda(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstage2.main(_opt(tcfg, world, "port_cuda", 1))
    seen = {}
    monkeypatch.setattr(tstage2, "main", lambda opt, device=None: seen.setdefault("d", device))
    tcli.main(["-cf", os.path.join(world[0], "config_stage2.yaml")])
    assert seen["d"] == "cuda"


def test_config_dumps_reads_back():
    cfg = tcfg.Config({"A": {"lr": 1e-05, "big": 1e16, "neg": -2.5e-7, "half": 0.5, "n": 3,
                             "flag": False, "none": None, "inf": float("inf"),
                             "s": 'quote " and: colon', "list": [1, 2.0, "x", None],
                             "empty": {}, "nested": {"deep": [0.1, 1e-8]}},
                       "B": "plain"})
    text = tcfg.dumps(cfg)
    for loaded in (yaml.safe_load(text), tcfg.loads(text).to_dict(), jcfg.loads(text).to_dict()):
        assert loaded == cfg.to_dict()
