"""The port's stage-2 AE trainer end to end on the CPU (``train.stage2_ae.main``
and ``cli/train_stage2_AE.py -device cpu``) beside the JAX trainer, and the
port's ``cli/visualize_endpoint.py``.

* Both trainers at the debug width (``test_torch_port_ae_step.ae_opt``: chn
  8, 64 px, resnet18 'in' encoder, z 64, pretrain 1) at ``MAIN_LR``, 1e-4
  of the config's lr, on synthetic BAIR train and eval splits of 2 clips, 2 epochs
  of one step at bs 2 (``max_steps=2``: epoch 0 gated, with the
  discriminator's ActNorm init; epoch 1 open), from the same numpy-drawn
  variables (the JAX trainer's ``network.init``, ``disc.init`` and
  ``lpips.init`` return them) and with the JAX trainer's augment draws
  (``fold_in(PRNGKey(42), global_step)``): the CSV rows of both epochs
  agree to ``CSV_TOL`` of max(|value|, 1), the learning rates exactly;
  both write ``Encoder_stage2.msgpack`` with the same collections, paths,
  shapes and dtypes, and weights within 2 lr a step, of which at most 1%
  more than lr / 2 apart, and most moved by the two steps. Each Adam step
  moves a weight by about +-lr with its gradient's sign, which rounding
  picks where the gradient is 0 up to rounding; through 11 M encoder
  weights that moves the post-update metrics apart, in proportion to the
  lr: by up to 1e-2 of their values by epoch 1 at a tenth of the config's
  lr (measured), so the trajectories are compared at ``MAIN_LR``.
* ``Encoder_stage2`` passes both ways: the port's file in the JAX
  ``ResnetEncoder`` and the JAX file in the port's serving ``ResnetEncoder``
  embed alike (1e-5 of the largest embedding); the port's file, in the AE
  directory of a stage-2 model, is spliced by the JAX ``Model`` and loaded
  by the port's ``Model`` and stage-2 ``build_models``, which embed as the
  JAX encoder does.
* The CLI trains on the CPU and writes the JAX layout (config, CSVs, recon
  grid, encoder); ``AE.pretrained`` without its file and
  ``Training.distributed: true`` outside torchrun raise; the entry points
  default to ``cuda``.
* ``visualize_endpoint -device cpu`` against the root script on the JAX
  package's tiny control checkpoint and a synthetic BAIR endpoint test
  split, the residuals of both pinned to one numpy stream: its GIFs and
  PNGs, and the stacked videos of both within ``ENDPOINT_TOL``; with
  ``-data_parallel`` on three CPU replicas and ``-spatial_shard 2`` on two
  CPU devices, the one-device videos within the JAX package's parallel bound.
"""

import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.models.facade import Model as JModel
from image2video_synthesis_using_cinns_tpu.models.stage2.resnet2d import (
    ResnetEncoder as JResnetEncoder,
)
from image2video_synthesis_using_cinns_tpu.parallel.mesh import make_mesh
from image2video_synthesis_using_cinns_tpu.testing import (
    PRESETS,
    make_bair_data_dir,
    stage1_config,
    stage2_config,
)
from image2video_synthesis_using_cinns_tpu.train import stage2_ae as jstage2_ae
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.cli import train_stage2_AE as tcli
from image2video_synthesis_using_cinns_tpu_torch.cli import visualize_endpoint
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.resnet2d import ResnetEncoder
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.train import stage2 as ts2
from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae as tae
from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as tckpt
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_ae_layers import cf
from test_torch_port_ae_step import _flat, ae_opt, jax_variables, port_models
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_train_augment import jax_draws
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

CSV_TOL, EMBED_TOL = 1e-4, 1e-5
MAIN_LR = 2e-8  # see the module docstring


class JaxDraws(tae.Draws):
    """The JAX trainer's augment draws: ``fold_in(PRNGKey(42), global_step)``."""

    root = jax.random.PRNGKey(42)

    def augment(self, epoch, index, global_step, n, params, random_crop):
        return jax_draws(jax.random.fold_in(self.root, global_step), n, params)


class _JaxWithVariables:
    """``jax`` for the JAX trainer's module, whose ``jit`` of a module's
    ``init`` returns the given variables (by the module's class name)."""

    def __init__(self, trees: dict):
        self.trees = trees

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fun, *args, **kwargs):
        owner = type(getattr(fun, "__self__", None)).__name__
        if getattr(fun, "__name__", "") == "init" and owner in self.trees:
            return lambda *a, **k: jax.tree.map(jnp.asarray, self.trees[owner])
        return jax.jit(fun, *args, **kwargs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ae_train")
    data = make_bair_data_dir(str(root / "data") + "/", n_videos=2, img=64,
                              modes=("train", "eval"))
    return data, root


def _opt(pkg, world, out: str, n_epochs: int = 2):
    data, root = world
    opt = ae_opt(pkg)
    opt.Data["data_path"] = data
    opt.Training.update(bs=2, workers=2, n_epochs=n_epochs, lr=MAIN_LR,
                        save_path=str(root / out))
    return opt


@pytest.fixture(scope="module")
def variables():
    return jax_variables(ae_opt(tcfg))


@pytest.fixture(scope="module")
def runs(world, variables):
    trees = {"BigAE": variables["GEN"], "NLayerDiscriminator": variables["DISC"],
             "LPIPS": variables["LPIPS"]}
    with pytest.MonkeyPatch.context() as mp:  # one CPU device: see the stage-1 trainer test
        mp.setattr(jstage2_ae, "jax", _JaxWithVariables(trees))
        mp.setattr(jstage2_ae, "make_mesh", lambda: make_mesh(1))
        jax_out = jstage2_ae.main(_opt(jcfg, world, "jax"), max_steps=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tae, "build_models", lambda opt: port_models(opt, variables))
        port_out = tae.main(_opt(tcfg, world, "port"), max_steps=2, device="cpu",
                            draws=JaxDraws())
    return {"jax": jax_out, "port": port_out}


def _csv(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        rows = list(csv.reader(f))
    return [dict(zip(rows[0], map(float, r))) for r in rows[1:]]


def test_main_csv_rows_match_jax(runs):
    for name in ("log_per_epoch_train.csv", "log_per_epoch_test.csv"):
        got, want = (_csv(runs[k]["save_path"], name) for k in ("port", "jax"))
        assert [r["Epoch"] for r in got] == [r["Epoch"] for r in want] == [0, 1], name
        for g, w in zip(got, want):
            assert g["LR"] == pytest.approx(w["LR"], rel=1e-7)
            assert g["Disc_factor"] == w["Disc_factor"] == g["Epoch"]
            for k in tae.LOG_KEYS:
                assert abs(g[k] - w[k]) <= CSV_TOL * max(abs(w[k]), 1.0), (name, k, g[k], w[k])
    assert runs["port"]["global_step"] == 2
    assert runs["port"]["best_val"] == pytest.approx(runs["jax"]["best_val"], rel=CSV_TOL)


def _encoder_file(run) -> str:
    return os.path.join(run["save_path"], "Encoder_stage2.msgpack")


def test_main_writes_the_jax_layout(runs, variables):
    mine = _flat(tckpt.load(_encoder_file(runs["port"]))["state_dict"])
    theirs = _flat(jstage2_ae.ckpt_io.load(_encoder_file(runs["jax"]))["state_dict"])
    initial = _flat({c: t["encoder"] for c, t in variables["GEN"].items() if "encoder" in t})
    assert set(mine) == set(theirs) == set(initial)
    far = moved = total = 0
    for path, b in theirs.items():
        a = mine[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.abs(a - b).max() <= 2 * 2 * MAIN_LR + 1e-6 * np.abs(b).max(), path
        far += int((np.abs(a - b) > MAIN_LR / 2).sum())
        moved += int((np.abs(a - initial[path]) > MAIN_LR / 2).sum())
        total += a.size
    assert far <= 0.01 * total and moved >= 0.5 * total, (far, moved, total)
    files = set(os.listdir(runs["port"]["save_path"]))
    assert {"config_stage2_AE.yaml", "log_per_epoch_train.csv", "log_per_epoch_test.csv",
            "Encoder_stage2.msgpack", "images"} <= files
    written = os.path.join(runs["port"]["save_path"], "config_stage2_AE.yaml")
    assert jcfg.load(written).to_dict() == tcfg.load(written).to_dict()


def _jax_embed(ae_cfg: dict, tree: dict, x: np.ndarray) -> np.ndarray:
    return np.asarray(JResnetEncoder.from_config(ae_cfg).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))


def _images(n: int, size: int) -> np.ndarray:
    return np.random.default_rng(3).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _port_embed(module: torch.nn.Module, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return module(cf(x)).numpy()


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert np.abs(got - want).max() <= EMBED_TOL * np.abs(want).max()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_encoder_file_passes_both_ways(runs, writer):
    ae_cfg = dict(ae_opt(tcfg).AE)
    x = _images(3, 64)
    tree = tckpt.load(_encoder_file(runs[writer]))["state_dict"]
    serving = convert.load_checkpoint(ResnetEncoder(ae_cfg["z_dim"], ae_cfg["encoder_type"],
                                                    ae_cfg["norm"]), _encoder_file(runs[writer]))
    _close(_port_embed(serving, x), _jax_embed(ae_cfg, tree, x))


def _stage1_dir(root, p) -> str:
    """A stage-1 run directory of ``p``'s shapes: its config and random
    trainable networks written in the JAX layout."""
    d = os.path.join(root, "stage1")
    os.makedirs(d, exist_ok=True)
    opt = tcfg.Config(stage1_config(p).to_dict())
    tcfg.save(opt, os.path.join(d, "config_stage1.yaml"))
    models = ts1.build_models(opt)
    for name, module in (("best_PFVD_GEN", models.decoder), ("best_PFVD_ENC", models.encoder)):
        tckpt.save(os.path.join(d, name + ".msgpack"), {"state_dict": ts1.variables(module)})
    return d


def test_port_encoder_file_serves_stage2_in_both_packages(runs, world):
    """The port run's directory as the AE of a stage-2 model: the JAX
    ``Model`` splices its encoder, the port's ``Model`` and stage-2
    ``build_models`` load it; all embed alike."""
    root = world[1] / "chained"
    ae_dir = runs["port"]["save_path"]
    p = dict(PRESETS["tiny"], img_size=64, cond_z=64)
    s1 = _stage1_dir(root, p)
    s2 = os.path.join(root, "stage2")
    os.makedirs(s2)
    opt2 = tcfg.Config(stage2_config(p, s1, ae_dir).to_dict())
    tcfg.save(opt2, os.path.join(s2, "config_stage2.yaml"))
    tree = tckpt.load(_encoder_file(runs["port"]))["state_dict"]
    ae_cfg = dict(tcfg.load(os.path.join(ae_dir, "config_stage2_AE.yaml")).AE)
    x = _images(2, 64)
    want = _jax_embed(ae_cfg, tree, x)[:, :ae_cfg["z_dim"]]  # the posterior's mode

    jmodel = JModel(s2 + "/", vid_length=4, allow_random_init=True)
    spliced = {c: t["embedder"] for c, t in jmodel.flow_vars.items()
               if isinstance(t, dict) and "embedder" in t}
    assert _flat(spliced).keys() == _flat(tree).keys()
    _close(_jax_embed(ae_cfg, spliced, x)[:, :ae_cfg["z_dim"]], want)

    model = Model(s2 + "/", vid_length=4, allow_random_init=True, device="cpu")
    with torch.no_grad():
        _close(model.flow.embed([cf(x)]).numpy(), want)
    models = ts2.build_models(opt2)
    with torch.no_grad():
        _close(models.network.embed([cf(x)]).numpy(), want)


def test_cli_trains_on_the_cpu(world, variables, monkeypatch):
    path = os.path.join(world[1], "cli_config.yaml")
    tcfg.save(_opt(tcfg, world, "cli", n_epochs=1), path)
    monkeypatch.setattr(tae, "build_models", lambda opt: port_models(opt, variables))
    out = tcli.main(["-cf", path, "-gpu", "0", "-device", "cpu"])
    rows = _csv(out["save_path"], "log_per_epoch_test.csv")
    assert [r["Epoch"] for r in rows] == [0] and out["best_val"] == rows[0]["Loss_recon"]
    assert os.path.exists(os.path.join(out["save_path"], "Encoder_stage2.msgpack"))
    grid = np.asarray(Image.open(os.path.join(out["save_path"], "images", "0_train_recon.jpg")))
    assert grid.shape == (2 * 64, 2 * 64, 3)


def test_unported_options_raise_and_entry_points_default_to_cuda(world, monkeypatch):
    opt = _opt(tcfg, world, "raise")
    opt.AE["pretrained"] = True  # the ImageNet BigGAN file is absent: the JAX package's error
    with pytest.raises(FileNotFoundError, match="no ImageNet BigGAN checkpoint at "
                                                "models/biggan/biggan_64.pth"):
        tae.main(opt, device="cpu")
    opt = _opt(tcfg, world, "raise")
    opt.Training["distributed"] = True  # torchrun's environment, which is not set here
    with pytest.raises(RuntimeError, match="torchrun"):
        tae.main(opt, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tae.main(_opt(tcfg, world, "cuda"))
    seen = {}
    monkeypatch.setattr(tae, "main", lambda opt, device=None: seen.setdefault("d", device))
    path = os.path.join(world[1], "cuda_config.yaml")
    tcfg.save(_opt(tcfg, world, "cuda"), path)
    tcli.main(["-cf", path])
    assert seen["d"] == "cuda"


# -- visualize_endpoint --------------------------------------------------------------------------

def pin_residuals(monkeypatch, cls, seed: int = 5) -> None:
    """Replace ``cls.__call__`` so that the k-th call of ``model(x0,
    cond=...)`` samples under the k-th nu of a numpy stream of ``seed``, the
    same in both packages: their loops then give the same videos only if
    they make the same calls in the same order."""
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(cls, "__call__", lambda model, x0, cond=None: model.forward(
        x0, cond, residual=rng.standard_normal((x0.shape[0], model.z_dim)).astype(np.float32)))


ENDPOINT_TOL = 2e-3  # the kernel paths of both packages: test_torch_port_control's bound


def test_visualize_endpoint_cli(tmp_path, monkeypatch):
    """The port's CLI against the root script on one control checkpoint and
    split, with the residuals pinned: the stacked (n_samples, n_realiz, T,
    C, H, W) videos agree within ``ENDPOINT_TOL``. 4 clips at bs 2 and
    ``-n_samples 3`` cut the second batch short."""
    import visualize_endpoint as jcli

    from image2video_synthesis_using_cinns_tpu.utils import video as jvid

    ckpt = make_model_dir(str(tmp_path / "ckpt"), preset="tiny", control=True) + "/"
    data = make_bair_data_dir(str(tmp_path / "bair") + "/", n_videos=4, img=32, modes=("test",))
    monkeypatch.chdir(tmp_path)
    args = ["-dataset", "bair", "-data_path", data, "-ckpt_path", ckpt, "-seq_length", "8",
            "-n_samples", "3", "-n_realiz", "2", "-bs", "2"]

    jax_videos = []
    monkeypatch.setattr(jvid, "convert_seq2gif", lambda v, real=jvid.convert_seq2gif: (
        jax_videos.append(np.asarray(v)), real(v))[1])
    monkeypatch.setattr(sys, "argv", ["visualize_endpoint.py", *args])
    pin_residuals(monkeypatch, JModel)
    jcli.main()
    want = np.stack(jax_videos)

    videos = {}
    monkeypatch.setattr(visualize_endpoint, "write",
                        lambda v, real=visualize_endpoint.write: (videos.__setitem__("v", v),
                                                                  real(v)))
    pin_residuals(monkeypatch, Model)
    visualize_endpoint.main(args + ["-device", "cpu"])
    out = tmp_path / "assets" / "results" / "bair_endpoint"
    for idx in range(3):
        gif = np.asarray(Image.open(out / f"endpoint_{idx}.gif").convert("RGB"))
        png = np.asarray(Image.open(out / f"endpoint_{idx}.png"))
        assert gif.shape == png.shape == (32, 2 * 32, 3)
    v = videos["v"]
    assert v.shape == want.shape == (3, 2, 8, 3, 32, 32)
    assert np.isfinite(v).all() and np.abs(v).max() <= 1
    np.testing.assert_allclose(v, want, rtol=ENDPOINT_TOL, atol=ENDPOINT_TOL)
    # three CPU replicas (each batch of 2 padded to 3) serve the same videos,
    # to the JAX package's data-parallel bound (tests/test_parallel.py)
    from image2video_synthesis_using_cinns_tpu_torch.models import facade
    from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(facade, "make_mesh", lambda: make_mesh(devices=["cpu"] * 3))
    pin_residuals(monkeypatch, Model)
    visualize_endpoint.main(args + ["-device", "cpu", "-data_parallel"])
    np.testing.assert_allclose(videos["v"], v, rtol=1e-3, atol=1e-4)
    assert videos["v"] is not v
    # the decoder's width split over two CPU devices serves the same videos,
    # to the JAX package's spatial bound (tests/test_parallel.py)
    monkeypatch.setattr(facade, "make_mesh", lambda: make_mesh(devices=["cpu"] * 2))
    pin_residuals(monkeypatch, Model)
    visualize_endpoint.main(args + ["-device", "cpu", "-spatial_shard", "2"])
    np.testing.assert_allclose(videos["v"], v, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="BAIR only"):
        visualize_endpoint.main(["-dataset", "landscape", "-device", "cpu"])
