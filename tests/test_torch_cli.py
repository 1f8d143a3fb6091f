"""The port's entry points (``cli/generate_samples.py``,
``cli/generate_transfer.py``) and its video and seed helpers, on the CPU:
both CLIs driven in-process with ``-device cpu`` on the tiny preset's
checkpoint and synthetic frames, as ``tests/test_generate_clis.py`` drives
the root CLIs; the port's image loader against the root CLI's cv2 loader
(1e-5: both are bilinear without antialiasing, in fp32); ``-spatial_shard``
alone and beside ``-data_parallel`` against one device and, for
``generate_samples``, against the root CLI's; the GIF and MJPEG helpers
against the JAX package's copies.
"""

import argparse
import os
import random
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from image2video_synthesis_using_cinns_tpu.testing import PRESETS, make_model_dir
from image2video_synthesis_using_cinns_tpu.utils import video as jvideo
from image2video_synthesis_using_cinns_tpu_torch.cli import generate_samples, generate_transfer
from image2video_synthesis_using_cinns_tpu_torch.utils import seed as tseed
from image2video_synthesis_using_cinns_tpu_torch.utils import video as tvideo
from test_torch_port_eval import same_residuals  # noqa: F401
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_model_dir(str(tmp_path_factory.mktemp("ckpt")), preset="tiny") + "/"


def _write_frames(d, n, img, seed=0):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for k in range(n):
        Image.fromarray(rng.integers(0, 255, (img, img, 3)).astype(np.uint8)).save(
            os.path.join(d, f"{k}.png"))


def test_generate_transfer_cli(tmp_path, monkeypatch, ckpt):
    p = PRESETS["tiny"]
    monkeypatch.chdir(tmp_path)
    for k, name in enumerate(("vid0", "vid1")):
        _write_frames(str(tmp_path / "assets" / "GT_samples" / "landscape" / "transfer" / name),
                      p["seq_length"], 40, seed=k)  # 40 px frames, resized to 32
    generate_transfer.main(["-gpu", "0", "-dataset", "landscape", "-ckpt_path", ckpt,
                            "-seq_length", str(p["seq_length"]), "-device", "cpu"])
    out = tmp_path / "assets" / "results" / "landscape"
    for idx in (0, 1):
        frames = np.asarray(Image.open(out / f"transfer_{idx}.gif").convert("RGB"))
        # the query's row, then one row per start frame, tiled along the width
        assert frames.shape == (32, 3 * 32, 3)


def test_generate_samples_cli(tmp_path, monkeypatch, ckpt):
    p = PRESETS["tiny"]
    monkeypatch.chdir(tmp_path)
    _write_frames(str(tmp_path / "assets" / "GT_samples" / "bair"), 3, p["img_size"])
    generate_samples.main(["-dataset", "bair", "-ckpt_path", ckpt, "-seq_length", "8",
                           "-bs", "2", "-device", "cpu"])
    gif = tmp_path / "assets" / "results" / "bair" / "results.gif"
    assert np.asarray(Image.open(gif).convert("RGB")).shape == (32, 3 * 32, 3)


@pytest.mark.parametrize("flag", [["-spatial_shard", "2", "-data_parallel"], ["-spatial_shard", "2"]])
@pytest.mark.parametrize("cli", [generate_samples, generate_transfer])
def test_multi_device_flags_serve(cli, flag, tmp_path, monkeypatch, ckpt, request):
    """``-spatial_shard 2``, alone (the first two of four CPU devices) or
    beside ``-data_parallel`` (a 2 x 2 grid), writes the frames one device
    writes, to one quantisation step; ``generate_samples -spatial_shard 2``
    also those of the root CLI's on the eight JAX devices, the residuals
    shared (``same_residuals``). The frames are those each CLI hands to
    ``imageio.mimsave``: the GIF's palette can map frames one step apart to
    colours far apart."""
    import imageio

    from image2video_synthesis_using_cinns_tpu_torch.models import facade
    from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_mesh

    p = PRESETS["tiny"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(facade, "make_mesh", lambda: make_mesh(devices=["cpu"] * 4))
    written, mimsave = {}, imageio.mimsave

    def record(path, frames, **kw):
        written[os.path.normpath(path)] = np.asarray(frames, np.int16)
        return mimsave(path, frames, **kw)

    monkeypatch.setattr(imageio, "mimsave", record)
    if cli is generate_samples:
        _write_frames(str(tmp_path / "assets" / "GT_samples" / "bair"), 3, p["img_size"])
        args = ["-dataset", "bair", "-ckpt_path", ckpt, "-seq_length", "8", "-bs", "3"]
        outs = ["bair/results.gif"]
    else:
        for k, name in enumerate(("vid0", "vid1")):
            _write_frames(str(tmp_path / "assets" / "GT_samples" / "landscape" / "transfer" / name),
                          p["seq_length"], 40, seed=k)
        args = ["-dataset", "landscape", "-ckpt_path", ckpt, "-seq_length", str(p["seq_length"])]
        outs = ["landscape/transfer_0.gif", "landscape/transfer_1.gif"]

    def gifs():
        return [written.pop(os.path.normpath(os.path.join("assets", "results", o))) for o in outs]

    def port(extra):
        cli.main(args + ["-device", "cpu"] + extra)
        return gifs()

    def close(got, want):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1  # one quantisation step of the frames

    close(port(flag), port([]))
    if cli is generate_samples and flag == ["-spatial_shard", "2"]:
        import generate_samples as root_cli

        request.getfixturevalue("same_residuals")
        monkeypatch.setattr(sys, "argv", ["generate_samples.py"] + args + flag)
        root_cli.main()
        root = gifs()  # read before the port's run writes the same files
        close(port(flag), root)


def test_device_flags():
    parser = argparse.ArgumentParser()
    generate_samples.add_serving_flags(parser)
    parse = lambda *a: generate_samples.serving_device(parser.parse_args(["-dataset", "x", *a]))
    assert parse() == "cuda"
    assert parse("-gpu", "1") == "cuda:1"
    assert parse("-device", "cpu", "-gpu", "1") == "cpu"


def test_transfer_cli_is_landscape_only():
    with pytest.raises(SystemExit):
        generate_transfer.main(["-dataset", "bair", "-device", "cpu"])


@pytest.mark.parametrize("size", [48, 20])
def test_load_images_matches_root_cli(tmp_path, size):
    """The port's PIL + torch bilinear loader against the root CLI's cv2 one,
    downscaling and upscaling."""
    from generate_samples import load_images as root_load_images

    rng = np.random.default_rng(4)
    for name in ("a.png", "b.jpg"):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(tmp_path / name)
    ours = generate_samples.load_images(str(tmp_path), img_res=32)
    ref = root_load_images(str(tmp_path), img_res=32)
    assert ours.shape == ref.shape == (2, 3, 32, 32) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_natsorted_matches_root_cli():
    import generate_transfer as root

    names = ["f10.png", "f2.png", "f1.png", "g.png", "f02.png"]
    assert generate_transfer.natsorted(names) == root.natsorted(names)


def test_video_helpers_match_jax_package(tmp_path):
    seq = np.tanh(np.random.default_rng(5).standard_normal((2, 3, 3, 8, 8))).astype(np.float32)
    np.testing.assert_array_equal(tvideo.denorm(seq), jvideo.denorm(seq))
    np.testing.assert_array_equal(tvideo.convert_seq2gif(torch.from_numpy(seq)),
                                  jvideo.convert_seq2gif(seq))
    ramp = np.linspace(0, 255, 16)  # smooth frames, which JPEG keeps close
    frames = np.stack([np.stack([np.add.outer(ramp, ramp) / 2, np.tile(ramp, (16, 1)),
                                 np.full((16, 16), 40.0 * t)], -1) for t in range(3)])
    frames = frames.astype(np.uint8)
    tvideo.write_mjpeg_avi(str(tmp_path / "port.avi"), frames)
    jvideo.write_mjpeg_avi(str(tmp_path / "jax.avi"), frames)
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()
    back = tvideo.read_mjpeg_avi(str(tmp_path / "port.avi"))
    assert back.shape == frames.shape
    assert np.abs(back.astype(np.int16) - frames).mean() < 4  # JPEG at quality 92


def test_save_video_writes_a_video(tmp_path):
    frames = np.random.default_rng(6).integers(0, 255, (3, 16, 16, 3)).astype(np.uint8)
    tvideo.save_video(str(tmp_path / "clip.mp4"), frames, loops=2)
    written = [f for f in os.listdir(tmp_path) if f.startswith("clip.")]
    assert written in (["clip.mp4"], ["clip.avi"])  # mp4 with ffmpeg, else the MJPEG AVI
    if written == ["clip.avi"]:
        assert tvideo.read_mjpeg_avi(str(tmp_path / "clip.avi")).shape == (6, 16, 16, 3)


def test_set_seed_seeds_python_numpy_and_a_generator(monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # restored after the test
    g = tseed.set_seed(3)
    a = (random.random(), np.random.rand(), torch.randn(2, generator=g))
    g = tseed.set_seed(3)
    b = (random.random(), np.random.rand(), torch.randn(2, generator=g))
    assert a[:2] == b[:2] and torch.equal(a[2], b[2])
    assert os.environ["PYTHONHASHSEED"] == "3"
