"""Every file writer of the port on a machine without imageio.

The CUDA machine the port serves on has PIL and no imageio, so each writer
that reaches imageio where it is installed must write with PIL alone there:
``utils/video``'s ``save_video`` (an MJPEG AVI), ``plot_vid`` (a GIF and
that AVI), ``write_image`` (``.png`` exactly, ``.jpg`` within JPEG's
rounding), ``cli/visualize_endpoint.write`` (GIFs and PNGs),
``cli/generate_transfer.main`` (its GIFs, on a tiny model directory that
``testing.make_model_dir`` writes) and the AE trainer's per-epoch recon
grid (``train.stage2_ae``; its dump is best effort, so its warning is made
an error here). One test, a case per writer, each with
``sys.modules["imageio"] = None`` (``import imageio`` raises ImportError).
Frames of 8 colours keep a GIF's palette exact.
"""

import os
import sys
import warnings

import numpy as np
import pytest
from PIL import Image, ImageSequence

from image2video_synthesis_using_cinns_tpu_torch import testing
from image2video_synthesis_using_cinns_tpu_torch.cli import generate_transfer, visualize_endpoint
from image2video_synthesis_using_cinns_tpu_torch.utils import video
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

JPEG_MEAN_ABS = 4  # JPEG's rounding of smooth frames, as tests/test_torch_cli.py holds the AVI


def _eight_colours(shape, seed: int = 5) -> np.ndarray:
    """uint8 frames (*shape, 3) of 8 colours."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (8, 3))[rng.integers(0, 8, shape)].astype(np.uint8)


def _smooth(t: int, size: int = 16) -> np.ndarray:
    """(t, size, size, 3) uint8 ramps, which JPEG keeps close."""
    ramp = np.linspace(0, 255, size)
    return np.stack([np.stack([np.add.outer(ramp, ramp) / 2, np.tile(ramp, (size, 1)),
                               np.full((size, size), 40.0 * k)], -1)
                     for k in range(t)]).astype(np.uint8)


def _gif(path) -> np.ndarray:
    with Image.open(path) as gif:
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)])


def _save_video(tmp_path):
    frames = _smooth(3)
    video.save_video(str(tmp_path / "clip.mp4"), frames, loops=2)
    assert sorted(os.listdir(tmp_path)) == ["clip.avi"]
    back = video.read_mjpeg_avi(str(tmp_path / "clip.avi"))
    assert back.shape == (6, 16, 16, 3)
    assert np.abs(back.astype(np.int16) - np.tile(frames, (2, 1, 1, 1))).mean() < JPEG_MEAN_ABS


def _plot_vid(tmp_path):
    from image2video_synthesis_using_cinns_tpu_torch.config import Config

    rng = np.random.default_rng(3)
    # two clips of 8-colour frames in [-1, 1] whose tile keeps its largest value 255
    gen, orig = (rng.integers(0, 2, (2, 3, 3, 16, 16)) * 2.0 - 1.0 for _ in range(2))
    opt = Config({"Training": {"save_path": str(tmp_path)}})
    os.makedirs(tmp_path / "videos")
    frames = video.plot_vid(opt, [gen, orig], epoch=1, mode="eval")
    assert frames.shape == (3, 3, 32, 32)  # (T, C, H, W): the pair tiled, 2 clips wide
    base = tmp_path / "videos" / "002_sequence_eval"
    assert sorted(os.listdir(tmp_path / "videos")) == [base.name + ".avi", base.name + ".gif"]
    np.testing.assert_array_equal(_gif(f"{base}.gif"), frames.transpose(0, 2, 3, 1))
    assert video.read_mjpeg_avi(f"{base}.avi").shape == (18, 32, 32, 3)  # looped 6 times


def _write_png(tmp_path):
    image = _eight_colours((20, 24))
    video.write_image(str(tmp_path / "grid.png"), image.astype(np.float64))
    with Image.open(tmp_path / "grid.png") as png:
        assert png.format == "PNG"
        np.testing.assert_array_equal(np.asarray(png), image)


def _write_jpg(tmp_path):
    image = _smooth(1, 32)[0]
    video.write_image(str(tmp_path / "grid.jpg"), image)
    with Image.open(tmp_path / "grid.jpg") as jpg:
        assert jpg.format == "JPEG"
        got = np.asarray(jpg.convert("RGB"))
    assert got.shape == image.shape
    assert np.abs(got.astype(np.int16) - image).mean() < JPEG_MEAN_ABS


def _visualize_endpoint_write(tmp_path):
    rng = np.random.default_rng(7)
    videos = rng.integers(0, 2, (2, 3, 4, 3, 8, 8)) * 2.0 - 1.0  # (N, realisations, T, C, H, W)
    visualize_endpoint.write(videos, str(tmp_path))
    for idx, v in enumerate(videos):
        np.testing.assert_array_equal(_gif(tmp_path / f"endpoint_{idx}.gif"),
                                      video.convert_seq2gif(v).astype(np.uint8))
        last = np.concatenate(list(np.transpose(v[:, -1], (0, 2, 3, 1))), axis=1)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"endpoint_{idx}.png")),
                                      ((last + 1) / 2 * 255).astype(np.uint8))


def _generate_transfer_main(tmp_path):
    p = testing.PRESETS["tiny"]
    ckpt = testing.make_model_dir(str(tmp_path / "ckpt"), "tiny", seed=3, device="cpu") + "/"
    for k in range(2):
        d = tmp_path / "assets" / "GT_samples" / "landscape" / "transfer" / f"vid{k}"
        os.makedirs(d)
        for n, frame in enumerate(_eight_colours((p["seq_length"], 32, 32), seed=k)):
            Image.fromarray(frame).save(d / f"{n}.png")
    handed = []
    write_gif = video.write_gif
    video.write_gif = lambda path, frames, fps=3: (handed.append(np.asarray(frames)),
                                                   write_gif(path, frames, fps))
    try:
        generate_transfer.main(["-dataset", "landscape", "-ckpt_path", ckpt,
                                "-seq_length", str(p["seq_length"]), "-device", "cpu"])
    finally:
        video.write_gif = write_gif
    assert len(handed) == 2
    for idx, frames in enumerate(handed):
        got = _gif(tmp_path / "assets" / "results" / "landscape" / f"transfer_{idx}.gif")
        # the query's row, then one row per start frame, tiled along the width
        assert got.shape == frames.shape == (p["seq_length"], 32, 3 * 32, 3)


def _ae_recon_grid(tmp_path):
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae

    opt = testing.stage2_ae_config(testing.PRESETS["tiny"])
    opt.AE.update(in_size=64, z_dim=64, chn=8, encoder_type="resnet18")
    opt.Data.update(img_size=64, data_path=testing.make_bair_data_dir(
        str(tmp_path / "data") + "/", n_videos=2, img=64, modes=("train", "eval")))
    opt.Training.update(bs=2, workers=0, n_epochs=1, save_path=str(tmp_path / "runs"))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="per-epoch")  # the dump's failure fails
        out = stage2_ae.main(opt, max_steps=1, device="cpu")
    with Image.open(os.path.join(out["save_path"], "images", "0_train_recon.jpg")) as jpg:
        assert jpg.format == "JPEG" and jpg.size == (2 * 64, 2 * 64)


WRITERS = {"save_video": _save_video, "plot_vid": _plot_vid, "write_image_png": _write_png,
           "write_image_jpg": _write_jpg, "visualize_endpoint_write": _visualize_endpoint_write,
           "generate_transfer_main": _generate_transfer_main, "ae_recon_grid": _ae_recon_grid}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_writer_without_imageio(writer, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.chdir(tmp_path)  # the CLIs write under ./assets
    WRITERS[writer](tmp_path)
