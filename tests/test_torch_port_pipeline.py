"""The port's empty-disk pipeline drive (``cli/pipeline_drive.py``) on the
CPU, at the tiny preset, against the JAX package.

One run of the drive's CLI (2 steps, 4 clips a split, bs 2, as
``tests/test_pipeline.py`` runs the JAX drive) trains stage 1, the AE and
the cINN from the directories the earlier trainers wrote, then runs the
generate and eval CLIs and ``Model`` on the cINN's directory. Checks: every
artifact where the next consumer looks for it; the JAX package's ``Model``
reads the chain of directories the port wrote and samples the port
``Model``'s video from the same x0 and residual (1e-4, the bound of
``test_torch_port_model.py``); the port's ``make_bair_data_dir`` writes the
JAX fixture's files byte for byte; the trainer configs equal the JAX ones.
"""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest

from image2video_synthesis_using_cinns_tpu import testing as jtesting
from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu_torch import testing as ttesting
from image2video_synthesis_using_cinns_tpu_torch.cli import pipeline_drive
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401


@pytest.fixture(scope="module")
def drive(tmp_path_factory, two_threads):
    """The drive's CLI on the CPU, its printed lines and its artifacts."""
    root = str(tmp_path_factory.mktemp("pipeline"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = pipeline_drive.main(["--root", root, "--steps", "2", "--n-videos", "4",
                                   "--bs", "2", "-device", "cpu"])
    return out, printed.getvalue().splitlines()


def test_drive_writes_every_artifact(drive):
    out, lines = drive
    assert lines[-1] == "PIPELINE OK"
    assert lines[-2] == str({k: str(v) for k, v in out.items() if k != "model"})
    for stage, files in (("stage1", ("config_stage1.yaml", "best_PFVD_GEN.msgpack",
                                     "best_PFVD_ENC.msgpack")),
                         ("ae", ("config_stage2_AE.yaml", "Encoder_stage2.msgpack")),
                         ("stage2", ("config_stage2.yaml", "cINN.msgpack",
                                     "cINN_latest.msgpack"))):
        for f in files:
            assert os.path.exists(os.path.join(out[stage], f)), (stage, f)
    assert os.path.getsize(out["gif"]) > 0
    assert out["eval"] == {}  # no backbone weights: the protocol runs, nothing is scored
    assert out["video_shape"] == (2, 8, 3, 32, 32)
    assert set(out["seconds"]) == {"data", "stage1", "ae", "stage2", "generate", "eval",
                                   "model"}


def test_jax_model_reads_the_port_trained_dirs(drive):
    s2 = drive[0]["stage2"] + "/"
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    residual = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(JaxModel(s2, vid_length=8, use_pallas=False).forward(x0,
                                                                           residual=residual))
    got = Model(s2, vid_length=8, use_kernel=False, device="cpu").forward(
        x0, residual=residual).numpy()
    assert got.shape == want.shape == (2, 8, 3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_make_bair_data_dir_writes_the_jax_files(tmp_path):
    kw = dict(n_videos=2, img=32, modes=("train", "test"))
    a = jtesting.make_bair_data_dir(str(tmp_path / "jax") + "/", **kw)
    b = ttesting.make_bair_data_dir(str(tmp_path / "port") + "/", **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 2 * 2 * 31  # 30 frames and the positions a clip
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert (mismatch, errors) == ([], [])


@pytest.mark.parametrize("preset", sorted(ttesting.PRESETS))
def test_trainer_configs_match_jax(preset):
    p, jp = ttesting.PRESETS[preset], jtesting.PRESETS[preset]
    assert p == jp
    assert ttesting.stage1_config(p).to_dict() == jtesting.stage1_config(jp).to_dict()
    assert ttesting.stage2_ae_config(p).to_dict() == jtesting.stage2_ae_config(jp).to_dict()
    for control in (False, True):
        assert (ttesting.stage2_config(p, "/r/s1/", "/r/ae", control).to_dict()
                == jtesting.stage2_config(jp, "/r/s1/", "/r/ae", control).to_dict())


def test_write_gif_without_imageio(tmp_path, monkeypatch):
    """The card's machine has PIL and no imageio: the generate CLI's GIF is
    PIL's there, frame for frame (8 colours, so the palette is exact)."""
    import sys

    from PIL import Image, ImageSequence

    from image2video_synthesis_using_cinns_tpu_torch.utils.video import write_gif

    monkeypatch.setitem(sys.modules, "imageio", None)  # import imageio raises ImportError
    rng = np.random.default_rng(5)
    colours = rng.integers(0, 256, (8, 3))
    frames = colours[rng.integers(0, 8, (4, 16, 24))].astype(np.float64)
    path = str(tmp_path / "results.gif")
    write_gif(path, frames, fps=3)
    with Image.open(path) as gif:
        got = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)])
        assert gif.info["loop"] == 0 and gif.info["duration"] == 330  # 1000 / 3, in 10 ms steps
    np.testing.assert_array_equal(got, frames.astype(np.uint8))
