"""The torch port's sampling ``Model`` against the JAX package's, on the CPU.

Both load the same checkpoint directory (``make_model_dir(preset='tiny')``)
and get the same x0 and residual nu, so their videos must agree. The port
also reproduces the JAX package's fixed-seed snapshot
``tests/golden/tiny_sample_v1.npz``, which it only reads.

Tolerances: 1e-4 for the fp32 path (the flow and decoder agree to rounding,
amplified through six residual conv blocks); with ``use_kernel`` /
``use_pallas`` the flow streams bf16 weights on both sides and a sum taken
in another order can round a bf16 activation the other way, so 2e-3; the
snapshot is stored in fp16 and keeps its own test's 2e-2.
"""

import os

import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model, resolve_device
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_sample_v1.npz")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    # seed 1234: the checkpoint the golden snapshot was taken from
    return make_model_dir(str(tmp_path_factory.mktemp("ckpts")), preset="tiny", seed=1234) + "/"


def _inputs(b=2, seed=42):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (b, 3, 32, 32)).astype(np.float32)
    residual = rng.standard_normal((b, 16)).astype(np.float32)
    return x0, residual


@pytest.mark.parametrize("vid_length", [8, 20])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(model_dir, vid_length, use_kernel):
    x0, residual = _inputs(seed=7)
    ref = np.asarray(JaxModel(model_dir, vid_length=vid_length, use_pallas=use_kernel)
                     .forward(x0, residual=residual))
    port = Model(model_dir, vid_length=vid_length, use_kernel=use_kernel, device="cpu")
    before = dict(flow_kernel.launches)
    vid = port.forward(x0, residual=residual).numpy()
    assert flow_kernel.launches == before  # the CPU path runs the plain version
    assert vid.shape == ref.shape == (2, vid_length, 3, 32, 32)
    tol = 2e-3 if use_kernel else 1e-4
    np.testing.assert_allclose(vid, ref, rtol=tol, atol=tol)


def test_golden_snapshot(model_dir):
    """Fixed-seed snapshot (seed 1234, rng 42) of the JAX package, read only."""
    assert os.path.exists(GOLDEN), "tests/golden/tiny_sample_v1.npz is missing"
    x0, residual = _inputs(seed=42)
    vid = Model(model_dir, vid_length=8, use_kernel=False, device="cpu").forward(
        x0, residual=residual).numpy()
    ref = np.load(GOLDEN)["vid"].astype(np.float32)
    assert vid.shape == ref.shape
    np.testing.assert_allclose(vid, ref, rtol=2e-2, atol=2e-2)


def test_sample_draws_and_bf16_decoder(model_dir):
    x0, _ = _inputs()
    a = Model(model_dir, vid_length=8, seed=5, device="cpu")
    b = Model(model_dir, vid_length=8, seed=5, device="cpu")
    vid_a, z_a = a.sample(x0)
    vid_b, z_b = b.sample(x0)
    torch.testing.assert_close(vid_a, vid_b, rtol=0, atol=0)  # same seed, same draw
    assert z_a.shape == (2, 16) and vid_a.abs().max() <= 1.0
    # the residual drawn by the sampler is the model's generator stream
    c = Model(model_dir, vid_length=8, seed=5, device="cpu")
    vid_c = c.forward(x0, residual=c.draw_residual(2))
    torch.testing.assert_close(vid_c, vid_a, rtol=0, atol=0)
    # bf16 decoder, fp32 flow: the same z, and the video to bf16 precision;
    # a random-weight decoder with spectral norm amplifies bf16 rounding in a
    # few pixels, so the bound is on the mean difference
    bf = Model(model_dir, vid_length=8, seed=5, compute_dtype="bfloat16", device="cpu")
    vid_bf, z_bf = bf.sample(x0)
    assert vid_bf.dtype == torch.float32
    torch.testing.assert_close(z_bf, z_a, rtol=0, atol=0)
    assert (vid_bf - vid_a).abs().mean() < 2e-2


def test_device_resolution():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_missing_checkpoints_raise(tmp_path, model_dir):
    import shutil

    d = tmp_path / "copy"
    shutil.copytree(os.path.dirname(model_dir.rstrip("/")), d)
    os.remove(d / "stage2" / "cINN.msgpack")
    cfg_text = (d / "stage2" / "config_stage2.yaml").read_text()
    (d / "stage2" / "config_stage2.yaml").write_text(
        cfg_text.replace(os.path.dirname(model_dir.rstrip("/")), str(d)))
    with pytest.raises(FileNotFoundError):
        Model(str(d / "stage2") + "/", vid_length=8, device="cpu")
    vid = Model(str(d / "stage2") + "/", vid_length=8, allow_random_init=True, device="cpu")(
        _inputs()[0])
    assert vid.shape == (2, 8, 3, 32, 32) and torch.isfinite(vid).all()
