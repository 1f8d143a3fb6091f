"""The torch port's motion transfer against the JAX package's, on the CPU.

Both load the same checkpoint directory (``make_model_dir(preset='tiny')``)
and get the same query video and start frames. Transfer encodes the query's
motion as the encoder's posterior mean (the JAX facade takes the encoder's
second output, ``facade.py:398``), so the eps each side draws from its own
random stream does not reach the video, and the two must agree with no noise
injected. The port also reproduces the JAX package's fixed-seed snapshot
``tests/golden/tiny_transfer_v1.npz``, which it only reads, and the full
landscape preset (BatchNorm ResNet-50 embedder, resnet18 3-D encoder) builds
with the JAX modules' variable layout.

Tolerances, as the sampling test's: 1e-4 for the plain fp32 path; with
``use_kernel`` / ``use_pallas`` both flows stream bf16 weights and a sum
taken in another order can round a bf16 activation the other way, so 2e-3;
the snapshot is stored in fp16 and keeps its own test's 2e-2. The round trip
(flow forward then inverse under the query's own first frame) gives back the
encoder's mean to 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
from image2video_synthesis_using_cinns_tpu.models.stage2.resnet2d import ResnetEncoder as JRE
from image2video_synthesis_using_cinns_tpu.testing import PRESETS as JAX_PRESETS
from image2video_synthesis_using_cinns_tpu.testing import (
    stage1_config,
    stage2_ae_config,
)
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.layers import BatchNorm
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import BasicBlock3D
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel
from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_transfer_v1.npz")
SEED = 7  # the facade seed of the golden snapshot


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    # seed 1234: the checkpoint the golden snapshot was taken from
    return make_model_dir(str(tmp_path_factory.mktemp("ckpts")), preset="tiny", seed=1234) + "/"


def _inputs(n=2, seed=43):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (1, 9, 3, 32, 32)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (n, 3, 32, 32)).astype(np.float32)
    return q, x0


@pytest.mark.parametrize("vid_length", [8, 20])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_transfer_matches_jax(model_dir, vid_length, use_kernel):
    q, x0 = _inputs(seed=5)
    ref = np.asarray(JaxModel(model_dir, vid_length=vid_length, transfer=True, seed=SEED,
                              use_pallas=use_kernel).transfer(q, x0))
    port = Model(model_dir, vid_length=vid_length, transfer=True, use_kernel=use_kernel,
                 device="cpu")
    before = dict(flow_kernel.launches)
    vid = port.transfer(q, x0).numpy()
    assert flow_kernel.launches == before  # the CPU path runs the plain versions
    assert vid.shape == ref.shape == (2, vid_length, 3, 32, 32)
    tol = 2e-3 if use_kernel else 1e-4
    np.testing.assert_allclose(vid, ref, rtol=tol, atol=tol)


def test_golden_transfer_snapshot(model_dir):
    """Fixed-seed snapshot (seed 1234, facade seed 7, rng 43) of the JAX package, read only."""
    assert os.path.exists(GOLDEN), "tests/golden/tiny_transfer_v1.npz is missing"
    q, x0 = _inputs(seed=43)
    vid = Model(model_dir, vid_length=8, transfer=True, seed=SEED, use_kernel=False,
                device="cpu").transfer(q, x0).numpy()
    ref = np.load(GOLDEN)["vid"].astype(np.float32)
    assert vid.shape == ref.shape
    np.testing.assert_allclose(vid, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_transfer_round_trip(model_dir, use_kernel):
    """Under the query's own first frame, the flow's inverse undoes its forward:
    z_ref is the encoder's mean of the query."""
    q, _ = _inputs(seed=6)
    port = Model(model_dir, vid_length=8, transfer=True, use_kernel=use_kernel, device="cpu")
    _, z_ref = port.transfer_sample(q, q[:, 0])
    with torch.no_grad():
        _, mu, _ = port.encoder(torch.from_numpy(q[:, 1:]).permute(0, 2, 1, 3, 4),
                                torch.Generator())
    assert z_ref.shape == (1, 16)
    torch.testing.assert_close(z_ref, mu, rtol=1e-4, atol=1e-4)


def test_transfer_does_not_depend_on_the_seed(model_dir):
    """The eps the encoder draws from the model's generator does not reach the
    video: two seeds give the same transfer, in [-1, 1]."""
    q, x0 = _inputs()
    vid_a, z_a = Model(model_dir, vid_length=8, transfer=True, seed=5,
                       device="cpu").transfer_sample(q, x0)
    vid_b, z_b = Model(model_dir, vid_length=8, transfer=True, seed=6,
                       device="cpu").transfer_sample(q, x0)
    torch.testing.assert_close(vid_a, vid_b, rtol=0, atol=0)
    torch.testing.assert_close(z_a, z_b, rtol=0, atol=0)
    assert vid_a.shape == (2, 8, 3, 32, 32) and vid_a.abs().max() <= 1.0


def test_transfer_needs_the_encoder_and_one_query(model_dir):
    q, x0 = _inputs()
    with pytest.raises(RuntimeError, match="transfer=True"):
        Model(model_dir, vid_length=8, device="cpu").transfer(q, x0)
    with pytest.raises(ValueError, match="one query video"):
        Model(model_dir, vid_length=8, transfer=True, device="cpu").transfer(
            np.concatenate([q, q]), x0)


def test_missing_encoder_checkpoint_raises(tmp_path, model_dir):
    import shutil

    root = os.path.dirname(model_dir.rstrip("/"))
    d = tmp_path / "copy"
    shutil.copytree(root, d)
    os.remove(d / "stage1" / "best_PFVD_ENC.msgpack")
    cfg = d / "stage2" / "config_stage2.yaml"
    cfg.write_text(cfg.read_text().replace(root, str(d)))
    Model(str(d / "stage2") + "/", vid_length=8, device="cpu")  # sampling needs no encoder
    with pytest.raises(FileNotFoundError, match="encoder"):
        Model(str(d / "stage2") + "/", vid_length=8, transfer=True, device="cpu")
    q, x0 = _inputs()
    vid = Model(str(d / "stage2") + "/", vid_length=8, transfer=True, allow_random_init=True,
                device="cpu").transfer(q, x0)
    assert vid.shape == (2, 8, 3, 32, 32) and torch.isfinite(vid).all()


def _zeros_like_jax(module, *args) -> dict:
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_landscape_preset_builds_with_the_jax_layout():
    """The full landscape preset builds on the CPU (no forward at this size),
    and its encoder and BatchNorm embedder take the JAX modules' variables,
    every key and shape (strict load)."""
    p = PRESETS["landscape"]
    model = build_model("landscape", transfer=True, device="cpu")
    assert isinstance(model.flow.embedder.model.bn1.bn, BatchNorm)
    assert isinstance(model.encoder.backbone.layer0_block0, BasicBlock3D)
    assert model.flow.flow.packed.E == p["cond_z"] == 128
    jp = JAX_PRESETS["landscape"]
    img = jax.ShapeDtypeStruct((1, p["img_size"], p["img_size"], 3), np.float32)
    clip = jax.ShapeDtypeStruct((1, p["seq_length"] - 1, p["img_size"], p["img_size"], 3),
                                np.float32)
    enc_vars = _zeros_like_jax(JEncoder.from_config(stage1_config(jp).Encoder), clip,
                               jax.random.PRNGKey(0))
    model.encoder.load_state_dict(to_state_dict(enc_vars))
    emb_vars = _zeros_like_jax(JRE.from_config(stage2_ae_config(jp).AE), img)
    assert "batch_stats" in emb_vars
    model.flow.embedder.load_state_dict(to_state_dict(emb_vars))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_match_jax(preset):
    """Every field of the port's preset is the JAX package's."""
    ours, theirs = PRESETS[preset], JAX_PRESETS[preset]
    assert {k: theirs[k] for k in ours} == ours
