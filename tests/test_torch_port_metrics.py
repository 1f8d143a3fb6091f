"""The port's metric backbones and Fréchet distance against the JAX package,
on the CPU.

Each backbone's variables come from the JAX module's own init, redrawn from a
numpy seed so that activations stay of order one through the depth (conv
kernels ~ N(0, 2 / fan_in)) and the frozen BN is not the identity (means,
variances, scales and biases drawn too, variances down to 0.01 so that the
1e-3 / 1e-5 eps choice shows). They reach the port through the weight bridge
(``utils/convert.py``). Tolerances, relative to the largest output
magnitude: 1e-4 for the deep nets (I3D, Inception: fp32 sums in another
order through 60 to 100 layers), 1e-5 for VGG16 and LPIPS at 64 px, 1e-10
for the float64 Fréchet distance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.metrics import fvd as jfvd
from image2video_synthesis_using_cinns_tpu.metrics.frechet import (
    frechet_from_activations as jfrechet,
)
from image2video_synthesis_using_cinns_tpu.metrics.inception import InceptionV3FID as JInception
from image2video_synthesis_using_cinns_tpu.models.backbones import i3d as ji3d
from image2video_synthesis_using_cinns_tpu.models.backbones.lpips import LPIPS as JLPIPS
from image2video_synthesis_using_cinns_tpu.models.backbones.vgg16 import (
    VGG16Features as JVGG,
)
from image2video_synthesis_using_cinns_tpu.utils import checkpoint as jckpt
from image2video_synthesis_using_cinns_tpu_torch.metrics import fid as tfid
from image2video_synthesis_using_cinns_tpu_torch.metrics import fvd as tfvd
from image2video_synthesis_using_cinns_tpu_torch.metrics import lpips_eval as tlpips
from image2video_synthesis_using_cinns_tpu_torch.metrics.frechet import (
    frechet_from_activations as tfrechet,
)
from image2video_synthesis_using_cinns_tpu_torch.metrics.inception import InceptionV3FID
from image2video_synthesis_using_cinns_tpu_torch.models.backbones import i3d as ti3d
from image2video_synthesis_using_cinns_tpu_torch.models.backbones.lpips import LPIPS
from image2video_synthesis_using_cinns_tpu_torch.models.backbones.vgg16 import VGG16Features
from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as tckpt
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

DEEP_TOL = 1e-4
VGG_TOL = 1e-5


def _redraw(variables, seed: int):
    """Same tree, leaves redrawn from numpy: conv kernels N(0, 2/fan_in),
    biases N(0, 0.05), frozen BN means N(0, 0.1), variances U(0.01, 1.5),
    scales U(0.8, 1.2), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            shape = np.shape(v)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif k == "bn_var":
                a = rng.uniform(0.01, 1.5, shape)
            elif k == "bn_scale":
                a = rng.uniform(0.8, 1.2, shape)
            elif k in ("bn_mean", "bn_bias"):
                a = rng.standard_normal(shape) * 0.1
            else:
                a = rng.standard_normal(shape) * 0.05
            out[k] = a.astype(np.float32)
        return out

    return walk(jax.device_get(variables))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _port(module, variables):
    module.load_state_dict(convert.to_state_dict(variables))
    return module.eval()


@pytest.mark.parametrize("kind", ["kinetics", "dt16"])
def test_i3d_activations_match_jax(kind):
    """The FVD activation program at the BAIR eval shape: one 16-frame 64 px
    clip in [-1, 1], resized to 224 with align-corners sampling and
    denormalised inside, so each I3D runs at 1x16x224x224 (DT-16: tiled x3 and
    cut to 16 frames first)."""
    module = tfvd.build(kind)
    jmod = {"kinetics": ji3d.I3D(num_classes=400, head="logits"),
            "dt16": ji3d.I3D(num_classes=18, head="representation", avg_pool_t=2,
                             bn_eps=1e-5)}[kind]
    x224 = jnp.zeros((1, 16, 224, 224, 3))
    variables = _redraw(jax.jit(jmod.init)({"params": jax.random.PRNGKey(0)}, x224), seed=1)
    rng = np.random.default_rng(2)
    clip = rng.uniform(-1, 1, (1, 16, 3, 64, 64)).astype(np.float32)  # (B, T, C, H, W)
    if kind == "dt16":
        clip = clip[:, :7]  # prep_dt_time tiles 7 frames x3 and keeps 16
        want_in = jfvd.prep_dt_time(jnp.asarray(np.moveaxis(clip, 2, -1)), 16)
        got_in = tfvd.prep_dt_time(torch.from_numpy(clip), 16)
    else:
        want_in = jnp.asarray(np.moveaxis(clip, 2, -1))
        got_in = torch.from_numpy(clip)
    want = jfvd.activation_fn(jfvd.I3DModel(jmod, variables, kind))(variables, want_in)
    got = tfvd.activation_fn(tfvd.I3DModel(_port(module, variables), kind))(got_in)
    assert got.shape == want.shape == ((1, 400) if kind == "kinetics" else (1, 1024))
    assert np.abs(np.asarray(want)).max() > 1e-2  # activations of order one, not vanished
    assert _rel_err(got.numpy(), want) < DEEP_TOL


def test_inception_matches_jax():
    """InceptionV3 at 2x64x64 (resized to 299 inside: an upsample)."""
    jmod = JInception()
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = _redraw(jax.jit(jmod.init)({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, 64, 64, 3))), seed=4)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(InceptionV3FID(), variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 2048)
    assert _rel_err(got.numpy(), want) < DEEP_TOL


def test_vgg16_taps_and_lpips_match_jax():
    """VGG16's five relu taps and LPIPS at 64 px, with the JAX LPIPS's
    variables (its ``net`` subtree is the VGG16's)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    jl = JLPIPS()
    lv = _redraw(jax.jit(jl.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(a),
                                  jnp.asarray(a)), seed=6)
    # the LPIPS heads must stay non-negative weights, as trained ones are
    for k in range(5):
        lv["params"][f"lin{k}"]["kernel"] = np.abs(lv["params"][f"lin{k}"]["kernel"])
    vv = {"params": lv["params"]["net"]}
    want_taps = jax.jit(JVGG().apply)(vv, jnp.asarray(a))
    want = jax.jit(jl.apply)(lv, jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, b))
    with torch.no_grad():
        taps = _port(VGG16Features(), vv)(ta)
        lp = _port(LPIPS(), lv)
        got, same = lp(ta, tb), lp(ta, ta)
    for t, w in zip(taps, want_taps):
        assert _rel_err(t.permute(0, 2, 3, 1).numpy(), w) < VGG_TOL
    assert got.shape == (2,) and _rel_err(got.numpy(), want) < VGG_TOL
    assert float(same.abs().max()) == 0.0


def test_frechet_matches_jax():
    rng = np.random.default_rng(7)
    d = 48
    a1 = rng.standard_normal((120, d)) @ rng.standard_normal((d, d)) * 0.5
    a2 = a1 + rng.standard_normal((120, d)) * 0.3 + 0.7
    for x, y in ((a1, a2), (a1.astype(np.float32), a2[:40].astype(np.float32)), (a1, a1)):
        want = jfrechet(x, y)
        np.testing.assert_allclose(tfrechet(x, y), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("size", [1, 2, 5, 7, 8, 13, 112, 224])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (2, 2), (7, 2), (4, 3)])
def test_tf_same_pads_match_jax(size, kernel, stride):
    assert ti3d.tf_same_pads(size, kernel, stride) == ji3d._tf_same_pads(size, kernel, stride)


@pytest.mark.parametrize("kernel,stride", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                                           ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (2, 2, 2))])
def test_max_pool_same_pads_with_zeros(kernel, stride):
    """All-negative inputs: the JAX pool pads with zeros, which win at the
    padded border; the port must do the same, unlike F.max_pool3d's -inf."""
    x = -np.random.default_rng(8).uniform(0.5, 1.0, (1, 5, 7, 6, 2)).astype(np.float32)
    want = np.asarray(ji3d.max_pool_same(jnp.asarray(x), kernel, stride))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = ti3d.max_pool_same(xt, kernel, stride).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and (want < 0).any()  # both the border zeros and inner maxima


def test_bridge_round_trips_backbone_weights(tmp_path):
    """to_variables inverts to_state_dict on every backbone; a tree written by
    the port's save loads strictly through load_checkpoint into a fresh module."""
    for make in (lambda: tfvd.build("kinetics"), lambda: tfvd.build("dt32"), InceptionV3FID,
                 LPIPS, VGG16Features):
        torch.manual_seed(0)
        sd = make().state_dict()
        back = convert.to_state_dict(convert.to_variables(sd))
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    path = str(tmp_path / "inc.msgpack")
    tckpt.save(path, {"state_dict": convert.to_variables(sd)})
    fresh = convert.load_checkpoint(VGG16Features(), path)
    assert all(torch.equal(fresh.state_dict()[k], sd[k]) for k in sd)


def test_loaders_read_jax_written_weights_and_raise_without(tmp_path):
    """load_model / load_inception raise FileNotFoundError without weights, as
    in JAX; with a JAX-written variables tree in the JAX package's layout they
    load it strictly. load_lpips falls back to its seeded random init."""
    root = str(tmp_path / "models")
    for kind in ("kinetics", "dt16", "dt32"):
        with pytest.raises(FileNotFoundError):
            tfvd.load_model(kind, root, device="cpu")
    with pytest.raises(FileNotFoundError):
        tfid.load_inception(root, device="cpu")
    a, b = tlpips.load_lpips(root, device="cpu"), tlpips.load_lpips(root, device="cpu")
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())

    torch.manual_seed(1)
    sd = tfvd.build("dt16").state_dict()
    path = tmp_path / "models" / "DTI3D" / "length16"
    path.mkdir(parents=True)
    jckpt.save(str(path / "I3D_16.msgpack"), {"state_dict": convert.to_variables(sd)})
    model = tfvd.load_model("dt16", root, device="cpu")
    assert model.kind == "dt16" and not model.module.training
    assert all(torch.equal(model.module.state_dict()[k], sd[k]) for k in sd)
