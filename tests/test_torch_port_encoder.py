"""The torch port's dynamics encoder and the norms the transfer path adds,
against the JAX package on the CPU: ``BatchNorm`` (eval mode, running
statistics), ``ActNormImage`` at inference and the 3-D max pool; the stage-1
``Encoder`` (resnet18 basic blocks and resnet50 bottlenecks, the stem's max
pool on and off) at a tiny size. Variables are drawn with numpy into the JAX
modules' shapes (no XLA compile of ``init``) and carried to the port by the
weight bridge; the encoder's eps is the JAX module's own draw, given to the
port as ``noise``.

Tolerances: 1e-5 for the single layers (fp32, only the order of sums
differs); 1e-4 for the encoder's mu, logvar and sample (a resnet50 stacks 50
3-D convs with group norms between them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models import layers as jl
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
from image2video_synthesis_using_cinns_tpu.ops.spectral import kernel_to_matrix
from image2video_synthesis_using_cinns_tpu_torch.models import layers as tl
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Encoder
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _singular_vectors(params: dict, spectral: dict) -> dict:
    """Spectral u/v set to each kernel's top singular pair, as a trained
    checkpoint's converged power iteration holds them (random unit vectors
    would give sigma near 0 and amplify rounding by its inverse)."""
    out = {}
    for name, sub in spectral.items():
        if "u" in sub:
            m = np.asarray(kernel_to_matrix(jnp.asarray(params[name]["kernel"])))
            left, _, right = np.linalg.svd(m, full_matrices=False)
            out[name] = {"u": left[:, 0].astype(np.float32), "v": right[0].astype(np.float32)}
        else:
            out[name] = _singular_vectors(params[name], sub)
    return out


def _numpy_init(module, *args, seed=0, **kwargs):
    """Variables in ``module``'s shapes, drawn with numpy: kernels
    U(+-1/sqrt(fan_in)), spectral u/v their kernel's top singular pair, scales
    near 1, positive running variances, small other leaves."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(s.dtype)

    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    if "spectral" in variables:
        variables["spectral"] = _singular_vectors(variables["params"], variables["spectral"])
    return variables


def _cf(a):
    """channels-last numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 6, 16), (2, 3, 4, 5, 16)])
def test_batch_norm_eval(shape):
    x = _rand(*shape)
    jm = jl.BatchNorm()
    v = _numpy_init(jm, jnp.asarray(x))
    port = tl.BatchNorm(16).eval()
    port.load_state_dict(to_state_dict(v))
    ref = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        out = port(_cf(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, **LAYER_TOL)


@pytest.mark.parametrize("shape", [(2, 5, 6, 16), (2, 3, 4, 5, 16)])
def test_actnorm_image_inference(shape):
    x = _rand(*shape, seed=1)
    jm = jl.ActNormImage()
    v = _numpy_init(jm, jnp.asarray(x))
    assert set(v) == {"params", "actnorm_stats"}  # the bridge drops the init bookkeeping
    port = tl.ActNormImage(16).eval()
    port.load_state_dict(to_state_dict(v))
    ref = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        out = port(_cf(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, **LAYER_TOL)


def test_max_pool_3d():
    x = _rand(2, 5, 9, 8, 4, seed=2)
    ref = np.asarray(jl.max_pool(jnp.asarray(x), (3, 3, 3), (1, 2, 2), (1, 1, 1)))
    out = tl.max_pool(_cf(x), (3, 3, 3), (1, 2, 2), (1, 1, 1)).numpy()
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, **LAYER_TOL)


# (res_type, channels, stride_s, use_max_pool): each reduces 8 frames of 32 px
# to one step of 4x4 (a stage that strides in time must also change the width
# or stride in space, which gives it its downsample path). The resnet50 case
# takes the tiny preset's widths: at 16 wide a bottleneck's GroupNorm(16)
# normalises single channels of 16 values in the last stage, where fp32
# rounding alone moves logvar by most of the 1e-4 bound
ENCODERS = {
    "resnet18": ("resnet18", [16, 32, 32, 32, 32], [1, 2, 2, 1], False),
    "resnet18-maxpool": ("resnet18", [16, 16, 32, 64, 128], [1, 2, 1, 1], True),
    "resnet50": ("resnet50", [16, 32, 32, 32, 32], [1, 2, 2, 1], False),
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder(case):
    res_type, channels, stride_s, use_max_pool = ENCODERS[case]
    kw = dict(res_type_encoder=res_type, z_dim=8, channels=channels, stride_s=stride_s,
              stride_t=[1, 2, 2, 2], use_max_pool=use_max_pool)
    jm = JEncoder(**kw)
    video = np.tanh(_rand(2, 8, 32, 32, 3, seed=3))
    key = jax.random.PRNGKey(11)
    v = _numpy_init(jm, jnp.asarray(video), key)
    if res_type == "resnet50":  # blocks after a stage's first are spectral (reference quirk)
        assert "spectral" in v
    port = Encoder(**kw).eval()
    port.load_state_dict(to_state_dict(v))

    sample, mu, logvar = (np.asarray(a) for a in jax.jit(jm.apply)(v, video, key))
    eps = np.array(jax.random.normal(key, mu.shape))
    with torch.no_grad():
        t_sample, t_mu, t_logvar = port(_cf(video), noise=torch.from_numpy(eps))
    assert t_mu.shape == (2, 8)
    np.testing.assert_allclose(t_mu.numpy(), mu, **TOL)
    np.testing.assert_allclose(t_logvar.numpy(), logvar, **TOL)
    np.testing.assert_allclose(t_sample.numpy(), sample, **TOL)


def test_encoder_draws_from_its_generator():
    kw = dict(res_type_encoder="resnet18", z_dim=8, channels=[16, 32, 32, 32, 32],
              stride_s=[1, 2, 2, 1], stride_t=[1, 2, 2, 2])
    port = Encoder(**kw).eval()
    video = torch.from_numpy(np.tanh(_rand(2, 3, 8, 32, 32, seed=4)))
    with torch.no_grad():
        a, mu, logvar = port(video, torch.Generator().manual_seed(5))
        b, _, _ = port(video, torch.Generator().manual_seed(5))
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(5))
        c, _, _ = port(video, noise=eps)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert not torch.equal(a, mu)


def test_encoder_raises_unless_time_reduces_to_one():
    kw = dict(res_type_encoder="resnet18", z_dim=8, channels=[16, 16, 16, 16, 16],
              stride_s=[1, 2, 2, 1], stride_t=[1, 1, 1, 1])
    video = np.tanh(_rand(1, 4, 32, 32, 3, seed=6))  # stem 4 -> 2 steps, kept by the stages
    jm = JEncoder(**kw)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, jax.random.PRNGKey(1)),
                       jnp.asarray(video))
    with pytest.raises(ValueError, match="time steps"):
        Encoder(**kw)(_cf(video), noise=torch.zeros(1, 8))
