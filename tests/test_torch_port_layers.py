"""The torch port's layers, norms, resizes and decoder against the JAX
package, on the CPU. The JAX modules make the weights (spectral state
included); the weight bridge carries them to the port. Inputs come from
numpy; channels-last arrays are moved to channels-first for the port.

Tolerance 1e-5 (fp32, only the order of sums differs) for the layers; the
whole decoder stacks six residual blocks of convs and norms, and is held
to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models import layers as jl
from image2video_synthesis_using_cinns_tpu.models.stage1 import decoder as jdec
from image2video_synthesis_using_cinns_tpu.models.stage1 import normalization as jnorm
from image2video_synthesis_using_cinns_tpu.ops import norms as jnorms
from image2video_synthesis_using_cinns_tpu.ops import resize as jresize
from image2video_synthesis_using_cinns_tpu_torch.models import layers as tl
from image2video_synthesis_using_cinns_tpu_torch.models.stage1 import decoder as tdec
from image2video_synthesis_using_cinns_tpu_torch.models.stage1 import normalization as tnorm
from image2video_synthesis_using_cinns_tpu_torch.ops import norms as tnorms
from image2video_synthesis_using_cinns_tpu_torch.ops import resize as tresize
from image2video_synthesis_using_cinns_tpu_torch.ops import spectral as tspectral
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_stage1_step import two_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _cf(a):
    """channels-last numpy -> channels-first torch."""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    """channels-first torch -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _init(module, *args):
    return jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.PRNGKey(3), *args))


def _numpy_init(module, *args, seed=0):
    """Variables of ``module`` drawn with numpy (no XLA compile of ``init``):
    kernels U(+-1/sqrt(fan_in)), unit-norm spectral u/v as the JAX init
    draws them, GroupNorm scales near 1, small biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("u", "v"):
            a = rng.standard_normal(s.shape)
            a /= np.linalg.norm(a)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(s.dtype)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(port, variables):
    port.load_state_dict(to_state_dict(variables))
    return port.eval()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("rank,spectral,stride,padding,bias", [
    (2, False, 1, 1, True),
    (2, True, 2, 3, False),
    (3, False, 1, 1, True),
    (3, True, 1, 1, True),
    (3, True, 1, 0, False),
])
def test_snconv(rank, spectral, stride, padding, bias):
    k = (3,) * rank if padding else (1,) * rank
    if padding == 3:
        k = (7,) * rank
    jm = jl.SNConv(6, k, strides=(stride,) * rank, padding=(padding,) * rank,
                   use_bias=bias, use_spectral=spectral)
    x = _rand(2, *([6] * rank), 5) if rank == 3 else _rand(2, 9, 9, 5)
    v = _init(jm, jnp.asarray(x))
    assert ("spectral" in v) == spectral
    port = _load(tl.SNConv(5, 6, k, stride, padding, bias), v)
    with torch.no_grad():
        y = port(_cf(x))
    np.testing.assert_allclose(_cl(y), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("spectral", [False, True])
def test_sndense(spectral):
    jm = jl.SNDense(7, use_spectral=spectral)
    x = _rand(3, 5)
    v = _init(jm, jnp.asarray(x))
    port = _load(tl.SNDense(5, 7), v)
    with torch.no_grad():
        y = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_spectral_fold_divides_by_stored_sigma():
    w = torch.from_numpy(_rand(4, 3, 2, 2))
    u = torch.from_numpy(_rand(4, seed=1))
    v = torch.from_numpy(_rand(12, seed=2))
    sigma = float(u @ w.reshape(4, -1) @ v)
    torch.testing.assert_close(tspectral.fold(w, u, v), w / sigma)
    assert tspectral.kernel_to_matrix(w).shape == (4, 12)


@pytest.mark.parametrize("affine,groups", [(True, 4), (False, 16)])
def test_group_norm(affine, groups):
    jm = jl.GroupNorm(num_groups=groups, use_affine=affine)
    x = 3.0 + 2.0 * _rand(2, 3, 4, 4, 32)
    v = _init(jm, jnp.asarray(x))
    if affine:  # non-trivial affine parameters
        v["params"]["scale"] = _rand(32, seed=1)
        v["params"]["bias"] = _rand(32, seed=2)
    port = tl.GroupNorm(32, groups, affine=affine)
    if affine:
        _load(port, v)
    with torch.no_grad():
        y = port(_cf(x))
    np.testing.assert_allclose(_cl(y), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (2, 3, 4, 5, 6)])
def test_instance_norm(shape):
    x = 1.5 + _rand(*shape)
    np.testing.assert_allclose(_cl(tnorms.instance_norm(_cf(x))),
                               np.asarray(jnorms.instance_norm(jnp.asarray(x))), **TOL)
    assert tnorms.group_norm_groups(48, 16) == jnorms.group_norm_groups(48, 16) == 16
    assert tnorms.group_norm_groups(20, 16) == jnorms.group_norm_groups(20, 16) == 10


@pytest.mark.parametrize("factors", [(2, 2, 2), (2, 1, 1), (1, 2, 2), (1, 1, 1)])
def test_upsample_nearest(factors):
    x = _rand(2, 3, 4, 5, 6)
    ref = jresize.upsample_nearest(jnp.asarray(x), factors, (1, 2, 3))
    np.testing.assert_array_equal(_cl(tresize.upsample_nearest(_cf(x), factors)), np.asarray(ref))


@pytest.mark.parametrize("size", [(4, 4), (16, 16), (7, 11), (1, 1), (32, 32)])
def test_resize_bilinear_align_corners(size):
    x = _rand(2, 32, 32, 3)
    ref = jresize.resize_bilinear_align_corners(jnp.asarray(x), size)
    out = tresize.resize_bilinear_align_corners(_cf(x), size)
    np.testing.assert_allclose(_cl(out), np.asarray(ref), **TOL)


def test_spade():
    jm = jnorm.Spade(32)
    x, img = _rand(2, 3, 8, 8, 32), np.tanh(_rand(2, 16, 16, 3, seed=1))
    v = _init(jm, jnp.asarray(x), jnp.asarray(img))
    port = _load(tnorm.Spade(32), v)
    with torch.no_grad():
        y = port(_cf(x), _cf(img))
    np.testing.assert_allclose(_cl(y), np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(img))),
                               **TOL)


def test_adain():
    jm = jnorm.ADAIN(24)
    x, z = _rand(2, 3, 4, 4, 24), _rand(2, 10, seed=1)
    v = _init(jm, jnp.asarray(x), jnp.asarray(z))
    port = _load(tnorm.ADAIN(24, 10), v)
    with torch.no_grad():
        y = port(_cf(x), torch.from_numpy(z))
    np.testing.assert_allclose(_cl(y), np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(z))),
                               **TOL)


def test_norm3d():
    jm = jnorm.Norm3D(32)
    x = _rand(2, 3, 4, 4, 32)
    v = _init(jm, jnp.asarray(x))
    v["params"]["bn"] = {"scale": _rand(32, seed=1), "bias": _rand(32, seed=2)}
    port = _load(tnorm.Norm3D(32), v)
    with torch.no_grad():
        y = port(_cf(x))
    np.testing.assert_allclose(_cl(y), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_leaky_relu_and_max_pool():
    x = _rand(2, 9, 9, 4)
    np.testing.assert_array_equal(_cl(tl.leaky_relu(_cf(x), 0.2)),
                                  np.asarray(jl.leaky_relu(jnp.asarray(x), 0.2)))
    ref = jl.max_pool(jnp.asarray(x), (3, 3), (2, 2), (1, 1))
    np.testing.assert_array_equal(_cl(tl.max_pool(_cf(x), 3, 2, 1)), np.asarray(ref))


def test_generator_tiny():
    cfg = {"channel_factor": 8, "z_dim": 8, "upsample_s": [1, 2], "upsample_t": [2, 1],
           "spectral_norm": True}
    jm = jdec.Generator.from_config(cfg)
    img, z = np.tanh(_rand(1, 32, 32, 3)), _rand(1, 8, seed=1)
    v = _numpy_init(jm, jnp.asarray(img), jnp.asarray(z))
    port = _load(tdec.Generator.from_config(cfg), v)
    with torch.no_grad():
        y = port(_cf(img), torch.from_numpy(z))
    assert port.base_frames == 16 and tuple(y.shape) == (1, 3, 16, 64, 64)
    np.testing.assert_allclose(_cl(y), np.asarray(jax.jit(jm.apply)(v, img, z)),
                               rtol=1e-4, atol=1e-4)
