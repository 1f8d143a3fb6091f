"""The stage-2 AE's modules in the port against the JAX package, on the CPU,
at the reference's debug width (chn 8): 64 px (resnet18 'in' encoder, z 64)
and 128 px, where ``SelfAttention`` runs (resnet18 'bn' encoder, z 128).

Variables are drawn with numpy into the JAX modules' shapes (``ae_init``:
``test_torch_port_stage1_step.numpy_init``, the spectral vectors each
kernel's top singular pair, BatchNorm running variances in [0.5, 1.5],
``gamma`` of the attention non-zero) and carried over by the weight bridge
with the spectral vectors kept (``fold_spectral=False``).

Tolerances, each relative to the largest magnitude of the JAX output:

* a BigGAN-mode spectral layer (one power iteration from the stored random
  ``u`` with eps 1e-4, nothing written back, ``power_iteration_`` passing
  it by): sigma, the output and the weight's gradient, 1e-5;
* ``BatchNorm`` on batch statistics, with and without ``affine``, against
  ``use_running_average=False``, with the running statistics moved (against
  ``mutable=["batch_stats"]``) and not: outputs 1e-5, statistics 1e-6;
* each BigGAN module (``ClassUp``, ``ConditionalNorm2d`` with BatchNorm and
  ActNorm, ``SelfAttention``, ``GBlock``), in train and eval mode: 1e-5;
* ``VariableDimGenerator`` at 64 and 128 px and the whole ``BigAE``, in
  train and eval mode: 1e-4 (fp32 sums in another order through about 20
  layers, batch statistics of 2 images among them; measured up to 3.1e-5);
* the diagonal Gaussian's ``kl``, ``nll`` and ``sample``: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models import layers as jl
from image2video_synthesis_using_cinns_tpu.models.stage2 import biggan as jb
from image2video_synthesis_using_cinns_tpu.models.stage2.distributions import (
    DiagonalGaussianDistribution as JGauss,
)
from image2video_synthesis_using_cinns_tpu.ops.spectral import kernel_to_matrix, spectral_normalize
from image2video_synthesis_using_cinns_tpu_torch.models import layers as tl
from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import biggan as tb
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.distributions import (
    DiagonalGaussianDistribution as TGauss,
)
from image2video_synthesis_using_cinns_tpu_torch.ops import spectral as tsn
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_stage1_step import numpy_init, two_threads  # noqa: F401

AE64 = dict(deterministic=False, in_size=64, norm="in", encoder_type="resnet18",
            use_actnorm_in_dec=False, z_dim=64, chn=8)
AE128 = dict(AE64, in_size=128, norm="bn", z_dim=128)
TOL, WHOLE_TOL = 1e-5, 1e-4


def ae_init(module, *args, seed: int = 0) -> dict:
    """``numpy_init`` with BatchNorm running variances in [0.5, 1.5] and a
    non-zero attention ``gamma``."""
    v = numpy_init(module, *args, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def fix(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "gamma":
            return np.full(a.shape, 0.7, np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fix, v)


def to_port(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    module.load_state_dict(convert.to_state_dict(variables, fold_spectral=False))
    return module


def cf(a) -> torch.Tensor:
    """channels-last numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def close(got: torch.Tensor, want, tol: float = TOL, channels_last: bool = False) -> None:
    want = np.asarray(want)
    if channels_last:
        want = np.moveaxis(want, -1, 1)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _images(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


# -- the BigGAN spectral mode --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_biggan_spectral_layer(kind):
    rng = np.random.default_rng(3)
    if kind == "dense":
        jmod = jl.SNDense(12, use_bias=False, use_spectral=True, sn_eps=1e-4, sn_mode="biggan")
        x = rng.standard_normal((4, 20)).astype(np.float32)
        tmod = tl.SNDense(20, 12, bias=False, spectral=True, sn_mode="biggan")
        tx = torch.from_numpy(x)
    else:
        jmod = jl.SNConv(6, (3, 3), padding=(1, 1), use_spectral=True, sn_eps=1e-4,
                         sn_mode="biggan")
        x = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
        tmod = tl.SNConv(4, 6, (3, 3), padding=1, spectral=True, sn_mode="biggan")
        tx = cf(x)
    v = numpy_init(jmod, jnp.asarray(x), seed=4)
    # random stored vectors, so that the one iteration moves them
    for name in ("u", "v"):
        r = rng.standard_normal(v["spectral"][name].shape)
        v["spectral"][name] = (r / np.linalg.norm(r)).astype(np.float32)
    to_port(tmod, v)
    u0, v0 = tmod.u.clone(), tmod.v.clone()

    m = kernel_to_matrix(jnp.asarray(v["params"]["kernel"]))
    want_sigma, _, _ = spectral_normalize(m, jnp.asarray(v["spectral"]["u"]),
                                          jnp.asarray(v["spectral"]["v"]), update=True, eps=1e-4)
    got_sigma = tsn.biggan_sigma(tmod.weight, tmod.u, tl.BIGGAN_SN_EPS).detach()
    assert abs(float(got_sigma) - float(want_sigma)) <= TOL * abs(float(want_sigma))
    assert float(want_sigma) > 0

    r = rng.standard_normal(np.asarray(jmod.apply(v, jnp.asarray(x))).shape).astype(np.float32)

    def jloss(k):
        return jnp.sum(jmod.apply({**v, "params": {**v["params"], "kernel": k}},
                                  jnp.asarray(x)) * r)

    want_y = jmod.apply(v, jnp.asarray(x))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(v["params"]["kernel"])))
    y = tmod(tx)
    close(y, want_y, channels_last=kind == "conv")
    (g,) = torch.autograd.grad((y * (torch.from_numpy(r) if kind == "dense" else cf(r))).sum(),
                               tmod.weight)
    close(g, convert.torch_weight(want_g).numpy())
    # nothing written back, and the stage-1 refresh passes BigGAN layers by
    assert torch.equal(tmod.u, u0) and torch.equal(tmod.v, v0)
    tl.power_iteration_(tmod)
    assert torch.equal(tmod.u, u0) and torch.equal(tmod.v, v0)
    torch_mode = tl.SNDense(20, 12, spectral=True)
    u_before = torch_mode.u.clone()
    tl.power_iteration_(torch_mode)
    assert not torch.equal(torch_mode.u, u_before)


# -- train-mode BatchNorm ----------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_batch_statistics(affine):
    c = 8
    x = (np.random.default_rng(5).standard_normal((4, 5, 6, c)) * 2 + 0.5).astype(np.float32)
    jmod = jl.BatchNorm(use_affine=affine, eps=1e-4)
    v = ae_init(jmod, jnp.asarray(x), seed=6)
    tmod = to_port(tl.BatchNorm(c, eps=1e-4, affine=affine), v)
    mean0, var0 = tmod.mean.clone(), tmod.var.clone()

    want = jmod.apply(v, jnp.asarray(x), use_running_average=False)
    close(tmod(cf(x), train=True), want, channels_last=True)
    assert torch.equal(tmod.mean, mean0) and torch.equal(tmod.var, var0)

    want_u, mut = jmod.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
    with tl.updating_batch_stats(tmod):
        got = tmod(cf(x), train=True)
    close(got, want_u, channels_last=True)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tmod, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]), rtol=1e-6, atol=1e-6)
        assert not torch.equal(getattr(tmod, name), (mean0, var0)[name == "var"])
    assert not tmod.update_stats
    # outside the context, and in eval mode, the statistics stay
    tmod(cf(x), train=True)
    close(tmod(cf(x)), jmod.apply({**v, "batch_stats": mut["batch_stats"]}, jnp.asarray(x)),
          channels_last=True)
    np.testing.assert_allclose(tmod.var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


# -- the diagonal Gaussian ------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [False, True])
def test_diagonal_gaussian(deterministic):
    rng = np.random.default_rng(7)
    params = rng.standard_normal((3, 10)).astype(np.float32) * 3
    eps = rng.standard_normal((3, 5)).astype(np.float32)
    jp = JGauss.from_params(jnp.asarray(params), deterministic=deterministic)
    tp = TGauss.from_params(torch.from_numpy(params), deterministic=deterministic)
    for got, want in ((tp.kl(), jp.kl()), (tp.std, jp.std), (tp.var, jp.var),
                      (tp.nll(torch.from_numpy(eps)), jp.nll(jnp.asarray(eps))),
                      (tp.mode(), jp.mode())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tp.kl().shape == ()
    # the draw: mean + std * eps, eps drawn in fp32 and then cast
    np.testing.assert_allclose(tp.sample(eps=torch.from_numpy(eps)).numpy(),
                               np.asarray(jp.mean + jp.std * eps), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    tp64 = TGauss.from_params(torch.from_numpy(params).double(), deterministic=deterministic)
    s = tp64.sample(generator=g)
    assert s.dtype == torch.float64
    want64 = tp64.mean + tp64.std * torch.randn((3, 5), generator=torch.Generator().manual_seed(0),
                                                dtype=torch.float32).double()
    assert torch.equal(s, want64)


# -- the BigGAN modules ------------------------------------------------------------------------

def test_class_up():
    z = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)
    jmod = jb.ClassUp(64)
    v = ae_init(jmod, jnp.asarray(z), seed=9)
    close(to_port(tb.ClassUp(64), v)(torch.from_numpy(z)), jmod.apply(v, jnp.asarray(z)))


@pytest.mark.parametrize("use_actnorm", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_conditional_norm(use_actnorm, train):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((3, 4, 4, 16)) + 0.3).astype(np.float32)
    cond = rng.standard_normal((3, 138)).astype(np.float32)
    jmod = jb.ConditionalNorm2d(16, use_actnorm)
    v = ae_init(jmod, jnp.asarray(x), jnp.asarray(cond), seed=11)
    tmod = to_port(tb.ConditionalNorm2d(16, 138, use_actnorm), v)
    close(tmod(cf(x), torch.from_numpy(cond), train),
          jmod.apply(v, jnp.asarray(x), jnp.asarray(cond), train), channels_last=True)


def test_self_attention():
    x = np.random.default_rng(12).standard_normal((2, 8, 8, 32)).astype(np.float32)
    jmod = jb.SelfAttention(32)
    v = ae_init(jmod, jnp.asarray(x), seed=13)
    close(to_port(tb.SelfAttention(32), v)(cf(x)), jmod.apply(v, jnp.asarray(x)),
          channels_last=True)


@pytest.mark.parametrize("train", [True, False])
def test_gblock(train):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 138)).astype(np.float32)
    jmod = jb.GBlock(16, 8, 138)
    v = ae_init(jmod, jnp.asarray(x), jnp.asarray(cond), seed=15)
    tmod = to_port(tb.GBlock(16, 8, 138), v)
    close(tmod(cf(x), torch.from_numpy(cond), train),
          jmod.apply(v, jnp.asarray(x), jnp.asarray(cond), train), channels_last=True)


def _generator_case(size: int, z_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, z_dim)).astype(np.float32)
    emb = rng.uniform(0, 1, (2, 1000)).astype(np.float32)
    jmod = jb.VariableDimGenerator(size, z_dim, chn=8)
    v = ae_init(jmod, jnp.asarray(z), jnp.asarray(emb), seed=seed + 1)
    return z, emb, jmod, v, to_port(tb.VariableDimGenerator(size, z_dim, chn=8), v)


@pytest.mark.parametrize("size,z_dim", [(64, 64), (128, 128)])
def test_generator(size, z_dim):
    """``features`` and the image in train and eval mode; at 128 px through
    the attention (the 64 px generator builds none)."""
    z, emb, jmod, v, tmod = _generator_case(size, z_dim, 16)
    assert hasattr(tmod, "attention") == (size == 128) == ("attention" in v["params"])
    assert tmod.split == [z_dim - (40 if size == 64 else 100)] + [10 if size == 64 else 20] * (
        4 if size == 64 else 5)
    fn = jax.jit(lambda v, z, e, train: jmod.apply(v, z, e, train, method="features"),
                 static_argnums=3)
    for train in (True, False):
        h = tmod.features(torch.from_numpy(z), torch.from_numpy(emb), train)
        want_h = fn(v, jnp.asarray(z), jnp.asarray(emb), train)
        close(h, want_h, WHOLE_TOL, channels_last=True)
        close(tmod.to_rgb(h), jmod.apply(v, want_h, method="colorize"), WHOLE_TOL,
              channels_last=True)


def test_generator_linear_layout():
    """``G_linear``'s output is laid out (B, 4, 4, 16 chn), then made
    channels-first: a plain ``view(B, 16 chn, 4, 4)`` would differ."""
    z, emb, jmod, v, tmod = _generator_case(64, 64, 20)
    lin = tmod.G_linear(torch.from_numpy(z[:, :24]))
    want = jmod.apply(v, jnp.asarray(z[:, :24]),
                      method=lambda m, c: m.G_linear(c).reshape(-1, 4, 4, 128))
    close(lin.view(-1, 4, 4, 128).permute(0, 3, 1, 2), want, channels_last=True)
    assert not torch.allclose(lin.view(-1, 128, 4, 4), lin.view(-1, 4, 4, 128).permute(0, 3, 1, 2))


@pytest.mark.parametrize("cfg", [AE64, AE128], ids=["64px_in", "128px_bn"])
def test_bigae(cfg):
    """The whole AE: image, posterior mode and KL in train and eval mode;
    the bridge writes the same tree back."""
    x = _images(2, cfg["in_size"], 21)
    jmod = jb.BigAE(config=cfg)
    v = ae_init(jmod, jnp.asarray(x), seed=22)
    tmod = to_port(tb.BigAE(cfg), v)
    fn = jax.jit(lambda v, x, train: jmod.apply(v, x, train), static_argnums=2)
    for train in (True, False):
        with torch.no_grad():
            img, mode, p = tmod(cf(x), train)
        want_img, want_mode, want_p = fn(v, jnp.asarray(x), train)
        close(img, want_img, WHOLE_TOL, channels_last=True)
        close(mode, want_mode, WHOLE_TOL)
        assert abs(float(p.kl()) - float(want_p.kl())) <= WHOLE_TOL * abs(float(want_p.kl()))
    back = convert.to_variables(tmod.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    want_flat = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, v)))
    assert set(flat) == set(want_flat)
    for path, a in want_flat.items():
        assert flat[path].shape == a.shape and flat[path].dtype == a.dtype, path
        np.testing.assert_array_equal(flat[path], a, err_msg=str(path))
