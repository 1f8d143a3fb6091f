"""The trainable layers, the discriminators and the loss primitives of the
port's stage-1 training against the JAX package, on the CPU, at the tiny
preset's widths. Variables are drawn with numpy into the JAX modules' shapes
(``test_torch_port_stage1_step.numpy_init``) and carried over by the weight
bridge with the spectral vectors kept (``fold_spectral=False``).

Tolerances:

* trainable ``SNConv``/``SNDense``: the forward from the stored (u, v),
  1e-6 relative to its largest output (random vectors make sigma small and
  the outputs large), and one ``power_iteration_`` against the JAX
  ``mutable=["spectral"]`` pass, 1e-6 (unit vectors);
* ActNorm's data-dependent init against the JAX train pass plus
  ``merge_actnorm_init``, 1e-5; each ActNorm's output on the init frames has
  per-channel mean 0 and std 1 to 1e-4;
* ``Discriminator`` (logit and the four stages' features) and
  ``NLayerDiscriminator``, 1e-5 relative to each output's largest magnitude;
* the temporal discriminator's loss with the gradient penalty (a
  second-order term) and its parameter gradients against ``jax.grad`` of the
  JAX step's ``d_t_loss``, each tensor to 1e-4 of its largest magnitude;
* ``losses/common.py``, 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.losses import common as jloss
from image2video_synthesis_using_cinns_tpu.models import layers as jl
from image2video_synthesis_using_cinns_tpu.models.stage1.patch_disc import (
    NLayerDiscriminator as JNLayer,
)
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import (
    Discriminator as JDisc,
)
from image2video_synthesis_using_cinns_tpu.testing import PRESETS, stage1_config
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.losses import common as tloss
from image2video_synthesis_using_cinns_tpu_torch.models import layers as tl
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.patch_disc import (
    NLayerDiscriminator,
)
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Discriminator
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step as tstep
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_stage1_step import numpy_init, two_threads  # noqa: F401

P = PRESETS["tiny"]
OPT = stage1_config(P)
SUB = P["seq_length"] - 1  # the temporal discriminator's clip at 9 frames


def _cf(a) -> torch.Tensor:
    """channels-last numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _random_uv(variables: dict, seed: int) -> dict:
    """The spectral collection with random unit vectors, as the JAX init
    draws them (the power iteration is then far from converged)."""
    rng = np.random.default_rng(seed)

    def unit(a):
        a = rng.standard_normal(np.shape(a))
        return (a / np.linalg.norm(a)).astype(np.float32)

    return dict(variables, spectral=jax.tree.map(unit, variables["spectral"]))


@pytest.mark.parametrize("kind", ["conv2d", "conv3d", "dense"])
def test_trainable_spectral_layer(kind):
    """The forward divides by sigma from the stored vectors; one power
    iteration refreshes them as the JAX pass with ``spectral`` mutable."""
    if kind == "conv2d":
        jmod = jl.SNConv(12, (4, 4), strides=(2, 2), padding=(1, 1), use_spectral=True)
        port = tl.SNConv(5, 12, (4, 4), 2, 1, spectral=True)
        x = _rand(2, 16, 16, 5, seed=1)
    elif kind == "conv3d":
        jmod = jl.SNConv(8, (3, 3, 3), padding=(1, 1, 1), use_bias=False, use_spectral=True)
        port = tl.SNConv(6, 8, (3, 3, 3), 1, 1, bias=False, spectral=True)
        x = _rand(2, 4, 8, 8, 6, seed=2)
    else:
        jmod = jl.SNDense(7, use_spectral=True)
        port = tl.SNDense(24, 7, spectral=True)
        x = _rand(3, 24, seed=3)
    variables = _random_uv(numpy_init(jmod, jnp.zeros(x.shape)), seed=4)
    port.load_state_dict(convert.to_state_dict(variables, fold_spectral=False))
    xt = torch.from_numpy(x) if kind == "dense" else _cf(x)

    want = np.asarray(jax.jit(jmod.apply)(variables, x))
    got = port(xt).detach().numpy()
    assert _rel(got if kind == "dense" else np.moveaxis(got, 1, -1), want) <= 1e-6

    _, mut = jax.jit(lambda v, a: jmod.apply(v, a, mutable=["spectral"]))(variables, x)
    tl.power_iteration_(port)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(mut["spectral"][name]), rtol=1e-6, atol=1e-6)
    # the gradient reaches the weight alone (the vectors are buffers)
    port(xt).square().sum().backward()
    assert port.weight.grad is not None and not port.u.requires_grad


def test_spectral_power_iteration_converges():
    """Repeated refreshes drive sigma to the weight's top singular value."""
    layer = tl.SNConv(4, 6, (3, 3), spectral=True)
    for _ in range(200):
        tl.power_iteration_(layer)
    top = torch.linalg.matrix_norm(layer.weight.detach().reshape(6, -1), ord=2)
    sigma = layer.u @ layer.weight.detach().reshape(6, -1) @ layer.v
    assert abs(float(sigma) - float(top)) <= 1e-5 * float(top)


def test_discriminator_inits():
    """The orthogonal conv init (rows of the (out, -1) matrix orthonormal)
    and the patch discriminator's N(0, 0.02)."""
    torch.manual_seed(0)
    disc = Discriminator.from_config(OPT.Discriminator_Temporal)
    w = disc.backbone.conv1.weight.detach().reshape(disc.backbone.conv1.weight.shape[0], -1)
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(w.shape[0]), atol=1e-5)
    patch = NLayerDiscriminator(ndf=64)
    w = torch.cat([m.weight.detach().flatten() for m in patch.modules()
                   if isinstance(m, tl.SNConv)])
    assert abs(float(w.mean())) < 1e-3 and abs(float(w.std()) - 0.02) < 1e-3


@pytest.fixture(scope="module")
def temporal():
    jmod = JDisc.from_config(OPT.Discriminator_Temporal)
    x = _rand(2, SUB, P["img_size"], P["img_size"], 3, seed=5)
    variables = numpy_init(jmod, jnp.zeros((1,) + x.shape[1:]), seed=6)
    port = Discriminator.from_config(tcfg.Config(OPT.to_dict()).Discriminator_Temporal)
    ts1.load_variables(port, variables)
    return jmod, variables, port, x


def test_temporal_discriminator(temporal):
    jmod, variables, port, x = temporal
    logit, feats = jax.jit(jmod.apply)(variables, x)
    t_logit, t_feats = port(_cf(x))
    assert t_logit.shape == (x.shape[0], 1) and len(t_feats) == len(feats) == 4
    assert _rel(t_logit.detach().numpy(), logit) <= 1e-5
    for a, b in zip(t_feats, feats):
        assert _rel(np.moveaxis(a.detach().numpy(), 1, -1), b) <= 1e-5


def test_gradient_penalty_and_its_gradients(temporal):
    """The hinge loss plus w_GP times the gradient penalty, and its gradients
    with respect to the discriminator's parameters, against the JAX step's
    ``d_t_loss`` (``train/stage1_step.py:194-213``)."""
    jmod, variables, port, x = temporal
    w_gp = float(OPT.Training["w_GP"])
    fake = _rand(*x.shape, seed=7, scale=0.5)
    params, aux = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    def d_t_loss(p):
        v = {"params": p, **aux}
        pred_fake, _ = jmod.apply(v, fake)
        pred_real, _ = jmod.apply(v, x)
        l_d = jloss.hinge_loss(pred_fake, pred_real, "disc")
        grad_x = jax.grad(lambda a: jnp.mean(jmod.apply(v, a)[0]))(x)
        gp = jnp.mean(jnp.sum(jnp.square(grad_x).reshape(x.shape[0], -1), axis=1))
        return l_d + w_gp * gp, gp

    (want, want_gp), grads = jax.jit(jax.value_and_grad(d_t_loss, has_aux=True))(params)
    models = tstep.Stage1Models(None, None, port, None, None)
    step = tstep.Stage1Step(models, (None, None, None), OPT.Training)
    total, metrics = step.disc_t_loss(_cf(fake), _cf(x), create_graph=True)
    assert abs(float(total) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(metrics["L_GP"]) - float(want_gp)) <= 1e-4 * abs(float(want_gp))
    names = [n for n, _ in port.named_parameters()]
    t_grads = dict(zip(names, torch.autograd.grad(total, list(port.parameters()))))
    mine = ts1._params_tree(t_grads)
    flat_mine = jax.tree_util.tree_leaves_with_path(mine)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads)))
    assert len(flat_mine) == len(flat_want)
    for path, a in flat_mine:
        b = flat_want[path]
        scale = np.abs(b).max()
        assert np.abs(np.asarray(a) - b).max() <= 1e-4 * scale, (path, scale)


@pytest.fixture(scope="module")
def patch():
    jmod = JNLayer.from_config(OPT.Discriminator_Patch)
    x = _rand(20, P["img_size"], P["img_size"], 3, seed=8)
    variables = numpy_init(jmod, jnp.zeros((1,) + x.shape[1:]), seed=9)
    port = NLayerDiscriminator.from_config(OPT.Discriminator_Patch)
    ts1.load_variables(port, variables)
    return jmod, variables, port, x


def test_patch_discriminator(patch):
    jmod, variables, port, x = patch
    want = jax.jit(jmod.apply)(variables, x)
    got = port(_cf(x)).detach().numpy()
    assert got.shape == (x.shape[0], 1) + want.shape[1:3]
    assert _rel(np.moveaxis(got, 1, -1), want) <= 1e-5


def test_actnorm_init(patch):
    """Each ActNorm initialises from what reaches it, in sequence; the result
    equals the JAX train pass with ``merge_actnorm_init``, and the JAX
    trainer's ``actnorm_stats`` stays at its init values in the checkpoint."""
    jmod, variables, port, x = patch
    _, upd = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["actnorm_stats"]))(
        variables, x)
    want = jl.merge_actnorm_init(variables["params"], upd["actnorm_stats"])
    outputs = {}
    norms = {n: m for n, m in port.named_modules() if isinstance(m, tl.ActNormImage)}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: outputs.__setitem__(n, o))
             for n, m in norms.items()]
    tl.init_actnorm(port, _cf(x))
    for h in hooks:
        h.remove()
    assert len(norms) == 3
    for name, m in norms.items():
        for leaf in ("loc", "scale"):
            np.testing.assert_allclose(getattr(m, leaf).detach().numpy(),
                                       np.asarray(want[name][leaf]), rtol=1e-5, atol=1e-5)
        o = outputs[name].double()
        np.testing.assert_allclose(o.mean((0, 2, 3)).numpy(), 0.0, atol=1e-4)
        np.testing.assert_allclose(o.std((0, 2, 3)).numpy(), 1.0, atol=1e-4)
        assert not m.initializing
    tree = ts1.variables(port)
    for name in norms:
        stats = tree["actnorm_stats"][name]
        assert int(stats["initialized"]) == 0 and not stats["loc_init"].any()
        np.testing.assert_array_equal(stats["scale_init"], 1.0)
        np.testing.assert_array_equal(
            np.asarray(jax.tree.map(np.asarray, variables["actnorm_stats"])[name]["scale_init"]),
            stats["scale_init"])


def test_losses():
    rng = np.random.default_rng(10)
    mu, logvar = rng.standard_normal((2, 3, 16)).astype(np.float32)
    f1 = [rng.standard_normal((2, 4, 5)).astype(np.float32) for _ in range(3)]
    f2 = [rng.standard_normal((2, 4, 5)).astype(np.float32) for _ in range(3)]
    fake, real = rng.standard_normal((2, 6, 1)).astype(np.float32)
    pred = rng.uniform(-1, 1, (4, 20, 20, 3)).astype(np.float32)
    target = np.clip(pred + 0.2 * rng.standard_normal(pred.shape), -1, 1).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (tloss.KL(t(mu), t(logvar)), jloss.KL(mu, logvar)),
        (tloss.fmap_loss([t(a) for a in f1], [t(b) for b in f2], "L1"),
         jloss.fmap_loss(f1, f2, "L1")),
        (tloss.fmap_loss([t(a) for a in f1], [t(b) for b in f2], "L2"),
         jloss.fmap_loss(f1, f2, "L2")),
        (tloss.hinge_loss(t(fake), t(real), "disc"), jloss.hinge_loss(fake, real, "disc")),
        (tloss.hinge_loss(t(fake), None, "gen"), jloss.hinge_loss(fake, None, "gen")),
        (tloss.psnr(_cf(pred), _cf(target)), jloss.psnr(pred, target)),
        (tloss.ssim(_cf(pred), _cf(target)), jloss.ssim(pred, target)),
    ]
    for a, b in pairs:
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), (float(a), float(b))
    with pytest.raises(ValueError):
        tloss.hinge_loss(t(fake), None, "both")
