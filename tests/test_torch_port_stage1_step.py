"""The port's stage-1 training step and eval step against the JAX package, on
the CPU, at the tiny preset (9 frames, so the subsample branch does not run;
``test_torch_port_stage1_step17.py`` covers 17 frames).

Variables are drawn with numpy into the JAX modules' shapes (no XLA compile
of ``init``) and carried to the port by the weight bridge: kernels
U(+-1/sqrt(fan_in)), spectral u/v each kernel's top singular pair (as a
trained checkpoint's converged power iteration holds them: random unit
vectors give sigma near 0 and amplify rounding by its inverse), the
decoder's output conv damped 4x (its frames within 0.46; damped 20x, the
temporal discriminator's stem GroupNorm scales the rounding of its small
fake clips up to 1e-3 of its gradient) and the target frames kept at
|x| >= 0.6, so that no L1 gradient sign rests on a rounding difference. The encoder's eps
and the step's subsample start and patch indices are the JAX keys' draws.

* Two whole steps from the same state against ``make_stage1_train_step``
  (``Step``, compared by the ``test_step_*`` functions)
  with ``adam_torch``, one with the gate closed (epoch 0) and one open
  (epoch 1): every ``TRAIN_KEYS`` metric to 1e-4 relative (SSIM, whose
  ratios cancel near 0 on random clips, to 1e-4 of its unit range); every parameter
  of the four networks within 2 lr + 1e-6 of its largest (Adam's first step
  moves a weight by +-lr, and rounding may flip the sign of a near-zero
  gradient); ``u`` and ``v`` to 1e-3 (unit vectors refreshed from those
  weights); the optimizer states in optax's layout with the same keys,
  dtypes, shapes, counts and learning rates, the discriminators' moments
  to 1e-4 of each network's L2 norm. The autoencoder's gradient is
  ill-conditioned in fp32 (the port's fp32 gradient lies 1.2e-2 from its
  own fp64 one at 17 frames with the gate open, 1.4e-3 at 9; 1e-4 to 4e-4
  with it closed), so the VAE phase is held alone: with the JAX step's
  updated discriminators loaded (their Adam steps move every weight by
  +-lr, so rounding that flips a near-zero gradient's sign moves a weight
  by 2 lr), the JAX step's first moment lies within ``FP32_SPREAD`` times
  the port's own fp32 distance from the port's fp64 one (plus 1e-4) of it;
  a port computing another function would fail that. The steps take a
  tenth of the config's lr, which tightens the parameters' bound. With the gate
  closed both discriminators' parameters and optimizer states are exactly
  the JAX ones, unchanged, the port's ``Adam.count`` stays 0, and their
  ``u`` and ``v``, refreshed from unchanged weights, agree to 1e-6.
* The eval step against ``make_stage1_eval_step``, 1e-5 relative.
* ``compute_dtype: bfloat16`` against fp32 from the same state:
  ``Loss_L1``, ``Loss_KL``, PSNR and SSIM within 5% (the bound of
  ``tests/test_train.py::test_stage1_bf16_step_close_to_fp32``); parameters
  stay fp32.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.backbones.lpips import LPIPS as JLPIPS
from image2video_synthesis_using_cinns_tpu.models.stage1.decoder import Generator as JGenerator
from image2video_synthesis_using_cinns_tpu.models.stage1.patch_disc import (
    NLayerDiscriminator as JNLayer,
)
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import (
    Discriminator as JDisc,
)
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
from image2video_synthesis_using_cinns_tpu.ops.spectral import kernel_to_matrix
from image2video_synthesis_using_cinns_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from image2video_synthesis_using_cinns_tpu.testing import PRESETS, stage1_config
from image2video_synthesis_using_cinns_tpu.train.optim import adam_torch
from image2video_synthesis_using_cinns_tpu.train.stage1_step import (
    Stage1Bundle,
    Stage1State,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step as tstep
from image2video_synthesis_using_cinns_tpu_torch.utils import convert

P9 = PRESETS["tiny"]
BATCH = 2
LR = 2e-5  # a tenth of the config's: see the module docstring
METRIC_TOL, MOMENT_TOL, UV_TOL, FP32_SPREAD = 1e-4, 1e-4, 1e-3, 2.0


def _top_pairs(params: dict, spectral: dict) -> dict:
    if "u" in spectral:
        m = np.asarray(kernel_to_matrix(jnp.asarray(params["kernel"])), np.float64)
        left, _, right = np.linalg.svd(m, full_matrices=False)
        sign = 1.0 if left[:, 0].sum() >= 0 else -1.0
        return {"u": (sign * left[:, 0]).astype(np.float32),
                "v": (sign * right[0]).astype(np.float32)}
    return {name: _top_pairs(params[name], sub) for name, sub in spectral.items()}


def numpy_init(module, *args, seed=0):
    """Variables in ``module``'s shapes drawn with numpy (see the module
    docstring); ActNorm bookkeeping at its init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "scale_init":
            a = np.ones(s.shape)
        elif name in ("initialized", "loc_init"):
            a = np.zeros(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(a).astype(s.dtype)

    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    if "spectral" in variables:
        variables["spectral"] = _top_pairs(variables["params"], variables["spectral"])
    return variables


def jax_eps(key, shape):
    """The eps that the JAX ``Encoder`` draws from ``rngs={"sample": key}``."""
    return np.asarray(JEncoder(res_type_encoder="resnet18", z_dim=shape[1], channels=(16,) * 5,
                               stride_s=(1,) * 4, stride_t=(1,) * 4).apply(
        {}, rngs={"sample": key},
        method=lambda m: jax.random.normal(m.make_rng("sample"), shape)))


def stage1_variables(opt, seed: int = 0):
    """The JAX stage-1 networks of ``opt`` (a ``Stage1Bundle``) and their
    variables drawn with numpy (``numpy_init``; the decoder's output conv
    damped 4x, see the module docstring)."""
    img, t, z = opt.Data["img_size"], opt.Data["sequence_length"], opt.Decoder["z_dim"]
    sub = min(int(opt.Training["subsample_length"]), t - 1)
    decoder, encoder = JGenerator.from_config(opt.Decoder), JEncoder.from_config(opt.Encoder)
    disc_t = JDisc.from_config(opt.Discriminator_Temporal)
    disc_s, lpips = JNLayer.from_config(opt.Discriminator_Patch), JLPIPS()
    frame = jnp.zeros((1, img, img, 3))
    variables = {
        "GEN": numpy_init(decoder, frame, jnp.zeros((1, z)), seed=seed),
        "ENC": numpy_init(encoder, jnp.zeros((1, t - 1, img, img, 3)), seed=seed + 1),
        "DISC_t": numpy_init(disc_t, jnp.zeros((1, sub, img, img, 3)), seed=seed + 2),
        "DISC_s": numpy_init(disc_s, frame, seed=seed + 3),
    }
    conv_img = variables["GEN"]["params"]["conv_img"]
    conv_img["kernel"] = (conv_img["kernel"] * 0.25).astype(np.float32)
    lpips_vars = numpy_init(lpips, frame, frame, seed=seed + 4)
    return Stage1Bundle(decoder, encoder, disc_t, disc_s, lpips, lpips_vars), variables


def port_models(opt, bundle: Stage1Bundle, variables: dict):
    """The port's stage-1 networks and LPIPS with the JAX ones' variables."""
    models = ts1.build_models(tcfg.Config(opt.to_dict()))
    models.lpips.load_state_dict(convert.to_state_dict(bundle.lpips_vars))
    for name, module in ts1.networks(models).items():
        ts1.load_variables(module, variables[name])
    return models


class World:
    """Both packages' stage-1 networks with the same variables, a batch and
    the JAX step."""

    def __init__(self, p: dict, seed: int = 0):
        self.opt = stage1_config(p)
        opt, tr = self.opt, self.opt.Training
        tr["lr"] = LR
        img, t = p["img_size"], p["seq_length"]
        self.bundle, self.vars = stage1_variables(opt, seed)
        self.topt = tcfg.Config(opt.to_dict())
        self.port = port_models(opt, self.bundle, self.vars)

        rng = np.random.default_rng(seed + 5)
        seq = rng.uniform(-1, 1, (BATCH, t, img, img, 3)).astype(np.float32)
        seq[:, 1:] = np.sign(seq[:, 1:]) * (0.6 + 0.4 * np.abs(seq[:, 1:]))
        self.seq = seq
        mk = lambda: adam_torch(tr["lr"], betas=(0.5, 0.9), weight_decay=tr["weight_decay"])  # noqa: E731
        self.jopts = (mk(), mk(), mk())
        self.step_fn = make_stage1_train_step(self.bundle, tr, self.jopts)
        self.mesh = make_mesh(1)
        self.fp32_metrics = {}  # the port's fp32 step metrics by (epoch, key seed)

    def on_mesh(self, tree):
        """``tree`` replicated on a one-device mesh, and ``batch_on_mesh`` the
        batch sharded on it, as the JAX trainer places its state and batches:
        the step and eval programs are then those that
        ``test_torch_port_stage1_train.py``'s JAX ``main`` compiles (the
        same shapes and config), and the compile cache serves the second."""
        return replicate(self.mesh, tree)

    def batch_on_mesh(self):
        return shard_batch(self.mesh, jnp.asarray(self.seq))

    def jax_state(self):
        v = jax.tree.map(jnp.array, self.vars)
        o = self.jopts
        return Stage1State(v["GEN"], v["ENC"], v["DISC_t"], v["DISC_s"],
                           o[0].init((v["GEN"]["params"], v["ENC"]["params"])),
                           o[1].init(v["DISC_t"]["params"]), o[2].init(v["DISC_s"]["params"]))

    def draws(self, key):
        """The JAX step's draws from ``key`` as the port's ``StepDraws``."""
        tr, t = self.opt.Training, self.seq.shape[1] - 1
        k_sample, k_sub, k_patch = jax.random.split(key, 3)
        start = int(jax.random.randint(k_sub, (), 0, t - int(tr["subsample_length"]) + 1)) \
            if t >= 16 else 0
        idx = np.asarray(jax.random.randint(k_patch, (tstep.N_PATCH,), 0, BATCH * t))
        return tstep.StepDraws(torch.tensor(jax_eps(k_sample, (BATCH, self.opt.Decoder["z_dim"]))),
                               start, torch.from_numpy(idx.astype(np.int64)))

    def port_step(self, epoch: int, draws, compute_dtype: str = "float32"):
        """One port step from the world's state."""
        models = copy.deepcopy(self.port)
        tr = dict(self.topt.Training, compute_dtype=compute_dtype)
        optimizers = tstep.make_optimizers(models, tr["lr"], tr["weight_decay"])
        metrics, gen = tstep.Stage1Step(models, optimizers, tr)(torch.from_numpy(self.seq),
                                                                 epoch, draws)
        return models, optimizers, {k: float(v) for k, v in metrics.items()}, gen


def _flat(tree):
    return flax.traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))


def _flat_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a: dict, b: dict) -> float:
    """L2 distance of two {name: tensor} sets over the norm of ``b``."""
    num = sum(float((a[n].double() - b[n].double()).square().sum()) for n in b)
    return float(np.sqrt(num / sum(float(b[n].double().square().sum()) for n in b)))


def vae_phase_mu(world: World, state, draws, gate: float, dtype) -> dict:
    """The autoencoder's first Adam moment 0.5 (g + wd p) of the port's VAE
    phase in ``dtype``, against the JAX step's updated discriminators."""
    models = copy.deepcopy(world.port)
    ts1.load_variables(models.disc_t, _flat_tree(state.disc_t_vars))
    ts1.load_variables(models.disc_s, _flat_tree(state.disc_s_vars))
    for m in (models.decoder, models.encoder, models.disc_t, models.disc_s, models.lpips):
        m.to(dtype)
    step = tstep.Stage1Step(models, (None, None, None), world.topt.Training)
    fwd = step.forward_vae(torch.from_numpy(world.seq).to(dtype), draws.eps.to(dtype))
    total, _ = step.vae_loss(fwd, draws, gate)
    params = [*models.decoder.parameters(), *models.encoder.parameters()]
    wd = float(world.topt.Training["weight_decay"])
    grads = torch.autograd.grad(total, params)
    return {n: 0.5 * (g + wd * p.detach()) for n, g, p in zip(tstep.ae_names(models), grads, params)}


class Step:
    """One step from the world's state in both packages (epoch 0: the gate
    closed), compared by the ``test_step_*`` functions as the module
    docstring says."""

    def __init__(self, world: World, epoch: int, key_seed: int = 7):
        key = jax.random.PRNGKey(key_seed)
        tr = world.opt.Training
        self.world, self.lr = world, float(tr["lr"])
        self.gate_open = epoch >= int(tr["pretrain"])
        self.draws = world.draws(key)
        self.state, jm, jgen = world.step_fn(world.on_mesh(world.jax_state()),
                                             world.batch_on_mesh(), jnp.asarray(epoch), key)
        self.jax_metrics = {k: float(v) for k, v in jm.items()}
        self.jax_gen = np.moveaxis(np.asarray(jgen), -1, 2)
        self.models, self.optimizers, self.metrics, gen = world.port_step(epoch, self.draws)
        world.fp32_metrics[(epoch, key_seed)] = self.metrics
        self.gen = gen.numpy()
        st = self.state
        self.jax_vars = {"GEN": st.dec_vars, "ENC": st.enc_vars, "DISC_t": st.disc_t_vars,
                         "DISC_s": st.disc_s_vars}
        self.jax_states = {"GEN": st.opt_ae, "DISC_t": st.opt_dt, "DISC_s": st.opt_ds}
        self.states = ts1.optimizer_states(self.models, self.optimizers)

    def variables(self):
        """(network, path, port leaf, JAX leaf) over the four networks."""
        for name, module in ts1.networks(self.models).items():
            mine, theirs = _flat(ts1.variables(module)), _flat(self.jax_vars[name])
            assert set(mine) == set(theirs), (name, set(mine) ^ set(theirs))
            for path, b in theirs.items():
                yield name, path, mine[path], b

    def optimizer_states(self):
        """(network, port state, JAX state), flattened."""
        for name, jstate in self.jax_states.items():
            yield name, _flat(self.states[name]), _flat(flax.serialization.to_state_dict(jstate))


@pytest.fixture(scope="module", params=[0, 1], ids=["gate_closed", "gate_open"])
def step(world, request):
    return Step(world, request.param)


def test_step_metrics(step):
    assert set(step.metrics) == set(step.jax_metrics) == set(ts1.TRAIN_KEYS)
    for k in ts1.TRAIN_KEYS:
        a, b = step.metrics[k], step.jax_metrics[k]
        scale = 1.0 if k == "SSIM" else abs(b)  # SSIM: a mean of ratios, near 0 here
        assert abs(a - b) <= METRIC_TOL * scale, (k, a, b)


def test_step_generated_clips(step):
    np.testing.assert_allclose(step.gen, step.jax_gen, atol=1e-4)


def test_step_variable_layout(step):
    """The same collections, paths, dtypes and shapes; ``actnorm_stats`` as
    the JAX trainer keeps it."""
    for name, path, a, b in step.variables():
        assert a.dtype == b.dtype and a.shape == b.shape, (name, path)
        if path[0] not in ("params", "spectral"):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")


def test_step_parameters(step):
    for name, path, a, b in step.variables():
        if path[0] == "params":
            gated = name.startswith("DISC") and not step.gate_open
            bound = 0.0 if gated else 2 * step.lr + 1e-6 * np.abs(b).max()
            assert np.abs(a - b).max() <= bound, (name, path, np.abs(a - b).max())


def test_step_spectral_vectors(step):
    for name, path, a, b in step.variables():
        if path[0] == "spectral":  # refreshed from unchanged weights when gated
            tol = 1e-6 if (name.startswith("DISC") and not step.gate_open) else UV_TOL
            assert np.abs(a - b).max() <= tol, (name, path, np.abs(a - b).max())


def test_step_optimizer_state_layout(step):
    """optax's layout: the same keys, dtypes and shapes; counts and learning
    rates exactly."""
    for name, mine, theirs in step.optimizer_states():
        assert set(mine) == set(theirs), (name, set(mine) ^ set(theirs))
        for path, b in theirs.items():
            assert mine[path].dtype == b.dtype and mine[path].shape == b.shape, (name, path)
            if "mu" not in path and "nu" not in path:
                np.testing.assert_array_equal(mine[path], b, err_msg=f"{name} {path}")


def test_step_discriminator_moments(step):
    for name, mine, theirs in step.optimizer_states():
        if name == "GEN":
            continue
        for moment in ("mu", "nu"):
            paths = [p for p in theirs if moment in p]
            num = sum(np.square(mine[p].astype(np.float64) - theirs[p]).sum() for p in paths)
            den = sum(np.square(theirs[p].astype(np.float64)).sum() for p in paths)
            err = float(np.sqrt(num / den)) if den else float(num)
            assert err <= MOMENT_TOL, (name, moment, err)


def test_step_autoencoder_moment_through_the_vae_phase(step):
    want = ts1._ae_named(_flat_tree(flax.serialization.to_state_dict(step.state.opt_ae))
                         ["inner_state"]["1"]["mu"])
    mu32, mu64 = (vae_phase_mu(step.world, step.state, step.draws, float(step.gate_open), dt)
                  for dt in (torch.float32, torch.float64))
    spread, err = _rel(mu32, mu64), _rel(want, mu64)
    assert err <= FP32_SPREAD * spread + MOMENT_TOL, (err, spread, _rel(mu32, want))


def test_step_gate(step):
    """Closed, the discriminators' parameters and optimizer states are
    untouched and their ``Adam.count`` stays 0; open, both counts are 1."""
    count = int(np.asarray(step.states["DISC_t"]["count"]))
    opt_dt, opt_ds = step.optimizers[1:]
    assert count == int(step.gate_open) and opt_dt.count == opt_ds.count == count
    if not step.gate_open:
        for module, before in ((step.models.disc_t, step.world.port.disc_t),
                               (step.models.disc_s, step.world.port.disc_s)):
            for (n, p), (_, q) in zip(module.named_parameters(), before.named_parameters()):
                assert torch.equal(p, q), n
        assert not opt_dt.state and not opt_ds.state


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for the port, and two for numpy's and scipy's
    BLAS, while this module runs: the same results, and a fraction of the
    CPU time when test workers share the cores (more threads spin in their
    parallel regions)."""
    import scipy.linalg  # noqa: F401 (load its BLAS, so that the limit covers it)
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2, user_api="blas"):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return World(P9)


def test_eval_step_matches_jax(world):
    key = jax.random.PRNGKey(3)
    eval_fn = make_stage1_eval_step(world.bundle)
    v = jax.tree.map(jnp.asarray, world.vars)
    want, jgen = eval_fn(world.on_mesh(v["GEN"]), world.on_mesh(v["ENC"]),
                         world.batch_on_mesh(), key)
    got, gen = tstep.eval_step(world.port, torch.from_numpy(world.seq),
                               torch.tensor(jax_eps(key, (BATCH, P9["z_dim"]))))
    assert set(got) == set(want) == set(ts1.TEST_KEYS[:-1])
    for k in want:
        a, b = float(got[k]), float(want[k])
        assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
    np.testing.assert_allclose(gen.numpy(), np.moveaxis(np.asarray(jgen), -1, 2), atol=1e-5)


def test_bf16_step_close_to_fp32(world):
    """From the gate-open ``Step``'s draws; its fp32 metrics where that step ran."""
    draws = world.draws(jax.random.PRNGKey(7))
    m32 = world.fp32_metrics.get((1, 7)) or world.port_step(1, draws)[2]
    models, _, m16, _ = world.port_step(1, draws, compute_dtype="bfloat16")
    assert all(np.isfinite(v) for v in m16.values())
    for k in ("Loss_L1", "Loss_KL", "PSNR", "SSIM"):
        assert abs(m32[k] - m16[k]) <= 0.05 * max(1.0, abs(m32[k])), (k, m32[k], m16[k])
    for module in ts1.networks(models).values():
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert all(b.dtype == torch.float32 for b in module.buffers())
