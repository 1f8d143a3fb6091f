"""The port's stage-2 AE step (``train.stage2_ae.AEStep``) against the JAX
package's ``make_ae_step``, on the CPU, at the debug width (chn 8, 64 px,
resnet18 'in' encoder, z 64, the tiny patch discriminator) on a batch of 2.

Variables are drawn with numpy (``test_torch_port_ae_layers.ae_init``: the
spectral vectors each kernel's top singular pair, as a trained checkpoint
holds them; random ones give the discriminator's sigma near 0 and amplify
rounding by its inverse) and carried to the port by the weight bridge;
LPIPS's too. ``pretrain`` is 1, so epoch 0 is gated and epoch 1 open; the
open step runs once more at w_kl 1, since at the config's 1e-5 the KL
term's share of the gradients is below what the bounds below can see. Each
step runs once per package (a train step once more in the port, in fp64),
from the same state, in a module fixture, at a tenth of the config's lr.

Adam's first step moves every weight by about +-lr, with the sign of its
gradient; where a gradient is 0 up to rounding (every conv bias that feeds
a batch-statistics BatchNorm), rounding picks the sign, differently in each
package. Such steps through all 11 M encoder weights move the post-update
recon by up to 5e-2 between the packages at the config's lr, and the
running means by up to 2e-5 at a tenth of it. So what the step computes
after its update is held where it is a function of the state: the port's
recompute pass run on the JAX step's updated variables gives the JAX step's
recon and running statistics, and the port's step returns its own pass on
its own updated state.

* Metrics (``LOG_KEYS``, ``Disc_weight`` among them) within ``METRIC_TOL``
  of max(|value|, 1); the post-update recon within 1e-4 as just said.
* Every parameter of the BigAE and ``logvar``, and the discriminator's,
  within 2 lr of the JAX step's (Adam's first step moves a weight by at
  most lr, so rounding that flips a near-zero gradient's sign moves it by 2
  lr); while gated the discriminator's parameters are exactly the JAX
  ones, unchanged.
* The step's gradients, through both optimizers' Adam moments (``mu`` is
  0.1 g, ``nu`` 0.001 g^2 after one step; the generator's with ``logvar``
  and, when open, the adaptive-weighted GAN term): per network and moment,
  the relative L2 distance of the JAX step's from the port's fp64 step's
  lies within ``FP32_SPREAD`` times the port's own fp32 distance from it,
  plus ``MOMENT_TOL``. Gradients that are 0 up to rounding (the biases
  above) and the discriminator's, taken on a recon that those flipped steps
  moved, make a bare bound on the fp32 distance ill-conditioned; a port
  computing another function (the GAN term's sign flipped or its weight
  doubled, a hinge flipped) fails this bound. While gated both packages'
  discriminator moments are 0.
* The BatchNorm running statistics, moved once by the step, within 1e-5 as
  just said; the BigGAN layers' vectors unchanged in both; the
  discriminator's ``u`` and ``v``, one power iteration on, within 1e-3.
* The optimizer counts exactly: the generator's 1; the discriminator's 0
  when gated (a d_loss <= 0 step, whose update is skipped) and 1 when open
  (d_loss > 0 here); a port step with the gate open and d_loss forced to 0
  skips the update too.
* The eval step (``train=False``): its metrics within ``METRIC_TOL``, and
  nothing of the state moves.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.backbones.lpips import LPIPS as JLPIPS
from image2video_synthesis_using_cinns_tpu.models.stage1.patch_disc import (
    NLayerDiscriminator as JNLayer,
)
from image2video_synthesis_using_cinns_tpu.models.stage2.biggan import BigAE as JBigAE
from image2video_synthesis_using_cinns_tpu.testing import PRESETS, stage2_ae_config
from image2video_synthesis_using_cinns_tpu.train.optim import adam_torch
from image2video_synthesis_using_cinns_tpu.train.stage2_ae import make_ae_step
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.models.layers import updating_batch_stats
from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae as tae
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_ae_layers import AE64, ae_init, cf
from test_torch_port_stage1_step import two_threads  # noqa: F401

BATCH = 2
LR = 2e-5  # a tenth of the config's: see the module docstring
METRIC_TOL, RECON_TOL, STATS_TOL, UV_TOL = 1e-4, 1e-4, 1e-5, 1e-3
MOMENT_TOL, FP32_SPREAD = 1e-4, 2.0


def ae_opt(pkg, cfg: dict = AE64):
    """The tiny AE config of ``pkg``'s ``Config`` at ``cfg``'s widths, pretrain 1."""
    opt = pkg.Config(stage2_ae_config(dict(PRESETS["tiny"])).to_dict())
    opt.AE.update(cfg)
    opt.Data["img_size"] = cfg["in_size"]
    opt.Training.update(lr=LR, pretrain=1)
    return opt


def jax_variables(opt, seed: int = 0) -> dict:
    """numpy-drawn variables of the JAX BigAE, discriminator and LPIPS."""
    size = opt.Data["img_size"]
    frame = jnp.zeros((1, size, size, 3))
    return {
        "GEN": ae_init(JBigAE(config=dict(opt.AE)), frame, seed=seed),
        "DISC": ae_init(JNLayer.from_config(opt.Discriminator_Patch), frame, seed=seed + 1),
        "LPIPS": ae_init(JLPIPS(), frame, frame, seed=seed + 2),
    }


def port_models(opt, variables: dict) -> tae.AEModels:
    """The port's modules with the JAX variables."""
    models = BUILD(tcfg.Config(opt.to_dict()))
    models.network.load_state_dict(convert.to_state_dict(variables["GEN"], fold_spectral=False))
    models.disc.load_state_dict(convert.to_state_dict(variables["DISC"], fold_spectral=False))
    models.lpips.load_state_dict(convert.to_state_dict(variables["LPIPS"]))
    return models


BUILD = tae.build_models  # the trainer tests replace the trainer's with ``port_models``


def port_tree(models: tae.AEModels) -> dict:
    """{"GEN": variables, "DISC": variables} of the port's modules, flat."""
    return {"GEN": _flat(convert.to_variables(models.network.state_dict())),
            "DISC": _flat(convert.to_variables(models.disc.state_dict()))}


def _flat(tree) -> dict:
    return flax.traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))


class World:
    """Both packages' networks with the same variables, a batch, the JAX steps."""

    def __init__(self, seed: int = 0):
        self.opt = ae_opt(tcfg)
        jopt = ae_opt(tcfg)
        self.vars = jax_variables(jopt, seed)
        self.port = port_models(self.opt, self.vars)
        self.img = np.random.default_rng(seed + 5).uniform(-1, 1, (BATCH, 64, 64, 3)).astype(
            np.float32)
        tr = self.opt.Training
        self.jopts = (adam_torch(LR, weight_decay=tr["weight_decay"]),
                      adam_torch(LR, weight_decay=tr["weight_decay"]))
        self.jopt, self.jax_fns = jopt, {}

    def training(self, w_kl: float | None) -> dict:
        """The Training section, with ``w_kl`` in place of the config's if given."""
        tr = dict(self.opt.Training)
        return tr if w_kl is None else {**tr, "w_kl": w_kl}

    def jax_step(self, epoch: int, train: bool = True, w_kl: float | None = None):
        tr = self.training(w_kl)
        if tr["w_kl"] not in self.jax_fns:
            self.jax_fns[tr["w_kl"]] = make_ae_step(
                JBigAE(config=dict(self.jopt.AE)), JNLayer.from_config(self.jopt.Discriminator_Patch),
                JLPIPS(), self.vars["LPIPS"], *self.jopts, float(tr["w_kl"]), int(tr["pretrain"]))
        train_fn, eval_fn = self.jax_fns[tr["w_kl"]]
        gv = jax.tree.map(jnp.array, self.vars["GEN"])
        dv = jax.tree.map(jnp.array, self.vars["DISC"])
        og = self.jopts[0].init((gv["params"], jnp.zeros(())))
        od = self.jopts[1].init(dv["params"])
        fn = train_fn if train else eval_fn
        return fn(gv, jnp.zeros(()), dv, og, od, jnp.asarray(self.img), jnp.asarray(epoch))

    def port_step(self, epoch: int, train: bool = True, dtype=torch.float32,
                  w_kl: float | None = None):
        models = copy.deepcopy(self.port)
        for m in (models.network, models.disc, models.lpips):
            m.to(dtype)
        models.logvar.data = models.logvar.data.to(dtype)
        tr = self.training(w_kl)
        opts = tae.make_optimizers(models, LR, tr["weight_decay"])
        metrics, recon = tae.AEStep(models, opts, tr)(cf(self.img).to(dtype), epoch, train)
        return models, opts, {k: float(v) for k, v in metrics.items()}, recon


@pytest.fixture(scope="module")
def world():
    return World()


class Step:
    """One step from the world's state in both packages."""

    def __init__(self, world: World, epoch: int, train: bool = True, w_kl: float | None = None):
        self.world, self.epoch, self.train = world, epoch, train
        gv, lv, dv, og, od, jm, jrecon = world.jax_step(epoch, train, w_kl)
        self.jax_metrics = {k: float(v) for k, v in jm.items()}
        self.jax_recon = np.moveaxis(np.asarray(jrecon), -1, 1)
        self.jax_tree = {"GEN": _flat(gv), "DISC": _flat(dv)}
        self.jax_logvar = float(lv)
        self.jax_counts = [int(flax.serialization.to_state_dict(o)["count"]) for o in (og, od)]
        self.jax_moments = jax_moments(og, od)
        self.models, self.opts, self.metrics, self.recon = world.port_step(epoch, train, w_kl=w_kl)
        self.tree = port_tree(self.models)
        if train:
            self.models64, self.opts64 = world.port_step(epoch, train, torch.float64, w_kl)[:2]

    def leaves(self):
        """(network, path, port leaf, JAX leaf)."""
        for name in ("GEN", "DISC"):
            mine, theirs = self.tree[name], self.jax_tree[name]
            assert set(mine) <= set(theirs), (name, set(mine) ^ set(theirs))
            assert set(theirs) - set(mine) <= {p for p in theirs if p[0] == "actnorm_stats"}
            for path in mine:
                yield name, path, mine[path], theirs[path]


MOMENTS = ("mu", "nu")


def jax_moments(og, od) -> dict:
    """{(network, moment): {path: array}} of the JAX step's optimizer states:
    the generator's over (params, logvar), logvar at ("logvar",)."""
    out = {}
    for name, state in (("GEN", og), ("DISC", od)):
        inner = flax.serialization.to_state_dict(state)["inner_state"]
        adam = next(v for v in inner.values() if "mu" in v)
        for moment in MOMENTS:
            tree = adam[moment]
            if name == "GEN":
                tree = {**tree["0"], "logvar": tree["1"]}
            out[name, moment] = _flat(tree)
    return out


def port_moments(models: tae.AEModels, opts) -> dict:
    """``jax_moments`` of the port's optimizers, in float64 (0 for a
    parameter the optimizer has not stepped)."""
    out = {}
    for name, module, opt in (("GEN", models.network, opts[0]), ("DISC", models.disc, opts[1])):
        for moment in MOMENTS:
            def of(p):
                return opt.state[p][moment] if opt.state.get(p) else torch.zeros_like(p)
            tree = convert.to_variables({n: of(p) for n, p in module.named_parameters()})
            flat = {k: v.astype(np.float64) for k, v in _flat(tree["params"]).items()}
            if name == "GEN":
                flat["logvar",] = of(models.logvar).double().numpy()
            out[name, moment] = flat
    return out


def _rel(a: dict, b: dict) -> float:
    """L2 distance of two {path: array} sets over the norm of ``b`` (the
    distance itself where ``b`` is 0)."""
    num = sum(float(np.square(np.asarray(a[k], np.float64) - b[k]).sum()) for k in b)
    den = sum(float(np.square(b[k]).sum()) for k in b)
    return float(np.sqrt(num / den)) if den else float(np.sqrt(num))


@pytest.fixture(scope="module", params=[(0, None), (1, None), (1, 1.0)],
                ids=["gated", "open", "open_w_kl_1"])
def step(world, request):
    epoch, w_kl = request.param
    return Step(world, epoch, w_kl=w_kl)


def test_step_metrics(step):
    assert list(step.metrics) == tae.LOG_KEYS and set(step.jax_metrics) == set(tae.LOG_KEYS)
    for k in tae.LOG_KEYS:
        a, b = step.metrics[k], step.jax_metrics[k]
        assert abs(a - b) <= METRIC_TOL * max(abs(b), 1.0), (k, a, b)
    assert step.metrics["Disc_factor"] == float(step.epoch >= 1)


def recompute(world: World, gen_tree: dict) -> tuple[np.ndarray, dict]:
    """The port step's recompute pass on the world's batch with the
    parameters of ``gen_tree`` and the world's initial running statistics:
    the recon and the running statistics it leaves."""
    models = copy.deepcopy(world.port)
    tree = {k: v for k, v in gen_tree.items() if k[0] != "batch_stats"}
    tree.update({k: v for k, v in _flat(world.vars["GEN"]).items() if k[0] == "batch_stats"})
    models.network.load_state_dict(convert.to_state_dict(flax.traverse_util.unflatten_dict(tree),
                                                         fold_spectral=False))
    step = tae.AEStep(models, (None, None), world.opt.Training)
    with torch.no_grad(), updating_batch_stats(models.network):
        recon = step.recon_losses(cf(world.img), True)["recon"].numpy()
    return recon, {k: v for k, v in port_tree(models)["GEN"].items() if k[0] == "batch_stats"}


def test_step_recon_and_statistics(step):
    """After the update: the JAX step's recon and running statistics from its
    updated parameters, the port's from its own."""
    initial = _flat(step.world.vars["GEN"])
    recon, stats = recompute(step.world, step.jax_tree["GEN"])
    np.testing.assert_allclose(recon, step.jax_recon, atol=RECON_TOL)
    assert len(stats) == 2 * (2 * 4 + 1)  # mean and var of 2 HyperBNs a GBlock, the final BN
    for path, a in stats.items():
        np.testing.assert_allclose(a, step.jax_tree["GEN"][path], rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=str(path))
        assert not np.array_equal(a, initial[path])  # moved by the step
    recon, stats = recompute(step.world, step.tree["GEN"])
    np.testing.assert_allclose(step.recon.numpy(), recon, atol=1e-6)
    for path, a in stats.items():
        np.testing.assert_allclose(step.tree["GEN"][path], a, rtol=1e-6, atol=1e-7)
    assert np.abs(step.recon.numpy() - recompute(step.world, initial)[0]).max() \
        > 100 * RECON_TOL  # the update moved it


def test_step_parameters(step):
    lr = LR
    assert abs(float(step.models.logvar.detach()) - step.jax_logvar) <= 2 * lr
    for name, path, a, b in step.leaves():
        if path[0] != "params":
            continue
        if name == "DISC" and step.epoch == 0:  # gated: untouched, exactly
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            np.testing.assert_array_equal(a, _flat(step.world.vars["DISC"])[path])
        else:
            assert np.abs(a - b).max() <= 2 * lr + 1e-6 * np.abs(b).max(), (name, path)


def test_step_moments(step):
    """The step's gradients through the Adam moments: see the module docstring."""
    theirs = step.jax_moments
    m32, m64 = port_moments(step.models, step.opts), port_moments(step.models64, step.opts64)
    for key, want in m64.items():
        assert set(theirs[key]) == set(want) == set(m32[key]), key
        spread, err = _rel(m32[key], want), _rel(theirs[key], want)
        assert err <= FP32_SPREAD * spread + MOMENT_TOL, (key, err, spread, _rel(m32[key], theirs[key]))
    if step.epoch == 0:  # gated: no discriminator update in either package
        for moment in MOMENTS:
            assert not any(np.any(a) for a in theirs["DISC", moment].values())
            assert not any(np.any(a) for a in m32["DISC", moment].values())


def test_step_spectral_vectors(step):
    initial = _flat(step.world.vars["GEN"])
    for name, path, a, b in step.leaves():
        if path[0] == "spectral" and name == "GEN":  # BigGAN layers: never written
            np.testing.assert_array_equal(a, initial[path])
            np.testing.assert_array_equal(b, initial[path])
        elif path[0] == "spectral":
            assert np.abs(a - b).max() <= UV_TOL, (path, np.abs(a - b).max())


def test_step_counts(step):
    gen, disc = step.opts
    assert step.jax_counts == [1, step.epoch]
    assert [gen.count, disc.count] == step.jax_counts
    assert (step.metrics["L_disc"] > 0) == bool(step.epoch)
    if step.epoch == 0:
        assert not disc.state


def test_open_step_with_zero_disc_loss_skips_the_update(world, monkeypatch):
    real_hinge = tae.hinge_loss
    monkeypatch.setattr(tae, "hinge_loss", lambda fake, real, update: (
        0.0 * (real.mean() + fake.mean()) if update == "disc" else real_hinge(fake, real, update)))
    models, (gen, disc), metrics, _ = world.port_step(1)
    assert metrics["L_disc"] == 0.0 and metrics["Disc_factor"] == 1.0
    assert gen.count == 1 and disc.count == 0 and not disc.state
    for (n, p), (_, q) in zip(models.disc.named_parameters(), world.port.disc.named_parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(models.disc.conv0.u, world.port.disc.conv0.u)  # refreshed all the same


def test_eval_step(world):
    e = Step(world, 1, train=False)
    for k in tae.LOG_KEYS:
        a, b = e.metrics[k], e.jax_metrics[k]
        assert abs(a - b) <= METRIC_TOL * max(abs(b), 1.0), (k, a, b)
    np.testing.assert_allclose(e.recon.numpy(), e.jax_recon, atol=RECON_TOL)  # no update
    assert [o.count for o in e.opts] == [0, 0]
    before = port_tree(world.port)
    for name in ("GEN", "DISC"):
        for path, a in e.tree[name].items():
            np.testing.assert_array_equal(a, before[name][path], err_msg=str(path))
    assert float(e.models.logvar.detach()) == 0.0
