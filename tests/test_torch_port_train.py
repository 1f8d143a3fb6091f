"""The port's stage-2 training step against the JAX package, on the CPU.

The same weights (made by the JAX package at the tiny preset, carried over by
the weight bridge) and the same inputs, made from a seed, go through both:

* ``flow_loss`` with the reference noise injected, 1e-6 relative;
* the ActNorm data-dependent init, with and without control, 1e-5;
* autograd gradients of the NLL for every flow parameter against
  ``jax.grad``, each tensor to 1e-5 of its largest magnitude;
* the optimizer against the optax chain of ``adam_torch`` over 6 gradients
  (amsgrad on and off, weight decay 0 and 1e-4): parameters and state in
  optax's ``to_state_dict`` layout to 1e-6 relative, and a state loaded back;
  ``torch.optim.Adam(amsgrad=True)`` drifts from it, so a swap is caught;
* ``LRController`` in all three modes, exactly;
* three train steps against ``make_train_step`` with control on, the
  augmented batch, the encoder's eps and the reference noise injected: the
  losses to 1e-5 relative per step (each term to 1e-5 of the larger of
  itself and the loss); then the eval step from a re-packed
  fp32 pack against ``_eval_step`` (a stale pack is shown to disagree);
* the bf16-encoder step close to the fp32 one (as
  ``tests/test_train.py::test_stage2_bf16_step_close_to_fp32``).
"""

import copy
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.losses.flow_loss import flow_loss as jflow_loss
from image2video_synthesis_using_cinns_tpu.models.stage2 import flow as jflow
from image2video_synthesis_using_cinns_tpu.testing import make_model_dir
from image2video_synthesis_using_cinns_tpu.train import optim as joptim
from image2video_synthesis_using_cinns_tpu.train import stage2 as jstage2
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.losses.flow_loss import flow_loss
from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
from image2video_synthesis_using_cinns_tpu_torch.train import optim as toptim
from image2video_synthesis_using_cinns_tpu_torch.train import stage2 as tstage2
from image2video_synthesis_using_cinns_tpu_torch.utils import convert

C, E, H, NF, B = 16, 12, 32, 4, 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_flow_loss_matches_jax():
    rng = np.random.default_rng(0)
    gauss = rng.standard_normal((B, C)).astype(np.float32) * 2
    logdet = rng.standard_normal(B).astype(np.float32) * 10
    key = jax.random.PRNGKey(3)
    loss, aux = jflow_loss(jnp.asarray(gauss), jnp.asarray(logdet), rng=key)
    noise = np.array(jax.random.normal(key, (B, C), jnp.float32))
    tloss, taux = flow_loss(torch.from_numpy(gauss), torch.from_numpy(logdet),
                            noise=torch.from_numpy(noise))
    assert set(taux) == set(aux) == {"Loss", "nlogdet_loss", "nll_loss", "reference_nll_loss"}
    assert _rel(tloss.item(), float(loss)) < 1e-6
    for k in aux:
        assert _rel(taux[k].item(), float(aux[k])) < 1e-6, k
    # drawn from a generator: the same draw as injecting it
    g = torch.Generator().manual_seed(5)
    drawn = flow_loss(torch.from_numpy(gauss), torch.from_numpy(logdet), generator=g)[1]
    want = flow_loss(torch.from_numpy(gauss), torch.from_numpy(logdet),
                     noise=torch.randn((B, C), generator=torch.Generator().manual_seed(5)))[1]
    assert drawn["reference_nll_loss"] == want["reference_nll_loss"]
    assert "reference_nll_loss" not in flow_loss(torch.from_numpy(gauss),
                                                 torch.from_numpy(logdet))[1]


def _flow_setup(control: bool, seed: int = 0):
    """JAX flow parameters, the port's flow with the same weights, and a
    posterior-like batch (shifted and scaled, so the init has work to do)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    blocks = jflow.init_flow_blocks(k1, C, E, H, 2, NF)
    buffers = jflow.init_shuffle_buffers(k2, C, NF)
    port = tflow.ConditionalFlow(C, E, H, 2, NF, control=control)
    variables = jax.tree.map(np.asarray, {"params": {"blocks": blocks},
                                          "buffers": {"shuffle": buffers}})
    port.load_state_dict(convert.to_state_dict(variables))
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((B, C)) * 3 + 1).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    return blocks, buffers, jflow.control_mask(NF, control), port, x, emb


@pytest.mark.parametrize("control", [False, True])
def test_actnorm_init_matches_jax(control):
    blocks, buffers, mask, port, x, emb = _flow_setup(control)
    want = jflow.actnorm_init(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)["actnorm"]
    loc, scale = tflow.actnorm_init(port.blocks_dict(), port.shuffle_dict(), torch.from_numpy(x),
                                    torch.from_numpy(emb), port.mask)
    np.testing.assert_allclose(loc.numpy(), np.asarray(want["loc"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(want["scale"]), rtol=1e-5, atol=1e-5)
    port.init_actnorm(torch.from_numpy(x), torch.from_numpy(emb))  # written into the params
    assert torch.equal(port.blocks.actnorm.loc, loc) and torch.equal(port.blocks.actnorm.scale, scale)
    # after the init the first block's output is standardised over the batch
    first = (torch.from_numpy(x) + loc[0]) * scale[0]
    np.testing.assert_allclose(first.mean(0).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(first.std(0).numpy(), 1.0, atol=1e-4)


def test_nll_gradients_match_jax():
    """Autograd through the plain flow against jax.grad of the JAX loss, on
    an ActNorm-initialised flow (control on, so masked weights get zeros)."""
    blocks, buffers, mask, port, x, emb = _flow_setup(True, seed=2)
    blocks = jflow.actnorm_init(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    port.init_actnorm(torch.from_numpy(x), torch.from_numpy(emb))

    def jloss(bl):
        return jflow_loss(*jflow.flow_forward(bl, buffers, jnp.asarray(x), jnp.asarray(emb), mask))[0]

    want = convert.to_state_dict({"params": {"blocks": jax.tree.map(np.asarray,
                                                                    jax.grad(jloss)(blocks))}})
    loss, _ = flow_loss(*port.plain(torch.from_numpy(x), torch.from_numpy(emb)))
    loss.backward()
    assert _rel(loss.item(), float(jloss(blocks))) < 1e-5
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in port.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), name


def _grads(shapes, n_steps, seed):
    """Gradients whose scale jumps between steps, so nu falls behind its max."""
    rng = np.random.default_rng(seed)
    scales = [3.0, 0.01, 1.0, 0.001, 5.0, 0.1][:n_steps]
    return [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()}
            for sc in scales]


@pytest.mark.parametrize("amsgrad,wd", [(True, 0.0), (True, 1e-4), (False, 0.0), (False, 1e-4)])
def test_optimizer_matches_optax(amsgrad, wd):
    """The port's Adam against the optax chain of ``adam_torch`` over the
    tiny flow's parameters: parameters after each of 6 steps, then the state
    in optax's to_state_dict layout; a state loaded back steps the same."""
    blocks, buffers, _, port, _, _ = _flow_setup(False)
    named = dict(port.named_parameters())
    names = list(named)
    opt = toptim.adam_torch(list(named.values()), 1e-3, betas=(0.9, 0.99), weight_decay=wd,
                            amsgrad=amsgrad)
    jopt = joptim.adam_torch(1e-3, betas=(0.9, 0.99), weight_decay=wd, amsgrad=amsgrad)
    jparams = {"blocks": blocks}
    jstate = jopt.init(jparams)
    grads = _grads({n: tuple(p.shape) for n, p in named.items()}, 6, seed=7)
    for g in grads:
        for n, p in named.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        jg = convert.to_variables({n: torch.from_numpy(v) for n, v in g.items()})["params"]
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, jg), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        want = convert.to_state_dict({"params": jax.tree.map(np.asarray, jparams)})
        for n, p in named.items():
            assert _rel(p.detach().numpy(), want[n].numpy()) < 1e-6, n

    mine = toptim.optax_state(opt, names, tstage2._flow_tree)
    theirs = jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate))

    def walk(a, b, path=""):
        assert isinstance(a, dict) == isinstance(b, dict), path
        if isinstance(b, dict):
            assert set(a) == set(b), (path, sorted(a), sorted(b))
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert _rel(a, b) < 1e-6 if b.dtype.kind == "f" else np.array_equal(a, b), path

    walk(mine, theirs)
    # the state loaded back into a fresh optimizer steps as optax does
    fresh = {n: torch.nn.Parameter(p.detach().clone()) for n, p in named.items()}
    opt2 = toptim.adam_torch(list(fresh.values()), 0.5, betas=(0.9, 0.99), weight_decay=wd,
                             amsgrad=amsgrad)
    toptim.load_optax_state(opt2, theirs, names, tstage2._flow_named)
    assert opt2.count == 6 and toptim.get_lr(opt2) == pytest.approx(1e-3)
    g = _grads({n: tuple(p.shape) for n, p in named.items()}, 1, seed=8)[0]
    for n, p in fresh.items():
        p.grad = torch.from_numpy(g[n])
    opt2.step()
    jg = convert.to_variables({n: torch.from_numpy(v) for n, v in g.items()})["params"]
    updates, _ = jopt.update(jax.tree.map(jnp.asarray, jg), jstate, jparams)
    want = convert.to_state_dict({"params": jax.tree.map(lambda p, u: np.asarray(p + u),
                                                         jparams, updates)})
    for n, p in fresh.items():
        assert _rel(p.detach().numpy(), want[n].numpy()) < 1e-6, n


def test_torch_adam_amsgrad_drifts_from_optax():
    """torch.optim.Adam(amsgrad=True) keeps the max of the raw second moment:
    it agrees with optax's amsgrad at step 1 and not after, at the tolerance
    the port is held to."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 32)).astype(np.float32)
    ours, theirs = torch.nn.Parameter(torch.from_numpy(p0.copy())), torch.nn.Parameter(
        torch.from_numpy(p0.copy()))
    opt = toptim.adam_torch([ours], 1e-3, betas=(0.9, 0.99), amsgrad=True)
    topt = torch.optim.Adam([theirs], 1e-3, betas=(0.9, 0.99), amsgrad=True)
    rels = []
    for g in _grads({"w": (64, 32)}, 4, seed=3):
        for p in (ours, theirs):
            p.grad = torch.from_numpy(g["w"])
        opt.step()
        topt.step()
        rels.append(_rel(ours.detach() - torch.from_numpy(p0), theirs.detach() - torch.from_numpy(p0)))
    assert rels[0] < 1e-5 and max(rels[1:]) > 1e-2, rels


@pytest.mark.parametrize("mode,kw", [("exponential", dict(gamma=0.98)),
                                     ("step", dict(gamma=0.5, step_size=3)),
                                     ("plateau", dict())])
def test_lr_controller_matches_jax(mode, kw):
    metrics = [5.0, 4.0, 4.0, 4.0, 3.0, 3.00005, 3.1, 3.2, 1.0, 1.0, 1.0, 1.0]
    a, b = toptim.LRController(1e-3, mode, **kw), joptim.LRController(1e-3, mode, **kw)
    for m in metrics:
        arg = m if mode == "plateau" else None
        assert a.step(arg) == b.step(arg)
        assert a.state_dict() == b.state_dict()
    c = toptim.LRController(1.0, mode, **kw)
    c.load_state_dict(b.state_dict())
    assert c.state_dict() == b.state_dict()


# --------------------------------------------------------------------------
# full steps against make_train_step, at the tiny preset with control on
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def control_models(tmp_path_factory):
    """Both packages' stage-2 models from one JAX tiny control model dir, the
    port's flow carrying the JAX flow's initial weights."""
    d = make_model_dir(str(tmp_path_factory.mktemp("ckpt_ctrl")), preset="tiny", control=True)
    jopt = jcfg.load(os.path.join(d, "config_stage2.yaml"))
    jmods = jstage2.build_models(jopt)
    net_vars = jmods[-1]
    topt = tcfg.load(os.path.join(d, "config_stage2.yaml"))
    tmods = tstage2.build_models(topt)
    tmods.network.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, {
        "params": net_vars["params"], "buffers": net_vars["buffers"]})))
    return jopt, jmods, topt, tmods


def _batch(p_img=32, seq=9, n=3, seed=5):
    rng = np.random.default_rng(seed)
    seq_ = rng.uniform(-1, 1, (n, seq, p_img, p_img, 3)).astype(np.float32)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return seq_, pos


def _keys(key, n, z):
    """The encoder's eps and the reference noise that the JAX loss draws
    from ``key`` (``k_enc, k_ref = split(key)``)."""
    k_enc, k_ref = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(k_enc, (n, z)))),
            torch.from_numpy(np.array(jax.random.normal(k_ref, (n, z)))))


def test_train_steps_and_eval_step_match_jax(control_models):
    jopt, (config1, _, _, encoder, enc_vars, network, net_vars), topt, tmods = control_models
    z = config1.Decoder["z_dim"]
    seq, pos = _batch()
    n = seq.shape[0]
    optimizer = joptim.adam_torch(1e-3, betas=(0.9, 0.99), amsgrad=True)
    step_fn, eval_fn = jstage2.make_train_step(network, encoder, enc_vars, optimizer, True)
    flow_params, frozen, buffers = (net_vars["params"]["flow"], net_vars["params"]["embedder"],
                                    net_vars["buffers"])

    # the ActNorm init on the batch, as the trainer does it first
    k_init = jax.random.PRNGKey(11)
    post0, _, _ = encoder.apply(enc_vars, jnp.asarray(seq)[:, 1:], k_init)
    flow_params = dict(flow_params)
    flow_params["blocks"] = network.apply(
        {"params": {"flow": flow_params, "embedder": frozen}, "buffers": buffers},
        post0.reshape(n, -1), [jnp.asarray(seq)[:, 0], jnp.asarray(pos)], method="init_actnorm")
    opt_state = optimizer.init(flow_params)

    net = tmods.network
    tseq, tpos = torch.from_numpy(seq), torch.from_numpy(pos)
    cond = tstage2.conditioning(tseq, tpos)
    eps0 = torch.from_numpy(np.array(jax.random.normal(k_init, (n, z))))
    net.init_actnorm(tstage2.posterior(tmods.encoder, tseq, eps0), cond)
    net.flow.pack_kernel_weights(torch.float32)
    stale = net.flow.packed
    names = [k for k, _ in net.flow.named_parameters()]
    topt_ = toptim.adam_torch([p for _, p in net.flow.named_parameters()], 1e-3,
                              betas=(0.9, 0.99), amsgrad=True)
    assert names == list(dict(net.flow.named_parameters()))

    for s in range(3):
        key = jax.random.PRNGKey(100 + s)
        flow_params, opt_state, aux = step_fn(flow_params, opt_state, frozen, buffers,
                                              jnp.asarray(seq), jnp.asarray(pos), key)
        taux = tstage2.train_step(net, topt_, tmods.encoder, tseq, cond, *_keys(key, n, z))
        # each term to 1e-5 of the larger of itself and the loss: -mean(logdet)
        # is a small sum of larger terms of both signs
        scale = abs(float(aux["Loss"]))
        for k in aux:
            a, b = taux[k].item(), float(aux[k])
            assert abs(a - b) <= 1e-5 * max(abs(b), scale), (s, k, a, b)

    key = jax.random.PRNGKey(200)
    want = eval_fn(flow_params, frozen, buffers, jnp.asarray(seq), jnp.asarray(pos), key)
    net.flow.pack_kernel_weights(torch.float32)  # re-packed after the steps
    got = tstage2.eval_step(net, tmods.encoder, tseq, cond, *_keys(key, n, z))
    for k in want:
        a, b = got[k].item(), float(want[k])
        assert abs(a - b) <= 1e-5 * max(abs(b), abs(float(want["Loss"]))), (k, a, b)
    net.flow.packed = stale  # a stale pack computes the flow before the steps
    old = tstage2.eval_step(net, tmods.encoder, tseq, cond, *_keys(key, n, z))
    assert _rel(old["nll_loss"].item(), float(want["nll_loss"])) > 1e-4
    net.flow.pack_kernel_weights(torch.float32)


def test_bf16_encoder_step_close_to_fp32(control_models):
    """``Training.compute_dtype: bfloat16`` runs only the frozen encoder in
    bf16: its posterior tracks the fp32 one at bf16 resolution, one step's
    losses stay within 10% (the bound of the JAX package's test) and every
    flow parameter stays fp32."""
    _, _, topt, tmods = control_models
    seq, pos = _batch(seed=9)
    tseq, tpos = torch.from_numpy(seq), torch.from_numpy(pos)
    cond = tstage2.conditioning(tseq, tpos)
    n, z = seq.shape[0], tmods.config1.Decoder["z_dim"]
    eps = torch.randn((n, z), generator=torch.Generator().manual_seed(3))
    enc16 = copy.deepcopy(tmods.encoder).to(torch.bfloat16)
    post32 = tstage2.posterior(tmods.encoder, tseq, eps)
    post16 = tstage2.posterior(enc16, tseq, eps)
    assert post16.dtype == torch.float32
    np.testing.assert_allclose(post16.numpy(), post32.numpy(),
                               atol=0.02 * float(post32.abs().max()))

    def run(encoder):
        net = copy.deepcopy(tmods.network)
        net.init_actnorm(post32, cond)
        opt = toptim.adam_torch(list(net.flow.parameters()), 1e-3, betas=(0.9, 0.99), amsgrad=True)
        ref = torch.randn((n, z), generator=torch.Generator().manual_seed(4))
        aux = tstage2.train_step(net, opt, encoder, tseq, cond, eps, ref)
        return net, {k: float(v) for k, v in aux.items()}

    net32, m32 = run(tmods.encoder)
    net16, m16 = run(enc16)
    for k, v32 in m32.items():
        assert np.isfinite(m16[k]) and abs(v32 - m16[k]) <= 0.10 * max(1.0, abs(v32)), k
    for (n32, a), (_, b) in zip(net32.flow.named_parameters(), net16.flow.named_parameters()):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=2.2e-3,
                                   err_msg=n32)
