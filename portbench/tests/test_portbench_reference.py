"""The plain reference against the port's eager path (no kernel, fp32) at
the tiny preset on the CPU: sampling, transfer, one stage-1 step and one
stage-2 step, from the same seeded weights and inputs."""

import torch

from portbench import harness, serving
from portbench.runners import stage1_train, stage2_train
from portbench.reference import stage1 as ref_stage1
from portbench.tests import tiny

CPU = torch.device("cpu")
TOL = 1e-5  # fp32 on both sides, the same operations in another order


def _model(cfg, state, transfer, vid_length):
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

    s2, s1, ae = serving.port_configs(cfg)
    return Model.from_configs(s2, s1, ae, vid_length, transfer=transfer, use_kernel=False,
                              compute_dtype="float32", device="cpu", state_dicts=state)


def test_sampling_matches_the_port(two_threads):
    cfg = tiny.tiny_config()
    state = serving.draw_serving(cfg, 5, CPU, transfer=False)
    gen = torch.Generator().manual_seed(1)
    x0 = torch.rand(3, 3, 32, 32, generator=gen) * 2 - 1
    nu = torch.randn(3, 16, generator=gen)
    video, z = _model(cfg, state, False, 12).sample(x0, residual=nu)
    ref = serving.Reference(cfg, state, CPU)
    z_ref = ref.sample_z(x0, nu)
    assert harness.rel_gap_rows(z, z_ref) < TOL
    assert harness.rel_gap_rows(video, ref.video(x0, z_ref, 12, 2)) < TOL
    assert video.shape == (3, 12, 3, 32, 32)


def test_transfer_matches_the_port(two_threads):
    cfg = tiny.tiny_config()
    state = serving.draw_serving(cfg, 6, CPU, transfer=True)
    gen = torch.Generator().manual_seed(2)
    query = torch.rand(1, 9, 3, 32, 32, generator=gen) * 2 - 1
    x0 = torch.rand(3, 3, 32, 32, generator=gen) * 2 - 1
    video, z = _model(cfg, state, True, 12).transfer_sample(query, x0)
    ref = serving.Reference(cfg, state, CPU)
    z_ref = ref.transfer_z(query, x0)
    assert harness.rel_gap_rows(z, z_ref) < TOL
    assert harness.rel_gap_rows(video, ref.video(x0, z_ref, 12, 3)) < TOL


def test_stage1_step_matches_the_port(two_threads):
    """One step, gates open, from the same weights, batch and draws: the
    augment, the losses, each leaf's gradient and its change."""
    from image2video_synthesis_using_cinns_tpu_torch.config import Config
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.models.layers import init_actnorm
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1
    from image2video_synthesis_using_cinns_tpu_torch.train.stage1_step import (
        Stage1Step, StepDraws, make_optimizers)

    cfg = tiny.tiny_config()
    traffic = dict(tiny.TRAFFIC["tiny-train"], epoch=1)
    drv = stage1_train.Runner(cfg, traffic, 9, CPU)
    drv.prepare()
    tr = drv.tr
    opt = Config({k: cfg[k] for k in ("Decoder", "Encoder", "Discriminator_Temporal",
                                      "Discriminator_Patch", "Data")})
    opt.Training = Config(tr)
    models = stage1.build_models(opt, weights_root="no-weights")
    for name in stage1_train.NETWORKS:
        getattr(models, name).load_state_dict(drv.state[name])
    aug_draws, eps, start, patches = drv.draws(0)
    seq = build_augment(32, drv.params, False, True)(drv.raw(0), draws=aug_draws)
    assert torch.equal(seq, ref_stage1.augment(drv.raw(0), 32, drv.params, aug_draws))
    init_actnorm(models.disc_s, seq.reshape((-1,) + seq.shape[2:])[:20].permute(0, 3, 1, 2))
    before = {f"{n}.{k}": p.detach().clone() for n in ("decoder", "encoder", "disc_t", "disc_s")
              for k, p in getattr(models, n).named_parameters()}
    optimizers = make_optimizers(models, float(tr["lr"]), float(tr["weight_decay"]))
    metrics, _ = Stage1Step(models, optimizers, tr)(seq, 1, StepDraws(eps, start, patches))
    drv.named = {n: dict(getattr(models, n).named_parameters())
                 for n in ("decoder", "encoder", "disc_t", "disc_s")}
    got = {"losses": [{k: float(v) for k, v in metrics.items()}],
           "grads": drv.first_grads(optimizers),
           "change": {key: float((p.detach() - before[key]).norm())
                      for key, p in ((f"{n}.{k}", p) for n, ps in drv.named.items()
                                     for k, p in ps.items())}}
    want = dict(drv.traffic, checked_steps=1)
    drv.traffic = want
    gaps = drv.compare(got, drv.reference_readings())
    # Adam's first step moves every weight by about lr whatever its gradient's
    # size, so a weight whose gradient is round-off (a bias under a norm)
    # moves either way on either side; the leaves' norms of the change agree
    assert gaps["loss_gap"] < TOL and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps


def test_stage2_step_matches_the_port(two_threads):
    """The ActNorm init and one ``train_step`` from the same weights, batch and
    draws: the loss terms, each flow leaf's gradient and its change."""
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2
    from image2video_synthesis_using_cinns_tpu_torch.train.optim import adam_torch

    cfg = tiny.tiny_config()
    tr = {"lr": 1e-5, "beta1": 0.9, "beta2": 0.99, "weight_decay": 0, "amsgrad": True}
    drv = stage2_train.Runner(cfg, dict(tiny.TRAFFIC["tiny-stage2"], Training=tr), 9, CPU)
    drv.prepare()
    models = stage2.build_models_from_configs(*serving.port_configs(cfg))
    models.encoder.load_state_dict(drv.state["encoder"])
    models.network.load_state_dict(drv.state["network"])
    aug_draws, eps, ref = drv.draws(0)
    seq = build_augment(32, drv.params, False, True)(drv.raw(0), draws=aug_draws)
    assert torch.equal(seq, ref_stage1.augment(drv.raw(0), 32, drv.params, aug_draws))
    cond = stage2.conditioning(seq, None)
    models.network.init_actnorm(stage2.posterior(models.encoder, seq, drv.actnorm_eps()), cond)
    named = dict(models.network.flow.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    optimizer = adam_torch(list(named.values()), tr["lr"], betas=(0.9, 0.99), amsgrad=True)
    aux = stage2.train_step(models.network, optimizer, models.encoder, seq, cond, eps, ref)
    got = {"losses": [{k: float(v) for k, v in aux.items()}],
           "grads": {k: float(optimizer.state[p]["mu"].norm()) / 0.1 for k, p in named.items()},
           "change": {k: float((p.detach() - before[k]).norm()) for k, p in named.items()}}
    drv.traffic = dict(drv.traffic, checked_steps=1)
    gaps = drv.compare(got, drv.reference_readings())
    assert gaps["loss_gap"] < TOL and gaps["grad_gap"] < TOL and gaps["change_gap"] < TOL, gaps
