"""The port's multi-process data-parallel training on the CPU
(``parallel/distributed.py``), at the tiny preset, beside its one-process
runs and the JAX package.

Two ranks (this file run as a script, one process each) join one gloo
process group through ``Training.distributed`` mappings that differ in
``process_id``, and run back to back, in one process each, as a user would:

* stage 2 through ``train.stage2.main`` with the JAX trainer's draws (each
  draw made for the global batch) and initial flow, as
  ``test_torch_port_train_main.py`` runs the one-process port;
* stage 2 from cached posteriors through the trainer CLI (the cache built
  in two shards, one video a dispatch, and summed);
* stage 1 (discriminators open from the first step: the patch frames
  gathered across ranks, the gradient penalty's double backward through
  the reductions) and then its AE (BatchNorm encoder and decoder on global
  statistics, d_weight from reduced gradients), each through its CLI in
  fp64 (``testing.float64_training``);
* in-rank checks of the collectives against full-batch references: the
  train-mode ``BatchNorm`` forward, backward and running statistics,
  ``ActNormImage``'s init, the flow's ActNorm init (unbiased std over the
  global batch), the gradient penalty's scale and the AE's d_weight.

Checks: the two ranks log the same losses and end with the same weights
(exactly); they equal the one-process port run of each config, rtol 1e-5,
atol 1e-7 (stage 2's loss terms against the loss's scale): the logged
losses and every trained weight and buffer, the running statistics and
spectral vectors included. Stage 1 and the AE are held in fp64: in fp32 the
same one-process run on one and on two CPU threads ends further apart than
that (Adam's first steps turn rounding on a near-zero gradient into a step
of about lr either way, and the gradient penalty and d_weight amplify it).
Stage 2 equals the JAX package's ``main`` to ``test_torch_port_train_main.py``'s
tolerances; the sharded cache equals the one-process cache; rank 0 alone
wrote files; each collective gives the full batch's result (1e-6, the GP
and d_weight 1e-5). The ranks run the port only; the parent runs JAX.
"""

import contextlib
import glob
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = 2
RANK_TIMEOUT = 600  # seconds; a hung rank fails this module, not the suite
TOL = dict(rtol=1e-5, atol=1e-7)  # the JAX package's two-process bound


# -- the rank worker (this file as a script: the port only, no JAX) ---------------------------


class RecordedDraws:
    """Draws replayed from a one-process run's record, keyed by the call."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.record = pickle.load(f)

    def augment(self, epoch, index, global_step, n, params, random_crop):
        return self.record[("augment", epoch, index, global_step, n)]

    def normal(self, purpose, epoch, index, global_step, shape):
        return self.record[(purpose, epoch, index, global_step, tuple(shape))]


def _flat(modules: dict) -> dict:
    return {f"{name}/{k}": v.detach().cpu().numpy()
            for name, m in modules.items() for k, v in m.state_dict().items()}


def _trained(job: str, models) -> dict:
    if job.startswith("stage2"):
        return {"flow": models.network.flow}
    if job == "stage1":
        return {"decoder": models.decoder, "encoder": models.encoder, "disc_t": models.disc_t,
                "disc_s": models.disc_s}
    return {"network": models.network, "disc": models.disc,
            "logvar": torch.nn.ParameterList([models.logvar])}


def run_training_job(job: dict, out: str, tag: str, draws=None) -> dict:
    """One trainer run as ``job`` says (stage 1 and the AE in fp64), its
    trained modules' weights saved to ``<out>/<tag>_weights.npz``; returns
    its logged losses. Stage 2 takes ``draws``, or those recorded in
    ``job["draws"]``."""
    from image2video_synthesis_using_cinns_tpu_torch.testing import float64_training
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1, stage2, stage2_ae

    module = {"stage2": stage2, "stage2_cached": stage2, "stage1": stage1,
              "ae": stage2_ae}[job["name"]]
    with (float64_training(module) if module is not stage2 else contextlib.nullcontext()):
        return _run_training_job(job, module, out, tag, draws)


def _run_training_job(job: dict, module, out: str, tag: str, draws) -> dict:
    from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
    from image2video_synthesis_using_cinns_tpu_torch.cli import (train_stage1, train_stage2,
                                                                 train_stage2_AE)
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2

    built, saved = {}, {}
    build = module.build_models

    def build_and_keep(opt, *a, **k):
        models = build(opt, *a, **k)
        if job.get("flow_init"):
            models.network.load_state_dict(torch.load(job["flow_init"]))
        built["models"] = models
        return models

    cache_fns = {}
    if job["name"] == "stage2_cached":  # keep the cache the run trains from
        for fn in ("build_cache", "assemble_cache_multiprocess"):
            cache_fns[fn] = getattr(stage2, fn)

        def keeping(fn):
            def call(*a, **k):
                saved[fn] = cache_fns[fn](*a, **k)
                return saved[fn]
            return call

        for fn in cache_fns:
            setattr(stage2, fn, keeping(fn))
    module.build_models = build_and_keep
    try:
        if job["name"] == "stage2":  # the draws injected: through main
            res = stage2.main(tcfg.load(job["config"]), eval_fvd=False, device="cpu",
                              draws=draws or RecordedDraws(job["draws"]))
        else:
            cli = {"stage2_cached": train_stage2, "stage1": train_stage1,
                   "ae": train_stage2_AE}[job["name"]]
            res = cli.main(["-cf", job["config"], "-device", "cpu"])
    finally:
        module.build_models = build
        for fn, f in cache_fns.items():
            setattr(stage2, fn, f)
    weights = _flat(_trained(job["name"], built["models"]))
    cache = saved.get("assemble_cache_multiprocess", saved.get("build_cache"))
    if cache is not None:
        weights["cache"] = cache.cpu().numpy()
    np.savez(os.path.join(out, f"{tag}_weights.npz"), **weights)
    keys = {"stage1": ("train_metrics", "eval_metrics")}.get(job["name"],
                                                             ("train_loss", "eval_loss"))
    return {"train": _values(res[keys[0]]), "eval": _values(res[keys[1]]),
            "save_path": res["save_path"]}


def _values(x):
    return [float(v) for v in (x.values() if isinstance(x, dict) else x)]


def unit_cases(rank: int, world: int) -> dict:
    """The collectives on this rank's half of fixed batches; the parent
    holds each result against the full batch in one process."""
    from image2video_synthesis_using_cinns_tpu_torch.models.layers import (
        ActNormImage, BatchNorm, init_actnorm, updating_batch_stats)
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed

    out = {}
    x, w_out = unit_inputs()
    rows = distributed.host_batch_slice(x.shape[0], rank, world)
    xl = x[rows].clone().requires_grad_(True)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    with updating_batch_stats(bn):
        y = bn(xl, train=True)
    # the global objective: sum over the ranks of each rank's weighted sum
    (y * w_out[rows]).sum().backward()
    out["bn_y"], out["bn_dx"] = y.detach(), xl.grad
    out["bn_dw"] = distributed.all_reduce_sum(bn.weight.grad)
    out["bn_mean"], out["bn_var"] = bn.mean.clone(), bn.var.clone()
    an = ActNormImage(x.shape[1])
    init_actnorm(an, x[rows])
    out["an_loc"], out["an_scale"] = an.loc.detach().clone(), an.scale.detach().clone()
    flow = flow_unit()
    v, emb = flow_inputs()
    rows_v = distributed.host_batch_slice(v.shape[0], rank, world)
    flow.init_actnorm(v[rows_v], emb[rows_v])
    out["flow_loc"] = flow.blocks.actnorm.loc.detach().clone()
    out["flow_scale"] = flow.blocks.actnorm.scale.detach().clone()
    out.update(gp_and_d_weight(rank, world))
    return {k: v.detach().numpy() for k, v in out.items()}


def unit_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 6, 5, 5), generator=g) * 2 + 0.5
    return x, torch.randn((4, 6, 5, 5), generator=g)


def flow_unit():
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.flow import ConditionalFlow

    torch.manual_seed(0)
    return ConditionalFlow(8, 4, 16, 2, 3)


def flow_inputs():
    g = torch.Generator().manual_seed(2)
    return torch.randn((6, 8), generator=g) * 3 + 1, torch.randn((6, 4), generator=g)


def gp_and_d_weight(rank: int, world: int) -> dict:
    """The stage-1 step's gradient penalty and the AE step's d_weight on
    this rank's rows, through the trainers' own code."""
    from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1, stage2_ae
    from image2video_synthesis_using_cinns_tpu_torch.train.stage1_step import (
        Stage1Step, make_optimizers)

    out = {}
    opt1 = tcfg.Config(TINY_STAGE1)
    models = stage1.build_models(opt1)
    step = Stage1Step(models, make_optimizers(models, 1e-4, 0.0), opt1.Training)
    g = torch.Generator().manual_seed(3)
    fake, real = torch.rand((4, 3, 8, 32, 32), generator=g), torch.rand((4, 3, 8, 32, 32),
                                                                         generator=g)
    rows = distributed.host_batch_slice(4, rank, world)
    _, m = step.disc_t_loss(fake[rows] * 2 - 1, real[rows] * 2 - 1, create_graph=False)
    out["L_GP"] = torch.tensor(distributed.mean_scalars({"gp": m["L_GP"]})["gp"])
    opt2 = tcfg.Config(TINY_AE)
    ae = stage2_ae.build_models(opt2)
    ae_step = stage2_ae.AEStep(ae, stage2_ae.make_optimizers(ae, 1e-4, 0.0), opt2.Training)
    img = torch.rand((4, 3, 64, 64), generator=g) * 2 - 1
    metrics, _ = ae_step(img[rows], epoch=1, train=False)
    out["Disc_weight"] = metrics["Disc_weight"]
    return out


def worker(spec_path: str, rank: int) -> None:
    torch.set_num_threads(2)  # as the parent runs its one-process references
    with open(spec_path) as f:
        spec = json.load(f)
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed

    result = {}
    for job in spec["jobs"]:
        result[job["name"]] = run_training_job(dict(job, config=job["configs"][rank]),
                                               spec["out"], f"{job['name']}_rank{rank}")
    np.savez(os.path.join(spec["out"], f"units_rank{rank}.npz"),
             **unit_cases(rank, distributed.world()))
    result["world"] = distributed.world()
    with open(os.path.join(spec["out"], f"result_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    distributed.destroy()


# the configs of the in-rank cases (the tiny preset's, set by the parent)
TINY_STAGE1 = None
TINY_AE = None


def tiny_configs():
    from image2video_synthesis_using_cinns_tpu.testing import (PRESETS, stage1_config,
                                                               stage2_ae_config)

    p = PRESETS["tiny"]
    s1 = stage1_config(p).to_dict()
    s1["Training"].update(pretrain=0)
    ae = stage2_ae_config(dict(p)).to_dict()
    ae["AE"].update(AE64_BN)
    ae["Data"]["img_size"] = 64
    ae["Training"].update(pretrain=0)
    return s1, ae


AE64_BN = dict(deterministic=False, in_size=64, norm="bn", encoder_type="resnet18",
               use_actnorm_in_dec=False, z_dim=64, chn=8)


# -- the parent: one-process references, the ranks, the checks ---------------------------------


class RecordingDraws:
    """The JAX trainer's draws (``JaxDraws``), each recorded by its call."""

    def __init__(self, draws):
        self.draws, self.record = draws, {}

    def augment(self, epoch, index, global_step, n, params, random_crop):
        v = self.draws.augment(epoch, index, global_step, n, params, random_crop)
        self.record[("augment", epoch, index, global_step, n)] = v
        return v

    def normal(self, purpose, epoch, index, global_step, shape):
        v = self.draws.normal(purpose, epoch, index, global_step, shape)
        self.record[(purpose, epoch, index, global_step, tuple(shape))] = v
        return v


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _configs(tmp, tcfg):
    """The four runs' configs (one process), and per rank with its mapping."""
    from image2video_synthesis_using_cinns_tpu.testing import make_bair_data_dir, make_model_dir

    model_dir = make_model_dir(str(tmp / "ckpts"), preset="tiny")
    d32 = make_bair_data_dir(str(tmp / "d32") + "/", n_videos=8, img=32, modes=("train", "eval"))
    d64 = make_bair_data_dir(str(tmp / "d64") + "/", n_videos=8, img=64, modes=("train", "eval"))
    s1, ae = tiny_configs()
    opts = {}
    for name in ("stage2", "stage2_cached"):
        opt = tcfg.load(os.path.join(model_dir, "config_stage2.yaml"))
        opt.Data["data_path"] = d32
        opt.Training.update(bs=4, bs_eval=4, workers=2, n_epochs=1)
        if name == "stage2_cached":
            opt.Data["aug"] = False
            opt.Training.update(cache_posteriors=True, cache_videos_per_dispatch=1)
        opts[name] = opt
    opts["stage1"] = tcfg.Config(s1)
    opts["stage1"].Data["data_path"] = d32
    opts["stage1"].Training.update(bs=4, bs_eval=4, workers=2, n_epochs=1)
    opts["ae"] = tcfg.Config(ae)
    opts["ae"].Data["data_path"] = d64
    opts["ae"].Training.update(bs=4, workers=2, n_epochs=1)
    return opts, s1, ae


def _one_process(name: str, opt, out: str, tcfg, draws=None, flow_init=None) -> dict:
    path = os.path.join(out, f"{name}_one.yaml")
    opt = tcfg.Config(opt.to_dict())
    opt.Training["save_path"] = os.path.join(out, f"{name}_one")
    tcfg.save(opt, path)
    job = {"name": name, "config": path, "flow_init": flow_init}
    return run_training_job(job, out, f"{name}_one", draws=draws)


@pytest.fixture(scope="module")
def two_threads():
    """Two intra-op threads for the port while this module runs, as the other
    port test modules take (``test_torch_port_stage1_step.two_threads``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, two_threads):
    """The one-process port runs, the JAX stage-2 ``main``, and the two ranks
    (started once the draws are recorded, run beside the rest)."""
    import jax
    from image2video_synthesis_using_cinns_tpu import config as jcfg
    from image2video_synthesis_using_cinns_tpu.train import stage2 as jstage2
    from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
    from image2video_synthesis_using_cinns_tpu_torch.utils import convert
    from test_torch_port_train_main import JaxDraws

    global TINY_STAGE1, TINY_AE
    tmp = tmp_path_factory.mktemp("distributed")
    out = str(tmp / "out")
    os.makedirs(out)
    opts, TINY_STAGE1, TINY_AE = _configs(tmp, tcfg)

    # stage 2 as the JAX trainer runs it: its initial flow and its draws, recorded
    net_vars = jstage2.build_models(jcfg.Config(opts["stage2"].to_dict()))[-1]
    flow_init = os.path.join(out, "flow_init.pt")
    torch.save(convert.to_state_dict(jax.tree.map(np.asarray, {
        "params": net_vars["params"], "buffers": net_vars["buffers"]})), flow_init)
    rec = RecordingDraws(JaxDraws())
    one = {"stage2": _one_process("stage2", opts["stage2"], out, tcfg, draws=rec,
                                  flow_init=flow_init)}
    with open(os.path.join(out, "draws.pkl"), "wb") as f:
        pickle.dump(rec.record, f)

    # the ranks: the same configs with their mappings
    port = _free_port()
    jobs = []
    for name in ("stage2", "stage2_cached", "stage1", "ae"):
        paths = []
        for r in range(RANKS):
            opt = tcfg.Config(opts[name].to_dict())
            opt.Training["save_path"] = os.path.join(out, f"{name}_ranks")
            opt.Training["distributed"] = {"coordinator_address": f"localhost:{port}",
                                           "num_processes": RANKS, "process_id": r,
                                           "backend": "gloo"}
            paths.append(os.path.join(out, f"{name}_rank{r}.yaml"))
            tcfg.save(opt, paths[-1])
        jobs.append({"name": name, "configs": paths, "draws": os.path.join(out, "draws.pkl"),
                     "flow_init": flow_init if name == "stage2" else None})
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "out": out, "tiny_stage1": TINY_STAGE1, "tiny_ae": TINY_AE}, f)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(RANKS)]
    try:
        opt = jcfg.Config(opts["stage2"].to_dict())
        opt.Training["save_path"] = os.path.join(out, "jax")
        jax_dir = jstage2.main(opt, eval_fvd=False)["save_path"]
        for name in ("stage2_cached", "stage1", "ae"):
            one[name] = _one_process(name, opts[name], out, tcfg)
        units_one = unit_cases(0, 1)
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank {p.args[-1]} failed:\n{log[-6000:]}"
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(out, f"result_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"out": out, "one": one, "ranks": ranks, "jax_dir": jax_dir,
            "units_one": units_one,
            "units": [dict(np.load(os.path.join(out, f"units_rank{r}.npz"))) for r in range(RANKS)]}


def _weights(runs, tag):
    return dict(np.load(os.path.join(runs["out"], f"{tag}_weights.npz")))


JOBS = ("stage2", "stage2_cached", "stage1", "ae")


@pytest.mark.parametrize("job", JOBS)
def test_ranks_agree_exactly_and_only_rank0_writes(runs, job):
    r0, r1 = runs["ranks"][0][job], runs["ranks"][1][job]
    assert runs["ranks"][0]["world"] == RANKS
    np.testing.assert_array_equal(r0["train"], r1["train"])
    np.testing.assert_array_equal(r0["eval"], r1["eval"])
    w0, w1 = _weights(runs, f"{job}_rank0"), _weights(runs, f"{job}_rank1")
    assert set(w0) == set(w1)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    written = glob.glob(os.path.join(runs["out"], f"{job}_ranks", "*"))
    assert written == [r0["save_path"]], written  # rank 0's run directory, nothing else
    assert os.path.exists(os.path.join(r0["save_path"], "log_per_epoch_train.csv"))


@pytest.mark.parametrize("job", JOBS)
def test_two_ranks_match_one_process(runs, job):
    one, two = runs["one"][job], runs["ranks"][0][job]
    assert len(one["train"]) == len(two["train"]) > 0
    w1, w2 = _weights(runs, f"{job}_one"), _weights(runs, f"{job}_rank0")
    assert set(w1) == set(w2)
    for split in ("train", "eval"):
        got, want = np.asarray(two[split]), np.asarray(one[split])
        # stage 2: each loss term against the loss's scale (the log-determinant
        # term is a small difference), as test_torch_port_train_main.py holds them
        scale = np.maximum(np.abs(want), abs(want[0])) if job.startswith("stage2") else np.abs(
            want)
        assert (np.abs(got - want) <= TOL["rtol"] * scale + TOL["atol"]).all(), (
            split, got, want)
    for k in w1:
        if k == "cache":  # the sharded build, one video a dispatch, summed: exact
            np.testing.assert_array_equal(w2[k], w1[k])
        else:  # weights, running statistics and spectral vectors alike
            np.testing.assert_allclose(w2[k], w1[k], **TOL, err_msg=k)


def test_stage2_two_ranks_match_jax_main(runs):
    from test_torch_port_train_main import _same_latest, _same_losses

    got = runs["ranks"][0]["stage2"]["save_path"]
    _same_losses(got, runs["jax_dir"])
    _same_latest(got, runs["jax_dir"], n_steps=2)


@pytest.mark.parametrize("key,tol", [
    ("bn_y", 1e-6), ("bn_dx", 1e-6), ("bn_dw", 1e-6), ("bn_mean", 1e-6), ("bn_var", 1e-6),
    ("an_loc", 1e-6), ("an_scale", 1e-6), ("flow_loc", 1e-6), ("flow_scale", 1e-6),
    ("L_GP", 1e-5), ("Disc_weight", 1e-5)])
def test_collectives_match_the_full_batch(runs, key, tol):
    """Each rank's result of the global batch against one process's: a
    rank's rows of a per-row output, else the whole value."""
    want = runs["units_one"][key]
    for r, got in enumerate(runs["units"]):
        got = got[key]
        if key in ("bn_y", "bn_dx"):
            want_r = want[r * got.shape[0]:(r + 1) * got.shape[0]]
        else:
            want_r = want
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want_r, rtol=tol, atol=tol * scale, err_msg=key)


def test_ae_batch_rows_do_not_depend_on_the_batch(two_threads):
    """A rank's augmented rows are the one-process batch's rows, bitwise.

    The AE's fp64 two-rank run on the card took another first step than one
    process (opposite signs at one encoder weight): its step-0 images
    differed in the last bits. The contrast op blends with each frame's
    grayscale mean, and a card's reduction orders that sum by how many
    frames the batch holds (PyTorch's CUDA reduce sizes its blocks by the
    count of outputs), so a float sum gave a rank's 3 frames other bits than
    the same frames in the batch of 6, and the AE's random networks turned
    that into opposite steps. The mean is now summed exactly
    (``data/augment.py``). The CPU keeps one order for any batch, so here
    the order is varied directly: the same frames with their pixels
    permuted must give the permuted output bitwise (a float sum fails
    that). The global batch is also held to the JAX package's augment of
    the same draws (``test_torch_port_train_augment.py``'s bound)."""
    import jax
    from image2video_synthesis_using_cinns_tpu.data.augment import build_augment as jbuild
    from image2video_synthesis_using_cinns_tpu_torch.data import augment as taug
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed
    from test_torch_port_train_augment import jax_draws

    _, ae = tiny_configs()
    params, img, n = ae["Data"]["Augmentation"], ae["Data"]["img_size"], 6
    raw = np.random.default_rng(12).integers(0, 256, (n, 1, img, img, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, n, params)

    def apply(frames, d):
        return taug.apply_augment(torch.from_numpy(frames), img, params, False, d).numpy()

    full = apply(raw, draws)
    np.testing.assert_allclose(full, np.asarray(jbuild(img, params, False, True)(raw, key)),
                               rtol=1e-5, atol=1e-5)
    for r in range(RANKS):
        rows = distributed.host_batch_slice(n, r, RANKS)
        np.testing.assert_array_equal(apply(raw[rows], {k: v[rows] for k, v in draws.items()}),
                                      full[rows])
    perm = np.random.default_rng(13).permutation(img * img)
    unflipped = dict(draws, flip=torch.zeros(n, dtype=torch.bool))  # a flip moves pixels too
    permuted = raw.reshape(n, 1, img * img, 3)[:, :, perm].reshape(raw.shape)
    np.testing.assert_array_equal(apply(permuted, unflipped).reshape(n, 1, img * img, 3),
                                  apply(raw, unflipped).reshape(n, 1, img * img, 3)[:, :, perm])


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        _spec = json.load(f)
    TINY_STAGE1, TINY_AE = _spec["tiny_stage1"], _spec["tiny_ae"]
    worker(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)
