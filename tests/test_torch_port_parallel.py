"""The port's data-parallel serving and the helpers of its multi-process
training (``parallel/``), at the tiny preset, beside the JAX package's.

* ``pad_to_multiple``, ``host_batch_slice`` and ``require_mesh_divisible``
  give the JAX functions' values and errors.
* The loader's rank slices, concatenated, are the JAX loader's global
  batches, the dropped indivisible tail included (exactly).
* ``Model(data_parallel=[...])`` over two and three CPU replicas, with a
  4-row batch (three replicas pad it to 6), gives the single-device videos
  and z to rtol 1e-3, atol 1e-4, the JAX package's bound
  (tests/test_parallel.py), and the JAX package's ``Model(data_parallel=
  True)`` on its eight virtual CPU devices (kernels off on both sides) to
  that bound plus the port's against JAX on one device (atol 2e-4). The
  same for ``transfer`` (its query encoded once, the start frames split).
* ``-data_parallel -device cpu`` (``make_mesh`` giving CPU replicas, as
  the cards would be) serves in the sampling CLIs as they serve on one
  device, and in the eval CLIs as the root CLIs' ``-data_parallel`` do (the
  scores to 1e-3); ``-spatial_shard`` and ``Model(spatial_shard=)``
  raise, naming slice 11.
* ``maybe_initialize``: nothing to join without a config, torchrun's
  environment for ``True`` (raises without it), a one-rank gloo group from a
  mapping, joined once however often it is called; the collectives are the
  identity at world size 1.
"""

import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from image2video_synthesis_using_cinns_tpu.data import get_loader as jget_loader
from image2video_synthesis_using_cinns_tpu.data.loader import Loader as JLoader
from image2video_synthesis_using_cinns_tpu.models.facade import Model as JModel
from image2video_synthesis_using_cinns_tpu.parallel import distributed as jdist
from image2video_synthesis_using_cinns_tpu.parallel import mesh as jmesh
from image2video_synthesis_using_cinns_tpu.testing import (PRESETS, make_bair_data_dir,
                                                            stage1_config)
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.cli import (eval_diversity,
                                                             eval_synthesis_quality,
                                                             generate_samples, generate_transfer)
from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed, mesh
from test_torch_cli import _write_frames
from test_torch_port_eval import (_lines, _vgg_like_jax, same_residuals,  # noqa: F401
                                  stand_ins, tiny_dirs)
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

P = PRESETS["tiny"]
DP_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_parallel.py's data-parallel bound
# against the JAX package's data-parallel model: the sum of the bounds it
# composes, the port against JAX on one device (atol 1e-4, kernels off:
# test_torch_port_model.py) and JAX's replicas against its one device
JAX_DP_TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads(two_threads):  # noqa: F811
    yield


@pytest.mark.parametrize("b,multiple", [(4, 2), (5, 2), (7, 3), (6, 3), (1, 4)])
def test_pad_to_multiple_matches_jax(b, multiple):
    rng = np.random.default_rng(b)
    x = rng.standard_normal((b, 3)).astype(np.float32)
    y = rng.standard_normal((b, 2, 2)).astype(np.float32)
    want, want_b = jmesh.pad_to_multiple({"x": jnp.asarray(x), "y": jnp.asarray(y)}, multiple)
    got, got_b = mesh.pad_to_multiple({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                                      multiple)
    assert got_b == want_b and (got_b is None) == (b % multiple == 0)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    shards = mesh.shard_batch(["cpu"] * multiple, got)
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), got["x"].numpy())


def test_batch_slices_and_divisibility_match_jax():
    for pc in (1, 2, 4):
        for pi in range(pc):
            assert distributed.host_batch_slice(8, pi, pc) == jdist.host_batch_slice(8, pi, pc)
    for call in (lambda m: m.host_batch_slice(10, 0, 4),
                 lambda m: m.require_mesh_divisible(4, bs=10, bs_eval=8)):
        with pytest.raises(ValueError) as want:
            call(jdist)
        with pytest.raises(ValueError) as got:
            call(distributed)
        assert str(got.value) == str(want.value)
    distributed.require_mesh_divisible(4, bs=8, bs_eval=12)
    assert distributed.local_rows(torch.arange(6)).tolist() == list(range(6))  # world size 1


@pytest.fixture(scope="module")
def bair10(tmp_path_factory):
    data = make_bair_data_dir(str(tmp_path_factory.mktemp("loader")) + "/", n_videos=10,
                              img=P["img_size"], modes=("train",))
    opt = stage1_config(P)
    opt.Data["data_path"] = data
    return opt


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_slices_assemble_to_jax_global_batches(bair10, drop_last):
    """10 clips at bs 4: two full batches and a tail of 2, which does not
    divide the 4-row tail multiple and is dropped, with one warning."""
    jds = jget_loader("bair")(bair10, mode="train")
    tds = get_loader("bair")(tcfg.Config(bair10.to_dict()), mode="train")
    kw = dict(drop_last=drop_last, workers=2, seed=7, tail_multiple=4)
    want = [b["seq_raw"] for b in JLoader(jds, 4, **kw).epoch_iter(1)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ranks = [Loader(tds, 4, process_index=r, process_count=2, **kw) for r in range(2)]
        got = [[b["seq_raw"] for b in loader.epoch_iter(1)] for loader in ranks]
        assert len(ranks[0]) == len(want) == 2
    assert len([w for w in caught if "dropping the tail batch of 2" in str(w.message)]) == (
        0 if drop_last else 2)  # once a loader
    for w, g0, g1 in zip(want, *got):
        assert g0.shape[0] == g1.shape[0] == 2
        np.testing.assert_array_equal(np.concatenate([g0, g1]), w)
    tail = Loader(tds, 4, drop_last=False, workers=2, seed=7)
    assert len(tail) == 3  # without a tail multiple the tail stays


@pytest.fixture(scope="module")
def model_dir(tiny_dirs):  # noqa: F811
    return tiny_dirs[0]  # the JAX package's tiny model directory


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    img = P["img_size"]
    return (rng.uniform(-1, 1, (4, 3, img, img)).astype(np.float32),
            rng.standard_normal((4, P["z_dim"])).astype(np.float32),
            rng.uniform(-1, 1, (1, P["seq_length"], 3, img, img)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_dp(model_dir, inputs):
    """The JAX package's data-parallel model on its eight CPU devices."""
    x0, residual, q = inputs
    m = JModel(model_dir, vid_length=8, transfer=True, use_pallas=False, data_parallel=True)
    return np.asarray(m.forward(x0, residual=residual)), np.asarray(m.transfer(q, x0))


@pytest.mark.parametrize("replicas", [["cpu", "cpu"], ["cpu", "cpu", "cpu"]])
def test_dp_model_matches_one_device_and_jax(model_dir, inputs, jax_dp, replicas):
    x0, residual, q = inputs
    one = Model(model_dir, vid_length=8, transfer=True, use_kernel=False, device="cpu")
    dp = Model(model_dir, vid_length=8, transfer=True, use_kernel=False, data_parallel=replicas)
    assert dp.device == torch.device("cpu") and len(dp.replicas) == len(replicas)
    assert dp.replicas[1].flow is not dp.flow  # a copy a replica
    want_v, want_z = one.sample(x0, residual=residual)
    got_v, got_z = dp.sample(x0, residual=residual)
    assert got_v.shape == (4, 8, 3, 32, 32)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), **DP_TOL)
    np.testing.assert_allclose(got_z.numpy(), want_z.numpy(), **DP_TOL)
    np.testing.assert_allclose(got_v.numpy(), jax_dp[0], **JAX_DP_TOL)
    # nu drawn for the whole batch first: the same as one device's from the same seed
    np.testing.assert_allclose(dp.forward(x0).numpy(), one.forward(x0).numpy(), **DP_TOL)
    got_t, want_t = dp.transfer(q, x0), one.transfer(q, x0)
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), **DP_TOL)
    np.testing.assert_allclose(got_t.numpy(), jax_dp[1], **JAX_DP_TOL)


def test_dp_model_with_the_kernel_wrappers(model_dir, inputs):
    """The default path (the kernel's plain version on the CPU) on two
    replicas, and a device that is not the mesh's first is refused."""
    x0, residual, _ = inputs
    one = Model(model_dir, vid_length=8, device="cpu")
    dp = Model(model_dir, vid_length=8, data_parallel=["cpu", "cpu"], device="cpu")
    np.testing.assert_allclose(dp.sample(x0[:3], residual=residual[:3])[0].numpy(),
                               one.sample(x0[:3], residual=residual[:3])[0].numpy(), **DP_TOL)
    with pytest.raises(ValueError, match="first serving device"):
        Model(model_dir, vid_length=8, data_parallel=["cpu", "cpu"], device="cuda")


def test_spatial_shard_and_cardless_data_parallel_raise(model_dir, monkeypatch):
    for kw in (dict(spatial_shard=2), dict(spatial_shard=2, data_parallel=["cpu", "cpu"])):
        with pytest.raises(NotImplementedError, match="slice 11"):
            Model(model_dir, vid_length=8, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(model_dir, vid_length=8, data_parallel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_samples.main(["-dataset", "bair", "-ckpt_path", model_dir, "-data_parallel"])


def test_serving_flags(model_dir):
    import argparse

    parser = argparse.ArgumentParser()
    generate_samples.add_serving_flags(parser)

    def options(*a):
        return generate_samples.serving_options(parser.parse_args(["-dataset", "x", *a]))

    assert options("-device", "cpu") == {"device": "cpu", "data_parallel": False}
    assert options("-device", "cpu", "-data_parallel") == {"device": "cpu",
                                                            "data_parallel": True}
    assert options("-gpu", "1", "-data_parallel") == {"device": "cuda:1", "data_parallel": True}
    with pytest.raises(ValueError, match="first serving device"):  # the mesh starts at cuda:0
        Model(model_dir, vid_length=8, data_parallel=["cuda:0", "cuda:1"], device="cuda:1")
    with pytest.raises(NotImplementedError, match="slice 11"):
        options("-device", "cpu", "-spatial_shard", "2")


def cpu_replicas(monkeypatch, n: int) -> None:
    """``-data_parallel`` serves on every visible card: here ``n`` CPU replicas."""
    from image2video_synthesis_using_cinns_tpu_torch.models import facade

    monkeypatch.setattr(facade, "make_mesh", lambda: mesh.make_mesh(devices=["cpu"] * n))


def test_sampling_clis_serve_data_parallel(tmp_path, monkeypatch, model_dir):
    """Three start frames at bs 3 on two replicas (padded to 4), and two
    query videos onto three start frames, as on one device."""
    monkeypatch.chdir(tmp_path)
    cpu_replicas(monkeypatch, 2)
    _write_frames(str(tmp_path / "assets" / "GT_samples" / "bair"), 3, P["img_size"])
    for k, name in enumerate(("vid0", "vid1", "vid2")):
        _write_frames(str(tmp_path / "assets" / "GT_samples" / "landscape" / "transfer" / name),
                      P["seq_length"], 40, seed=k)
    outs = {}
    for flags in ([], ["-data_parallel"]):
        generate_samples.main(["-dataset", "bair", "-ckpt_path", model_dir, "-seq_length", "8",
                               "-bs", "3", "-device", "cpu"] + flags)
        generate_transfer.main(["-dataset", "landscape", "-ckpt_path", model_dir,
                                "-seq_length", str(P["seq_length"]), "-device", "cpu"] + flags)
        res = tmp_path / "assets" / "results"
        outs[bool(flags)] = [np.asarray(Image.open(f).convert("RGB"), np.int16) for f in (
            res / "bair" / "results.gif", res / "landscape" / "transfer_0.gif",
            res / "landscape" / "transfer_2.gif")]
    for got, want in zip(outs[True], outs[False]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1  # one quantisation step of the GIF


@pytest.mark.parametrize("cli,flags", [
    ("eval_synthesis_quality", ["-bs", "6", "-FID", "1", "-LPIPS", "1", "-FVD", "1",
                                "-DTFVD", "1"]),
    ("eval_diversity", ["-bs", "3", "-n_realiz", "2", "-VGG", "1", "-DTI3D", "1"])])
def test_eval_clis_data_parallel_match_jax(tiny_dirs, stand_ins, same_residuals,  # noqa: F811
                                           monkeypatch, capsys, cli, flags):
    """The port's eval CLIs on three CPU replicas against the root CLIs'
    ``-data_parallel`` on the eight JAX devices, the residuals shared."""
    import importlib

    from image2video_synthesis_using_cinns_tpu_torch.metrics import streaming_eval as tstream

    ckpt_dir, synth, div = tiny_dirs
    data = synth if cli == "eval_synthesis_quality" else div
    if cli == "eval_diversity":
        monkeypatch.setattr(tstream, "vgg_features", _vgg_like_jax)
    args = ["-dataset", "bair", "-ckpt_path", ckpt_dir, "-data_path", data, "-seq_length", "4",
            *flags]
    monkeypatch.setattr(sys, "argv", [f"{cli}.py"] + args + ["-data_parallel"])
    importlib.import_module(cli).main()
    prefix = "score of" if cli == "eval_synthesis_quality" else "Diversity score of"
    want = _lines(capsys.readouterr().out, prefix)
    port = {"eval_synthesis_quality": eval_synthesis_quality, "eval_diversity": eval_diversity}
    cpu_replicas(monkeypatch, 3)
    port[cli].main(args + ["-device", "cpu", "-data_parallel"])
    got = _lines(capsys.readouterr().out, prefix)
    assert len(got) == len(want) > 0
    field = -1 if cli == "eval_synthesis_quality" else 3  # where each line has its score
    for a, b in zip(got, want):
        x, y = float(a.split(" ")[field]), float(b.split(" ")[field])
        assert np.isfinite(x) and abs(x - y) <= 1e-3 * abs(y), (a, b)


def test_maybe_initialize_and_world_one_collectives(monkeypatch):
    assert distributed.maybe_initialize(None) == (0, 1)
    assert distributed.maybe_initialize(False, "cpu") == (0, 1)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.maybe_initialize(True, "cpu")
    with pytest.raises(ValueError, match="unknown keys"):
        distributed.maybe_initialize({"process_id": 0, "num_processes": 1, "port": 1}, "cpu")
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cfg = {"coordinator_address": f"localhost:{port}", "num_processes": 1, "process_id": 0}
    try:
        assert distributed.maybe_initialize(cfg, "cpu") == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert distributed.maybe_initialize(cfg, "cpu") == (0, 1)  # joined once
        assert distributed.world() == 1 and distributed.is_primary()
        distributed.barrier("test")
        g = [torch.ones(3), torch.full((2, 2), 2.0)]
        distributed.all_reduce_mean_(g)
        assert g[0].tolist() == [1.0] * 3
        assert distributed.mean_scalars({"a": torch.tensor(2.5), "b": 1}) == {"a": 2.5, "b": 1.0}
        assert distributed.process_allgather(np.arange(3)).tolist() == [[0, 1, 2]]
        assert not distributed.any_rank(False) and distributed.any_rank(True)
    finally:
        distributed.destroy()
    assert not dist.is_initialized()


def test_chain_wrappers_refuse_a_replica_on_another_device():
    """A replica's chain runs where its packed weights are: the wrappers
    refuse inputs on another device, and a device that is neither the CPU
    nor a card (the launch on a replica's own card needs a card)."""
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.flow import ConditionalFlow
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel

    flow = ConditionalFlow(8, 4, 16, 2, 2)
    flow.pack_kernel_weights(torch.float32)
    packed = flow.packed.to("meta")
    x, emb = torch.zeros(2, 8), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="x is on cpu, the packed weights on meta"):
        flow_kernel._check(packed, x, emb)
    with pytest.raises(ValueError, match="runs on cuda"):
        flow_kernel.flow_reverse_fused(packed, x.to("meta"), emb.to("meta"))
