"""The port's width-sharded decoder and ``Model(spatial_shard=)``
(``parallel/spatial.py``) against the port on one device and the JAX
package's sharded outputs, on CPU devices.

* The decoder of ``tests/test_parallel.py::test_spatial_sharded_decoder_
  matches_single_device`` (channel_factor 8, 64 px, ``upsample_s`` (2, 1),
  ``upsample_t`` (1, 2)), JAX's weights carried over, over 8 CPU shards:
  against the port's one-device decoder at rtol/atol 1e-4 (that test's
  bound) and against the JAX decoder width-sharded over its eight virtual
  devices at rtol 1e-3, atol 2e-4 (``JAX_DP_TOL``: the port against JAX on
  one device plus JAX's sharded against its one device).
* Widths that do not divide the shards stay whole: over 3 shards every
  anchor does (the decode is the one-device decode bit for bit); over 16 the
  first anchor (width 8) does and the next splits.
* ``Model(spatial_shard=True)`` over 8 CPU devices, ``Model(data_parallel=
  ..., spatial_shard=2)`` on a 4 x 2 grid at bs 3 with ``vid_length=12``
  (the extension), and its ``transfer``, against the port on one device
  (rtol 1e-3, atol 1e-4, the JAX facade tests' bound) and the JAX ``Model``
  with the same flags on its eight devices (``JAX_DP_TOL``); kernels off on
  both sides.
* The JAX facade's two ``ValueError``s, with its messages.
* ``testing.dryrun_multichip`` over 8 CPU devices at the tiny preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from image2video_synthesis_using_cinns_tpu.models.facade import Model as JModel
from image2video_synthesis_using_cinns_tpu.models.stage1.decoder import Generator as JGenerator
from image2video_synthesis_using_cinns_tpu.parallel.mesh import make_mesh as jmake_mesh
from image2video_synthesis_using_cinns_tpu.parallel.spatial import spatial_sharding as jscope
from image2video_synthesis_using_cinns_tpu.testing import PRESETS
from image2video_synthesis_using_cinns_tpu_torch.models import facade
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.decoder import Generator
from image2video_synthesis_using_cinns_tpu_torch.parallel import spatial
from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_mesh, replicate
from image2video_synthesis_using_cinns_tpu_torch.testing import dryrun_multichip
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

P = PRESETS["tiny"]
DEC_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_parallel.py's sharded decoder bound
FACADE_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_parallel.py's spatial facade bound
JAX_DP_TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads(two_threads):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def decoder_case():
    """JAX's decoder weights, inputs, and its width-sharded decode over the
    eight virtual devices, (B, 3, T, H, W)."""
    dec = JGenerator(channel_factor=8, z_dim=64, upsample_s=(2, 1), upsample_t=(1, 2),
                     spectral_norm=True)
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    z = rng.normal(size=(1, 64)).astype(np.float32)
    variables = jax.jit(dec.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
                                  jnp.asarray(z))
    mesh = jmake_mesh(8, "model")
    rep = NamedSharding(mesh, PartitionSpec())

    def fwd(v, img, z):
        with jscope(mesh, "model"):
            return dec.apply(v, img, z)

    out = jax.jit(fwd, in_shardings=(rep, rep, rep))(variables, jnp.asarray(img), jnp.asarray(z))
    port = Generator(8, 64, (2, 1), (1, 2)).eval()
    port.load_state_dict(to_state_dict(jax.tree.map(np.asarray, variables)))
    return (port, torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(z),
            np.asarray(out).transpose(0, 4, 1, 2, 3))


def _sharded(port, img, z, n):
    return port(img, z, [port] + replicate(["cpu"] * (n - 1), port))


def test_sharded_decoder_matches_one_device_and_jax(decoder_case):
    port, img, z, jout = decoder_case
    with torch.no_grad():
        want = port(img, z)
        out = _sharded(port, img, z, 8)
    assert isinstance(out, spatial.WidthShards) and [p.shape[-1] for p in out.parts] == [8] * 8
    got = spatial.gather(out)
    assert got.shape == want.shape == (1, 3, 16, 64, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DEC_TOL)
    np.testing.assert_allclose(got.numpy(), jout, **JAX_DP_TOL)


@pytest.mark.parametrize("n", [3, 16])
def test_indivisible_widths_stay_whole(decoder_case, n):
    port, img, z, _ = decoder_case
    with torch.no_grad():
        want = port(img, z)
        out = _sharded(port, img, z, n)
    x = torch.zeros(1, 2, 1, 4, 4)
    assert spatial.constrain_spatial(x, ["cpu"] * n) is x  # width 4: head_0 stays whole
    if n == 3:  # no anchor divides: the one-device decode
        assert isinstance(out, torch.Tensor) and torch.equal(out, want)
    else:  # width 8 whole, then 16 shards from width 16 on
        assert [p.shape[-1] for p in out.parts] == [4] * 16
        np.testing.assert_allclose(spatial.gather(out).numpy(), want.numpy(), **DEC_TOL)
        assert spatial.constrain_spatial(torch.zeros(1, 2, 1, 8, 8), ["cpu"] * n).shape[-1] == 8


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(str(tmp_path_factory.mktemp("spatial")), preset="tiny") + "/"


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(8)
    img = P["img_size"]
    return (rng.uniform(-1, 1, (3, 3, img, img)).astype(np.float32),
            rng.standard_normal((3, P["z_dim"])).astype(np.float32),
            rng.uniform(-1, 1, (1, P["seq_length"], 3, img, img)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_spatial(model_dir, inputs):
    """The JAX package's ``spatial_shard=True`` forward (8 frames, 2 rows) and
    its ``data_parallel=True, spatial_shard=2`` forward (12 frames, 3 rows)
    and transfer, on its eight devices."""
    x0, nu, q = inputs
    sp = JModel(model_dir, vid_length=8, use_pallas=False, spatial_shard=True)
    assert dict(sp.mesh.shape) == {"data": 1, "model": 8}
    dp = JModel(model_dir, vid_length=12, transfer=True, use_pallas=False, data_parallel=True,
                spatial_shard=2)
    assert dict(dp.mesh.shape) == {"data": 4, "model": 2}
    return (np.asarray(sp.forward(x0[:2], residual=nu[:2])),
            np.asarray(dp.forward(x0, residual=nu)), np.asarray(dp.transfer(q, x0)))


def cpu_devices(monkeypatch, n: int) -> None:
    """Every visible card, as ``spatial_shard=True`` and the CLIs ask: here
    ``n`` CPU devices."""
    monkeypatch.setattr(facade, "make_mesh", lambda devices=None: make_mesh(
        devices=["cpu"] * n if devices is None else devices))


def test_spatial_model_matches_one_device_and_jax(model_dir, inputs, jax_spatial, monkeypatch):
    x0, nu, _ = inputs
    cpu_devices(monkeypatch, 8)
    one = Model(model_dir, vid_length=8, use_kernel=False, device="cpu")
    sp = Model(model_dir, vid_length=8, use_kernel=False, spatial_shard=True)
    assert len(sp.spatial) == 1 and len(sp.spatial[0]) == 8 and len(sp.replicas[0].peers) == 8
    assert Model(model_dir, vid_length=8, data_parallel=["cpu"] * 8,
                 spatial_shard=8).spatial == sp.spatial
    got = sp.forward(x0[:2], residual=nu[:2]).numpy()
    assert got.shape == (2, 8, 3, 32, 32)
    np.testing.assert_allclose(got, one.forward(x0[:2], residual=nu[:2]).numpy(), **FACADE_TOL)
    np.testing.assert_allclose(got, jax_spatial[0], **JAX_DP_TOL)


def test_dp_spatial_model_and_transfer_match_one_device_and_jax(model_dir, inputs, jax_spatial):
    """A 4 x 2 grid: the 3 rows padded to 4, 12 frames (one extension);
    ``transfer`` encodes the query once and splits the start frames."""
    x0, nu, q = inputs
    one = Model(model_dir, vid_length=12, transfer=True, use_kernel=False, device="cpu")
    dp = Model(model_dir, vid_length=12, transfer=True, use_kernel=False,
               data_parallel=["cpu"] * 8, spatial_shard=2)
    assert [len(row) for row in dp.spatial] == [2] * 4 and len(dp.replicas) == 4
    got = dp.forward(x0, residual=nu).numpy()
    assert got.shape == (3, 12, 3, 32, 32)
    np.testing.assert_allclose(got, one.forward(x0, residual=nu).numpy(), **FACADE_TOL)
    np.testing.assert_allclose(got, jax_spatial[1], **JAX_DP_TOL)
    got_t = dp.transfer(q, x0).numpy()
    np.testing.assert_allclose(got_t, one.transfer(q, x0).numpy(), **FACADE_TOL)
    np.testing.assert_allclose(got_t, jax_spatial[2], **JAX_DP_TOL)


@pytest.mark.parametrize("kw", [dict(data_parallel=True, spatial_shard=True),
                                dict(spatial_shard=3), dict(spatial_shard=1)])
def test_flag_errors_match_jax(model_dir, monkeypatch, kw):
    with pytest.raises(ValueError) as want:
        JModel(model_dir, vid_length=8, use_pallas=False, **kw)
    cpu_devices(monkeypatch, 8)
    with pytest.raises(ValueError) as got:
        Model(model_dir, vid_length=8, **kw)
    assert str(got.value) == str(want.value)
    assert ("spatial_shard=<int>" if kw.get("data_parallel") else "divide") in str(got.value)


def test_dryrun_multichip_on_eight_cpu_devices():
    r = dryrun_multichip(["cpu"] * 8, "tiny")
    assert r["mesh"] == (4, 2) and r["sample_shape"] == (16, 8, 3, 32, 32)
    assert r["padded_eval_gap"] <= 1 and r["cached_gap"] <= 1
    assert r["spatial_err"] <= 2e-3 and r["dp_spatial_err"] <= 2e-3
