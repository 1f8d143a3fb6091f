"""The port's tensor-parallel flow (``parallel/tp.py``) against the JAX
package's, on a 2 x 4 grid of CPU devices.

* ``make_2d_mesh`` is JAX's row-major reshape of the device list, and
  ``flow_param_specs`` JAX's specs with the weight layout mapped (a JAX
  kernel is ``(n, in, out)``, a port weight ``(n, out, in)``).
* At ``tests/test_parallel.py``'s sizes (C=16, E=16, H=64, 4 blocks, x (8,
  C)), the tensor-parallel forward against the JAX package's on its eight
  virtual devices and against the port on one device: out at rtol/atol
  2e-5, logdet at rtol 2e-5, atol 2e-4 (``test_tp_sharded_flow_matches_
  replicated``'s bounds); the reverse inverts it.
* In fp64 the loss, the gradients and one ``Adam`` step of the sharded
  masters against one device's, at rtol 1e-5, atol 1e-7.
* ``gather_flow_params`` gives the unsharded weights bit for bit, and the
  gathered flow's fp32 pack serves the chain (its plain version on the CPU).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from image2video_synthesis_using_cinns_tpu.models.stage2.flow import (
    control_mask,
    flow_forward as jflow_forward,
    init_flow_blocks,
    init_shuffle_buffers,
)
from image2video_synthesis_using_cinns_tpu.parallel import tp as jtp
from image2video_synthesis_using_cinns_tpu_torch.losses.flow_loss import flow_loss
from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
from image2video_synthesis_using_cinns_tpu_torch.parallel import tp
from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_2d_mesh
from image2video_synthesis_using_cinns_tpu_torch.train.optim import adam_torch
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

C, E, H, NF, B = 16, 16, 64, 4, 8  # tests/test_parallel.py's sizes
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
LOGDET_TOL = dict(rtol=2e-5, atol=2e-4)
F64_TOL = dict(rtol=1e-5, atol=1e-7)
GRID = make_2d_mesh(2, 4, ["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _threads(two_threads):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX blocks (a non-trivial ActNorm), inputs, and the JAX package's
    tensor-parallel forward on its 2 x 4 mesh."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    blocks = init_flow_blocks(k1, C, E, H, 2, NF)
    buffers = init_shuffle_buffers(k2, C, NF)
    blocks["actnorm"] = {"loc": 0.2 * jax.random.normal(k3, (NF, C)),
                         "scale": 1.0 + 0.2 * jax.random.uniform(k3, (NF, C))}
    mask = control_mask(NF, False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, C)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    mesh = jtp.make_2d_mesh(2, 4)
    out, logdet = jax.jit(jflow_forward)(
        jtp.shard_flow_params(mesh, blocks), jtp.replicated(mesh, buffers),
        jtp.batch_sharded(mesh, jnp.asarray(x)), jtp.batch_sharded(mesh, jnp.asarray(emb)), mask)
    variables = jax.tree.map(np.asarray, {"params": {"blocks": blocks},
                                          "buffers": {"shuffle": buffers}})
    return blocks, variables, x, emb, np.asarray(out), np.asarray(logdet), mesh


def port_flow(variables, dtype=torch.float32) -> tflow.ConditionalFlow:
    flow = tflow.ConditionalFlow(C, E, H, 2, NF)
    flow.load_state_dict(to_state_dict(variables))
    return flow.to(dtype)


def test_grid_and_specs_match_jax(jax_tp):
    blocks, variables, *_, mesh = jax_tp
    grid = make_2d_mesh(2, 4, [torch.device("cuda", i) for i in range(8)])
    assert [[d.index for d in row] for row in grid] == np.vectorize(
        lambda d: d.id)(mesh.devices).tolist()
    with pytest.raises(ValueError, match="n_devices=12"):
        make_2d_mesh(3, 4, ["cpu"] * 8)

    to_port = {0: 0, 1: 2, 2: 1}  # a JAX kernel's dims in the port's (n, out, in) weight

    def dim(spec: PartitionSpec, kernel: bool):
        axes = [i for i, a in enumerate(spec) if a == "model"]
        return None if not axes else to_port[axes[0]] if kernel else axes[0]

    jspecs = jtp.flow_param_specs(blocks)
    flow = port_flow(variables)
    specs = tp.flow_param_specs(flow.blocks_dict())
    assert specs["loc"] is specs["scale"] is None
    assert jspecs["actnorm"] == {"loc": PartitionSpec(), "scale": PartitionSpec()}
    for net, layers in specs["coupling"].items():
        assert len(layers) == len(jspecs["coupling"][net]) == 4
        for li, got in enumerate(layers):
            js = jspecs["coupling"][net][f"l{li}"]
            assert got == (dim(js["w"], True), dim(js["b"], False)), (net, li)
    shards = tp.shard_flow_params(GRID, flow.blocks_dict())
    w0, b0 = shards["coupling"]["s0"][0]
    w1, b1 = shards["coupling"]["s0"][1]
    assert [tuple(p.shape) for p in w0] == [(NF, H // 4, C // 2 + E)] * 4
    assert [tuple(p.shape) for p in b0] == [(NF, H // 4)] * 4
    assert [tuple(p.shape) for p in w1] == [(NF, H, H // 4)] * 4
    assert isinstance(b1, torch.nn.Parameter) and tuple(b1.shape) == (NF, H)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_tp_forward_matches_jax_and_one_device(jax_tp, shape):
    """On the JAX test's 2 x 4 grid, and on 1 x 8 and 8 x 1."""
    _, variables, x, emb, jout, jlogdet, _ = jax_tp
    flow = port_flow(variables)
    tpf = tp.TensorParallelFlow(flow, make_2d_mesh(*shape, ["cpu"] * 8))
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    with torch.no_grad():
        out, logdet = tpf.plain(xt, et)
        want_out, want_logdet = flow.plain(xt, et)
        back = tpf.plain(out, et, reverse=True)
    np.testing.assert_allclose(out.numpy(), jout, **OUT_TOL)
    np.testing.assert_allclose(logdet.numpy(), jlogdet, **LOGDET_TOL)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), **OUT_TOL)
    np.testing.assert_allclose(logdet.numpy(), want_logdet.numpy(), **LOGDET_TOL)
    np.testing.assert_allclose(back.numpy(), x, **OUT_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_tp_fp64_step_matches_one_device(jax_tp, shape):
    """The loss, the gradients (the shards' joined) and the weights after one
    ``Adam`` step (the stage-2 configs' amsgrad chain)."""
    _, variables, x, emb, *_ = jax_tp
    xt, et = torch.from_numpy(x).double(), torch.from_numpy(emb).double()
    one = port_flow(variables, torch.float64)
    tpf = tp.TensorParallelFlow(copy.deepcopy(one), make_2d_mesh(*shape, ["cpu"] * 8))

    def step(flow, params):
        opt = adam_torch(params, 1e-3, betas=(0.9, 0.99), weight_decay=1e-5, amsgrad=True)
        loss, _ = flow_loss(*flow.plain(xt, et))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    want_loss = step(one, list(one.parameters()))
    got_loss = step(tpf, list(tpf.parameters()))
    np.testing.assert_allclose(got_loss.numpy(), want_loss.numpy(), **F64_TOL)

    def joined(leaf, grad: bool):
        parts = leaf if isinstance(leaf, tp.Split) else [leaf]
        ts = [p.grad if grad else p.detach() for p in parts]
        return torch.cat(ts, dim=leaf.dim) if isinstance(leaf, tp.Split) else ts[0]

    want, got = one.blocks_dict(), tpf.blocks_dict()
    pairs = [(want["loc"], got["loc"]), (want["scale"], got["scale"])] + [
        pair for net in want["coupling"]
        for (ww, wb), (gw, gb) in zip(want["coupling"][net], got["coupling"][net])
        for pair in ((ww, gw), (wb, gb))]
    for w, g in pairs:
        np.testing.assert_allclose(joined(g, True).numpy(), w.grad.numpy(), **F64_TOL)
        np.testing.assert_allclose(joined(g, False).numpy(), w.detach().numpy(), **F64_TOL)


def test_gather_is_bitwise_and_serves_the_chain(jax_tp):
    _, variables, x, emb, *_ = jax_tp
    flow = port_flow(variables)
    whole = tp.gather_flow_params(tp.shard_flow_params(GRID, flow.blocks_dict()))
    want = flow.blocks_dict()
    assert torch.equal(whole["loc"], want["loc"]) and torch.equal(whole["scale"], want["scale"])
    for net in want["coupling"]:
        for (ww, wb), (gw, gb) in zip(want["coupling"][net], whole["coupling"][net]):
            assert torch.equal(gw, ww) and torch.equal(gb, wb)
    tpf = tp.TensorParallelFlow(flow, GRID)
    served = tpf.gather_into(port_flow(variables))
    served.pack_kernel_weights(torch.float32)
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    with torch.no_grad():
        np.testing.assert_allclose(fk.flow_reverse_fused(served.packed, xt, et).numpy(),
                                   tpf.plain(xt, et, reverse=True).numpy(), **OUT_TOL)
    rows = tp.batch_sharded(GRID, {"x": xt})
    assert [r["x"].shape[0] for r in rows] == [B // 2] * 2
    assert len(tp.replicated(GRID, {"x": xt})) == 2
