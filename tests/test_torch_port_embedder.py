"""The torch port's start-frame embedder and cINN wrapper against the JAX
package, on the CPU: ``ResnetEncoder`` (resnet18, resnet50; InstanceNorm,
BatchNorm from running statistics, ActNorm) at 32 px, and
``SupervisedTransformer`` reverse/forward with endpoint control off and on.
Variables are drawn with numpy into the JAX modules' shapes (no XLA compile
of ``init``) and carried to the port by the weight bridge.

Tolerance: 1e-4 on the posterior parameters and the flow outputs (fp32;
a resnet50 stacks 53 convs with instance norms between them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.stage2.inn import SupervisedTransformer as JST
from image2video_synthesis_using_cinns_tpu.models.stage2.resnet2d import ResnetEncoder as JRE
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.inn import SupervisedTransformer
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.resnet2d import ResnetEncoder
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_stage1_step import two_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _numpy_init(module, *args, seed=0):
    """Variables in ``module``'s shapes, drawn with numpy: kernels and the
    flow's stacked weights U(+-1/sqrt(fan_in)), ActNorm near identity,
    positive BatchNorm running variances, small biases and means, and true
    permutations for the flow's shuffle buffers."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "w"):
            fan_in = np.prod(s.shape[:-1]) if name == "kernel" else s.shape[-2]
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(s.dtype)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    buffers = shapes.pop("buffers", None)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    if buffers is not None:
        n, c = buffers["flow"]["shuffle"]["fwd"].shape
        fwd = np.stack([rng.permutation(c) for _ in range(n)]).astype(np.int32)
        variables["buffers"] = {"flow": {"shuffle": {"fwd": fwd, "inv": np.argsort(fwd, 1).astype(np.int32)}}}
    return variables


def _img(b, seed=1):
    return np.tanh(np.random.default_rng(seed).standard_normal((b, 32, 32, 3))).astype(np.float32)


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("norm", ["in", "bn", "an"])
@pytest.mark.parametrize("encoder_type", ["resnet18", "resnet50"])
def test_resnet_encoder(encoder_type, norm):
    jm = JRE(z_dim=8, encoder_type=encoder_type, norm=norm)
    img = _img(2)
    v = _numpy_init(jm, jnp.asarray(img))
    port = ResnetEncoder(8, encoder_type, norm).eval()
    port.load_state_dict(to_state_dict(v))
    with torch.no_grad():
        out = port(_cf(img)).numpy()
        mode = port.encode(_cf(img)).mode().numpy()
    ref = np.asarray(jax.jit(jm.apply)(v, img))
    assert out.shape == (2, 16)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(mode, ref[:, :8], **TOL)


@pytest.mark.parametrize("control", [False, True])
def test_supervised_transformer(control):
    emb_cfg = {"z_dim": 8, "encoder_type": "resnet18", "norm": "in", "deterministic": False}
    kw = dict(flow_in_channels=16, flow_embedding_channels=8, flow_mid_channels=32,
              flow_hidden_depth=2, n_flows=4, control=control, embedder_config=emb_cfg)
    jm = JST(**kw)
    rng = np.random.default_rng(3)
    img = _img(3)
    pos = rng.uniform(0, 1, (3, 3)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    cond = [img] + ([pos] if control else [])
    v = _numpy_init(jm, jnp.asarray(x), cond)
    port = SupervisedTransformer(**kw).eval()
    port.load_state_dict(to_state_dict(v))
    tcond = [_cf(img)] + ([torch.from_numpy(pos)] if control else [])

    ref_z = jax.jit(lambda v, x, c: jm.apply(v, x, c, reverse=True))(v, x, cond)
    ref_g, ref_ld = jax.jit(jm.apply)(v, x, cond)
    with torch.no_grad():
        z = port.reverse(torch.from_numpy(x), tcond).numpy()
        g, ld = port(torch.from_numpy(x), tcond)
        emb = port.embed(tcond).numpy()
    np.testing.assert_allclose(z, np.asarray(ref_z), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), **TOL)
    ref_emb = jax.jit(lambda v, c: jm.apply(v, c, method=jm.embed))(v, cond)
    np.testing.assert_allclose(emb, np.asarray(ref_emb), **TOL)
    assert emb.shape == (3, 8 + (30 if control else 0))
