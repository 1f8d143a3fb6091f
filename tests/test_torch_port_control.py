"""The torch port's endpoint-control sampling at the ``Model`` level against the
JAX package's, on the CPU.

Both load the same control checkpoint directory
(``make_model_dir(preset='tiny', control=True)``) and get the same x0, end
positions and residual nu: ``Model.forward(x0, cond, residual)`` quantises the
positions into the one-hot bins appended to the embedding, and the flow's
'cond' blocks see the embedding alone. The port also reproduces the JAX
package's fixed-seed snapshot ``tests/golden/tiny_control_v1.npz``, which it
only reads.

Tolerances, as the sampling test's: 1e-4 for the plain fp32 path, 2e-3 with
``use_kernel`` / ``use_pallas`` (bf16 weights on both sides, sums in another
order), and the snapshot's own 2e-2 (stored in fp16).
"""

import os

import numpy as np
import pytest

from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu.testing import make_model_dir
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_control_v1.npz")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    # seed 1234: the checkpoint the golden snapshot was taken from
    return make_model_dir(str(tmp_path_factory.mktemp("ckpts")), preset="tiny", seed=1234,
                          control=True) + "/"


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    residual = rng.standard_normal((2, 16)).astype(np.float32)
    return x0, cond, residual


@pytest.mark.parametrize("use_kernel", [False, True])
def test_control_forward_matches_jax(model_dir, use_kernel):
    x0, cond, residual = _inputs(seed=9)
    ref = np.asarray(JaxModel(model_dir, vid_length=8, use_pallas=use_kernel)
                     .forward(x0, cond, residual=residual))
    port = Model(model_dir, vid_length=8, use_kernel=use_kernel, device="cpu")
    assert port.flow.control
    vid = port.forward(x0, cond, residual).numpy()
    assert vid.shape == ref.shape == (2, 8, 3, 32, 32)
    tol = 2e-3 if use_kernel else 1e-4
    np.testing.assert_allclose(vid, ref, rtol=tol, atol=tol)


def test_golden_control_snapshot(model_dir):
    """Fixed-seed snapshot (seed 1234, rng 44) of the JAX package, read only."""
    assert os.path.exists(GOLDEN), "tests/golden/tiny_control_v1.npz is missing"
    x0, cond, residual = _inputs(seed=44)
    vid = Model(model_dir, vid_length=8, use_kernel=False, device="cpu").forward(
        x0, cond, residual).numpy()
    ref = np.load(GOLDEN)["vid"].astype(np.float32)
    assert vid.shape == ref.shape
    np.testing.assert_allclose(vid, ref, rtol=2e-2, atol=2e-2)
