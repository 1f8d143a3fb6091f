"""The port's stage-1 training step against the JAX package at 17 frames, on
the CPU: the tiny preset with ``upsample_t [2, 1]`` (16 generated frames),
the encoder's temporal strides all 2 (so that 16 frames reduce to one time
step at its 32 px) and ``subsample_length`` 12, so that the temporal discriminator sees a
12-frame subsample from a drawn start, the same for the fake and the real
clips, as at the full BAIR preset. At 9 frames that branch never runs
(``test_torch_port_stage1_step.py``). One step with the gate closed and one
with it open, compared by that file's ``test_step_*`` functions, which run
here on this module's world.
"""

import jax
import pytest

from image2video_synthesis_using_cinns_tpu.testing import PRESETS
from test_torch_port_stage1_step import (  # noqa: F401 (fixtures and tests run here too)
    World,
    step,
    test_step_autoencoder_moment_through_the_vae_phase,
    test_step_discriminator_moments,
    test_step_gate,
    test_step_generated_clips,
    test_step_metrics,
    test_step_optimizer_state_layout,
    test_step_parameters,
    test_step_spectral_vectors,
    test_step_variable_layout,
    two_threads,
)

P17 = dict(PRESETS["tiny"], seq_length=17, upsample_t=[2, 1], enc_stride_t=[2, 2, 2, 2])


@pytest.fixture(scope="module")
def world():
    w = World(P17, seed=20)
    assert w.seq.shape[1] - 1 == 16 and int(w.opt.Training["subsample_length"]) == 12
    # the step's key 7 draws the subsample start 3 (of 0..4): not the trivial window
    assert w.draws(jax.random.PRNGKey(7)).start == 3
    return w
