"""The port's materialised scorers against the JAX package's, on the CPU:
the Fréchet helpers, ``calculate_FVD`` (kinetics, DT-16, DT-32, both input
ranges), ``compute_fvd_official_protocol``, ``calculate_FID``,
``compute_lpips`` and the three diversity scorers.

The backbones are ``test_torch_port_eval.py``'s stand-ins, injected into
both packages' loaders; the protocol code (the 224 resize and
denormalisation, DT tiling, every tail drop, the regroupings, the
reductions) runs as it is. Every population is cut: batch sizes that do not
divide the sets, 33 and 21 items for the x16 regrouping. Tolerances as in
``test_torch_port_eval.py``: rtol 1e-4 for the Fréchet values (float64 on
activations that agree to float32 rounding), 1e-5 for LPIPS and the
diversities. The Fréchet helpers run in float64 on both sides (JAX with
x64 on), held to 1e-10. The VGG diversity runs the real VGG16 at 224 px,
with the JAX ``PRNGKey(0)`` init carried over; without weights it is the
stream's seeded VGG (1e-5 against ``DiversityStream``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.metrics import diversity as jdiv
from image2video_synthesis_using_cinns_tpu.metrics import fid as jfid
from image2video_synthesis_using_cinns_tpu.metrics import frechet as jfrechet
from image2video_synthesis_using_cinns_tpu.metrics import fvd as jfvd
from image2video_synthesis_using_cinns_tpu.metrics import lpips_eval as jlpips
from image2video_synthesis_using_cinns_tpu_torch.metrics import diversity as tdiv
from image2video_synthesis_using_cinns_tpu_torch.metrics import fid as tfid
from image2video_synthesis_using_cinns_tpu_torch.metrics import frechet as tfrechet
from image2video_synthesis_using_cinns_tpu_torch.metrics import fvd as tfvd
from image2video_synthesis_using_cinns_tpu_torch.metrics import lpips_eval as tlpips
from image2video_synthesis_using_cinns_tpu_torch.metrics import streaming_eval as tstream
from test_torch_port_eval import _jax_vgg_variables, stand_ins  # noqa: F401
from test_torch_port_stage1_step import two_threads  # noqa: F401


def _uniform(seed, shape, lo=-1.0, hi=1.0):
    """Uniform in [lo, hi], each item (and realisation) shrunk towards the
    range's middle by its own factor in [0.3, 1]: uniform clips alone barely
    move the stand-ins' pooled statistics, and scores near 0 would leave a
    relative bound nothing to hold."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    lead = shape[:2] if len(shape) == 6 else shape[:1]
    x *= rng.uniform(0.3, 1.0, lead + (1,) * (len(shape) - len(lead)))
    return (lo + (x + 1.0) * (hi - lo) / 2).astype(np.float32)


def _cl(videos):
    """(N, T, C, H, W) -> the JAX package's channels-last (N, T, H, W, C)."""
    return np.transpose(videos, (0, 1, 3, 4, 2))


def test_frechet_helpers_match_jax():
    rng = np.random.default_rng(1)
    a1 = rng.standard_normal((40, 8))
    a2 = rng.standard_normal((50, 8)) @ rng.standard_normal((8, 8)) * 0.5 + 0.3
    with jax.enable_x64(True):
        want = [jfrechet.activation_statistics(jnp.asarray(a)) for a in (a1, a2)]
        want_tr = float(jfrechet.trace_sqrt_product(want[0][1], want[1][1]))
        want_d = float(jfrechet.frechet_distance(*want[0], *want[1]))
    got = [tfrechet.activation_statistics(a) for a in (a1, a2)]
    for (gm, gs), (wm, ws) in zip(got, want):
        assert gm.dtype == gs.dtype == np.float64
        np.testing.assert_allclose(gm, np.asarray(wm), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-10, atol=1e-12)
    assert tfrechet.trace_sqrt_product(got[0][1], got[1][1]) == pytest.approx(want_tr, rel=1e-10)
    assert tfrechet.frechet_distance(*got[0], *got[1]) == pytest.approx(want_d, rel=1e-10)
    assert tfrechet.frechet_from_activations(a1, a2) == pytest.approx(
        jfrechet.frechet_from_activations(a1, a2), rel=1e-10)
    assert tfrechet.frechet_from_activations(a1, a2) == pytest.approx(want_d, rel=1e-10)


@pytest.mark.parametrize("kind,frames,batch,input_range", [
    ("kinetics", 8, 8, (-1.0, 1.0)), ("kinetics", 8, 7, (0.0, 1.0)),
    ("dt16", 6, 10, (-1.0, 1.0)), ("dt32", 32, 6, (-1.0, 1.0))])
def test_calculate_fvd_matches_jax(stand_ins, kind, frames, batch, input_range):
    """21 and 21 clips (17 at 32 frames); DT-16 tiles 6 frames to 16, DT-32
    takes 32."""
    lo, hi = input_range
    n = 17 if frames == 32 else 21
    fake = _uniform(3, (n, frames, 3, 24, 24), lo, hi)
    real = _uniform(4, (n, frames, 3, 24, 24), lo, hi)
    want = jfvd.calculate_FVD(jfvd.load_model(kind), _cl(fake), _cl(real), batch, input_range)
    got = tfvd.calculate_FVD(tfvd.load_model(kind, device="cpu"), torch.from_numpy(fake), real,
                             batch, input_range)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_official_protocol_matches_jax(stand_ins):
    """Two groups of 16 clips, the CLI's (G, 16, T, C, H, W)."""
    fake = _uniform(5, (2, 16, 8, 3, 24, 24))
    real = _uniform(6, (2, 16, 8, 3, 24, 24))
    want = jfvd.compute_fvd_official_protocol(fake, real)
    got = tfvd.compute_fvd_official_protocol(fake, real, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_calculate_fid_matches_jax(stand_ins):
    """130 frames in batches of 50: 100 scored, the count 130 returned."""
    gen, orig = _uniform(7, (130, 3, 24, 24)), _uniform(8, (130, 3, 24, 24))
    want, n_want = jfid.calculate_FID(jfid.load_inception(), gen, orig)
    got, n_got = tfid.calculate_FID(tfid.load_inception(), torch.from_numpy(gen), orig)
    assert n_got == n_want == 130
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("n,batch", [(37, 10), (6, 10)])
def test_compute_lpips_matches_jax(stand_ins, n, batch):
    """Whole batches only (37 pairs: 3 batches); fewer pairs than a batch give 0."""
    pd, gt = _uniform(9, (n, 3, 16, 16)), _uniform(10, (n, 3, 16, 16))
    want = jlpips.compute_lpips(pd, gt, batch)
    got = tlpips.compute_lpips(pd, gt, batch, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got == 0.0) == (n < batch)


@pytest.mark.parametrize("frames", [6, 17])
def test_i3d_diversities_match_jax(stand_ins, frames):
    """33 items of 2 realisations of 6 frames (I3D keeps 32 items, DT-I3D
    tiles them to 16 frames and keeps 20 in batches of 20); 17 items of 3 of
    17 frames (the DT-32 net, without tiling; I3D keeps 16)."""
    shape = (33, 2, 6, 3, 24, 24) if frames == 6 else (17, 3, 17, 3, 24, 24)
    seq = _uniform(11, shape)
    n = shape[1]
    np.testing.assert_allclose(tdiv.compute_I3D_diversity(torch.from_numpy(seq), n, device="cpu"),
                               jdiv.compute_I3D_diversity(seq, n), rtol=1e-5)
    np.testing.assert_allclose(tdiv.compute_DTI3D_diversity(seq, device="cpu"),
                               jdiv.compute_DTI3D_diversity(seq), rtol=1e-5)


def test_vgg_diversity_matches_jax_and_the_stream():
    videos = _uniform(12, (2, 2, 1, 3, 24, 24))
    variables = _jax_vgg_variables()
    want = jdiv.compute_vgg_diversity(videos, variables)
    got = tdiv.compute_vgg_diversity(torch.from_numpy(videos), variables, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    one = videos[:1]
    stream = tstream.DiversityStream(2, want_vgg=True, seq_length=1, device="cpu")
    stream.add_batch(one)
    np.testing.assert_allclose(tdiv.compute_vgg_diversity(one, device="cpu"),
                               stream.results()["VGG"], rtol=1e-5)


def test_scorers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    videos = _uniform(13, (1, 2, 2, 3, 8, 8))
    for score in (lambda: tdiv.compute_vgg_diversity(videos),
                  lambda: tlpips.compute_lpips(videos[0, 0], videos[0, 1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score()
