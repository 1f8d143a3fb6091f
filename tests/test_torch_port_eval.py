"""The port's offline evaluation against the JAX package's, on the CPU.

* Both streams against the JAX streams, with the same stand-in backbones
  injected into both packages (as ``tests/test_streaming_eval.py`` does):
  deterministic projections of pooled pixel statistics, which are the same
  numbers in either layout. The protocol code (the 224 resize and
  denormalisation, DT tiling, batching, every tail-drop population, the
  reductions) runs as it is. N = 37 hits every tail drop: FID keeps 550 of
  592 frames, LPIPS 59 batches of 10, FVD 32 clips, DTFVD 37, diversity I3D
  32 items, DT-I3D 20. rtol 1e-4 for the Fréchet values (float64 on
  activations that agree to float32 rounding), 1e-5 for LPIPS and diversity.
* The VGG diversity with the real VGG16 on both sides, the port's VGG loaded
  with the JAX stream's ``PRNGKey(0)`` init through the weight bridge, 1e-5.
* Both port CLIs in-process with ``-device cpu`` on the tiny preset beside
  the JAX CLIs, the same residuals injected into both facades and the flow
  kernels off on both sides (their fp32 videos agree to 1e-4): the printed
  scores agree to 1e-3 relative.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image2video_synthesis_using_cinns_tpu.models.facade as jfacade
import image2video_synthesis_using_cinns_tpu_torch.models.facade as tfacade
from image2video_synthesis_using_cinns_tpu.metrics import fid as jfid
from image2video_synthesis_using_cinns_tpu.metrics import fvd as jfvd
from image2video_synthesis_using_cinns_tpu.metrics import lpips_eval as jlpips
from image2video_synthesis_using_cinns_tpu.metrics import streaming_eval as jstream
from image2video_synthesis_using_cinns_tpu.models.backbones.vgg16 import VGG16Features as JVGG
from image2video_synthesis_using_cinns_tpu.testing import make_bair_data_dir
from image2video_synthesis_using_cinns_tpu_torch.cli import eval_diversity, eval_synthesis_quality
from image2video_synthesis_using_cinns_tpu_torch.metrics import fid as tfid
from image2video_synthesis_using_cinns_tpu_torch.metrics import fvd as tfvd
from image2video_synthesis_using_cinns_tpu_torch.metrics import lpips_eval as tlpips
from image2video_synthesis_using_cinns_tpu_torch.metrics import streaming_eval as tstream
from image2video_synthesis_using_cinns_tpu_torch.models.backbones.vgg16 import VGG16Features
from image2video_synthesis_using_cinns_tpu_torch.utils import convert
from test_torch_port_stage1_step import two_threads  # noqa: F401
from test_torch_port_model_dir import make_model_dir
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

KIND_SEEDS = {"kinetics": 3, "dt16": 4, "dt32": 5}


def _weights(d_out, seed):
    return np.random.default_rng(seed).standard_normal((4, d_out)).astype(np.float32)


class _JaxStandIn:
    """Projects (mean, std, mean |x|, max) of each sample through a fixed matrix."""

    def __init__(self, d_out, seed, tuple_out=False):
        self.w, self.tuple_out = jnp.asarray(_weights(d_out, seed)), tuple_out

    def apply(self, variables, x):
        flat = x.reshape(x.shape[0], -1)
        pooled = jnp.stack([flat.mean(1), flat.std(1), jnp.abs(flat).mean(1), flat.max(1)], 1)
        out = pooled @ self.w
        return (out, out) if self.tuple_out else out


class _TorchStandIn(torch.nn.Module):
    def __init__(self, d_out, seed, tuple_out=False):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(_weights(d_out, seed)))
        self.tuple_out = tuple_out

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1)
        pooled = torch.stack([flat.mean(1), flat.std(1, correction=0), flat.abs().mean(1),
                              flat.amax(1)], 1)
        out = pooled @ self.w
        return (out, out) if self.tuple_out else out


class _JaxLPIPS:
    def apply(self, variables, a, b):
        return jnp.mean(jnp.abs(a - b), axis=(1, 2, 3))


def _torch_lpips(a, b):
    return (a - b).abs().mean(dim=(1, 2, 3))


@pytest.fixture()
def stand_ins(monkeypatch):
    """The same stand-in backbones in both packages' metric loaders."""
    monkeypatch.setattr(jfvd, "load_model", lambda kind="kinetics", weights_root="models":
                        jfvd.I3DModel(_JaxStandIn(64, KIND_SEEDS[kind], kind == "kinetics"),
                                      {}, kind))
    monkeypatch.setattr(tfvd, "load_model", lambda kind="kinetics", weights_root="models",
                        device=None: tfvd.I3DModel(
                            _TorchStandIn(64, KIND_SEEDS[kind], kind == "kinetics"), kind))
    monkeypatch.setattr(jfid, "load_inception", lambda *a, **k: (_JaxStandIn(48, 7), {}))
    monkeypatch.setattr(tfid, "load_inception", lambda *a, **k: _TorchStandIn(48, 7))
    monkeypatch.setattr(jlpips, "load_lpips", lambda *a, **k: (_JaxLPIPS(), {}))
    monkeypatch.setattr(tlpips, "load_lpips", lambda *a, **k: _torch_lpips)


@pytest.mark.parametrize("seq_length,n", [(16, 37), (32, 21)])
def test_synthesis_stream_matches_jax(stand_ins, seq_length, n):
    """All four metrics, N clips in batches of 6 (a ragged last batch); DT-16
    below 17 frames, DT-32 above (its clips need 32 frames; N = 21 keeps 16
    for FVD, 21 for DTFVD, 650 frames for FID)."""
    rng = np.random.default_rng(11)
    t = 16 if seq_length == 16 else 32
    fake = rng.uniform(-1, 1, (n, t, 3, 24, 24)).astype(np.float32)
    real = rng.uniform(-1, 1, (n, t, 3, 24, 24)).astype(np.float32)
    kw = dict(want_fid=True, want_lpips=True, want_fvd=True, want_dtfvd=True,
              seq_length=seq_length)
    js = jstream.SynthesisQualityStream(**kw)
    ts = tstream.SynthesisQualityStream(**kw, device="cpu")
    for lo in range(0, n, 6):
        js.add_batch(fake[lo:lo + 6], real[lo:lo + 6])
        ts.add_batch(torch.from_numpy(fake[lo:lo + 6]), real[lo:lo + 6])
    want, got = js.results(), ts.results()
    assert set(got) == set(want) == {"FID", "LPIPS", "FVD", "DTFVD"}
    for name in ("FID", "FVD", "DTFVD"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["LPIPS"], want["LPIPS"], rtol=1e-5)
    assert ts.activations("FVD")[0].shape == (n, 64)
    assert ts.retained_bytes == js.retained_bytes


def test_diversity_stream_matches_jax(stand_ins):
    """I3D and DT-I3D diversity, N = 37 items of 3 realisations."""
    rng = np.random.default_rng(13)
    stack = rng.uniform(-1, 1, (37, 3, 16, 3, 24, 24)).astype(np.float32)
    js = jstream.DiversityStream(3, want_i3d=True, want_dti3d=True, seq_length=16)
    ts = tstream.DiversityStream(3, want_i3d=True, want_dti3d=True, seq_length=16,
                                 device="cpu")
    for lo in range(0, 37, 6):
        js.add_batch(stack[lo:lo + 6])
        ts.add_batch(torch.from_numpy(stack[lo:lo + 6]))
    want, got = js.results(), ts.results()
    assert set(got) == set(want) == {"I3D", "DTI3D"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)
    with pytest.raises(ValueError):
        ts.add_batch(stack[:2, :2])


def _jax_vgg_variables():
    """The JAX diversity stream's VGG init (``PRNGKey(0)`` at 224 px)."""
    return jax.jit(JVGG().init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)))


def _vgg_like_jax(device):
    vgg = VGG16Features()
    vgg.load_state_dict(convert.to_state_dict(_jax_vgg_variables()))
    return vgg.to(device).eval()


def test_vgg_diversity_matches_jax(monkeypatch):
    """The real VGG16 at 224 px on both sides, with JAX's init carried over;
    ragged batches of 3 + 1 videos, 2 realisations of 3 frames."""
    rng = np.random.default_rng(14)
    stack = rng.uniform(-1, 1, (4, 2, 3, 3, 24, 24)).astype(np.float32)
    monkeypatch.setattr(tstream, "vgg_features", _vgg_like_jax)
    js = jstream.DiversityStream(2, want_vgg=True, seq_length=3)
    ts = tstream.DiversityStream(2, want_vgg=True, seq_length=3, device="cpu")
    for lo in (0, 3):
        js.add_batch(stack[lo:lo + 3])
        ts.add_batch(stack[lo:lo + 3])
    np.testing.assert_allclose(ts._vgg_scores, js._vgg_scores, rtol=1e-5)
    np.testing.assert_allclose(ts.results()["VGG"], js.results()["VGG"], rtol=1e-5)


def test_vgg_init_is_seeded():
    a, b = tstream.vgg_features("cpu"), tstream.vgg_features("cpu")
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())


# ---------------------------------------------------------------------------
# the CLIs


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    ckpt = make_model_dir(str(root / "ckpt"), preset="tiny") + "/"
    synth = make_bair_data_dir(str(root / "synth") + "/", n_videos=16, modes=("test",))
    div = make_bair_data_dir(str(root / "div") + "/", n_videos=4, modes=("test",))
    return ckpt, synth, div


@pytest.fixture()
def same_residuals(monkeypatch):
    """Both facades draw their residuals from one shared numpy stream, in call
    order, and run the plain flow (kernels off)."""
    rng = {"jax": np.random.default_rng(21), "port": np.random.default_rng(21)}
    j_forward, j_init, t_init = jfacade.Model.forward, jfacade.Model.__init__, tfacade.Model.__init__

    def draw(side, b):
        return rng[side].standard_normal((b, 16)).astype(np.float32)

    monkeypatch.setattr(jfacade.Model, "__init__",
                        lambda self, *a, **k: j_init(self, *a, **dict(k, use_pallas=False)))
    monkeypatch.setattr(tfacade.Model, "__init__",
                        lambda self, *a, **k: t_init(self, *a, **dict(k, use_kernel=False)))
    monkeypatch.setattr(jfacade.Model, "draw_residual", lambda self, b: jnp.asarray(draw("jax", b)))
    monkeypatch.setattr(tfacade.Model, "draw_residual",
                        lambda self, b: torch.from_numpy(draw("port", b)).to(self.device))
    monkeypatch.setattr(jfacade.Model, "forward", lambda self, x, cond=None, residual=None: j_forward(
        self, x, cond, self.draw_residual(x.shape[0]) if residual is None else residual))


def _lines(out: str, prefix: str) -> list[str]:
    return [ln for ln in out.splitlines() if prefix in ln]


def test_eval_synthesis_quality_cli_matches_jax(tiny_dirs, stand_ins, same_residuals,
                                                monkeypatch, capsys):
    import eval_synthesis_quality as root_cli

    ckpt, data, _ = tiny_dirs
    flags = ["-dataset", "bair", "-ckpt_path", ckpt, "-data_path", data, "-seq_length", "4",
             "-bs", "6", "-FID", "1", "-LPIPS", "1", "-FVD", "1", "-DTFVD", "1"]
    monkeypatch.setattr(sys, "argv", ["eval_synthesis_quality.py"] + flags)
    root_cli.main()
    want = capsys.readouterr().out
    eval_synthesis_quality.main(flags + ["-device", "cpu"])
    got = capsys.readouterr().out
    w, g = _lines(want, "score of"), _lines(got, "score of")
    assert [ln.split(" score of ")[0] for ln in g] == ["FID", "LPIPS", "DTFVD", "FVD"]
    assert [ln.split(" score of ")[0] for ln in w] == [ln.split(" score of ")[0] for ln in g]
    for a, b in zip(g, w):
        x, y = float(a.rsplit(" ", 1)[1]), float(b.rsplit(" ", 1)[1])
        assert np.isfinite(x) and abs(x - y) <= 1e-3 * abs(y), (a, b)
    assert _lines(got, "Evaluate") == _lines(want, "Evaluate")


def test_eval_diversity_cli_matches_jax(tiny_dirs, stand_ins, same_residuals, monkeypatch,
                                        capsys):
    import eval_diversity as root_cli

    ckpt, _, data = tiny_dirs
    monkeypatch.setattr(tstream, "vgg_features", _vgg_like_jax)
    flags = ["-dataset", "bair", "-ckpt_path", ckpt, "-data_path", data, "-seq_length", "4",
             "-bs", "3", "-n_realiz", "2", "-VGG", "1", "-DTI3D", "1"]
    monkeypatch.setattr(sys, "argv", ["eval_diversity.py"] + flags)
    root_cli.main()
    want = _lines(capsys.readouterr().out, "Diversity score of")
    eval_diversity.main(flags + ["-device", "cpu"])
    got = _lines(capsys.readouterr().out, "Diversity score of")
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        x, y = float(a.split(" ")[3]), float(b.split(" ")[3])
        assert a.split(" ")[4:] == b.split(" ")[4:]
        assert np.isfinite(x) and abs(x - y) <= 1e-3 * abs(y), (a, b)


@pytest.fixture(scope="module")
def one_device_scores():
    """Each CLI's printed scores on one device, by CLI, made once for both
    multi-device cases."""
    return {}


@pytest.mark.parametrize("flag", [["-spatial_shard", "2", "-data_parallel"], ["-spatial_shard", "2"]])
@pytest.mark.parametrize("cli", [eval_synthesis_quality, eval_diversity])
def test_multi_device_flags_serve(cli, flag, tiny_dirs, stand_ins, one_device_scores,
                                  monkeypatch, capsys):
    """``-spatial_shard 2``, alone (the first two of four CPU devices) or
    beside ``-data_parallel`` (a 2 x 2 grid), prints the scores one device
    prints, to 1e-3."""
    from image2video_synthesis_using_cinns_tpu_torch.models import facade
    from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_mesh

    ckpt, synth, div = tiny_dirs
    monkeypatch.setattr(facade, "make_mesh", lambda: make_mesh(devices=["cpu"] * 4))
    if cli is eval_diversity:  # the stand-in backbones: VGG16 is not on the decoder's path
        data, prefix, field = div, "Diversity score of", 3
        flags = ["-bs", "3", "-n_realiz", "2", "-DTI3D", "1"]
    else:
        data, prefix, field = synth, "score of", -1
        flags = ["-bs", "6", "-FID", "1", "-LPIPS", "1", "-FVD", "1", "-DTFVD", "1"]
    args = ["-dataset", "bair", "-data_path", data, "-ckpt_path", ckpt, "-seq_length", "4",
            "-device", "cpu", *flags]
    if cli not in one_device_scores:
        capsys.readouterr()
        cli.main(args)
        one_device_scores[cli] = _lines(capsys.readouterr().out, prefix)
    want = one_device_scores[cli]
    cli.main(args + flag)
    got = _lines(capsys.readouterr().out, prefix)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        x, y = float(a.split(" ")[field]), float(b.split(" ")[field])
        assert np.isfinite(x) and abs(x - y) <= 1e-3 * abs(y), (a, b)


@pytest.mark.parametrize("cli", [eval_synthesis_quality, eval_diversity])
def test_clis_default_to_cuda(cli, tiny_dirs):
    """Without -device the CLIs ask for the card; this CPU-only build has none."""
    ckpt, synth, _ = tiny_dirs
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        cli.main(["-dataset", "bair", "-data_path", synth, "-ckpt_path", ckpt])
