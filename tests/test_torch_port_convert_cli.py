"""The port's ``cli/convert_weights.py`` against the JAX package's
``scripts/convert_weights.py``, on the CPU, both run in-process.

* Every kind: on the same reference-layout source, the port writes the same
  ``.msgpack`` bytes to the same default destination and prints the same
  lines (the integrity check's among them). The metric backbones are full
  size, the model families tiny.
* ``model_dir`` on a tiny reference directory: the same four files, a second
  run converts nothing, and the port's ``Model`` on its converted directory
  gives the JAX ``Model``'s video on the JAX-converted one (same residual,
  fp32 paths: ``test_torch_port_model.py``'s 1e-4), and bitwise the video of
  a ``Model`` given the source modules' weights directly.
* The integrity check against ``fetch_weights.verify``: the same md5
  recorded on first use, and the same refusals.
"""

import contextlib
import io
import os
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch import testing as tt
from image2video_synthesis_using_cinns_tpu_torch.cli import convert_weights as tcw
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.patch_disc import (
    NLayerDiscriminator)
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Discriminator
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.biggan import BigAE
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.utils import convert as TC
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TOL = 1e-4  # fp32 serving paths of both packages (test_torch_port_model.py)
AE = {"deterministic": False, "in_size": 64, "norm": "bn", "encoder_type": "resnet18",
      "use_actnorm_in_dec": False, "z_dim": 64, "pre_process": False, "pretrained": False,
      "chn": 8}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Reference-layout sources under ``<root>/src``, each kind's CLI argv."""
    root = tmp_path_factory.mktemp("sources")
    src = root / "src"
    ref = Path(tt.make_reference_model_dir(str(root / "dir"), "tiny", seed=5)).parent
    stage2, ae = ref / "stage2", ref / "AE"
    src.mkdir()
    shutil.copy(ref / "stage1" / "best_PFVD_GEN.pth", src / "gen.pth")
    shutil.copy(ref / "stage1" / "best_PFVD_ENC.pth", src / "enc.pth")
    shutil.copy(stage2 / "cINN.pth", src / "cinn.pth")
    shutil.copy(ae / "Encoder_stage2.pth", src / "ae_enc.pth")
    shutil.copy(ae / "config_stage2_AE.yaml", src / "ae.yaml")
    torch.manual_seed(6)
    patch = {"in_channels": 3, "ndf": 16, "n_layers": 3, "use_actnorm": True,
             "spectral_norm": True}
    temporal = {"res_type_encoder": "resnet18", "use_max_pool": True, "spectral_norm": True,
                "channels": [16, 16, 32, 32, 32], "stride_t": [2, 2, 2, 2],
                "stride_s": [1, 1, 2, 1]}
    TC.save_reference(str(src / "disc_t.pth"), TC.to_reference(
        TC.convert_stage1_discriminator, TC.to_variables(
            Discriminator.from_config(temporal).state_dict())), wrap=True)
    TC.save_reference(str(src / "disc_s.pth"), TC.to_reference(
        TC.convert_patch_discriminator, ts1.variables(NLayerDiscriminator.from_config(patch))),
        wrap=True)
    TC.save_reference(str(src / "bigae.pth"), TC.to_reference(
        TC.convert_bigae, ts1.variables(BigAE(AE)), AE))
    tcfg.save({"AE": AE}, str(src / "bigae.yaml"))
    for kind, name in (("i3d", "model_rgb.pth"), ("dti3d16", "I3D_16.pth.tar"),
                       ("fid", "pt_inception-2015-12-05-6726825d.pth"), ("i3d_tf", "tf_i3d.npz"),
                       ("lpips", "vgg.pth")):
        tt.write_reference_backbone(kind, str(src / name), seed=7,
                                    vgg_path=str(src / "vgg16-397923af.pth"))
    argv = {
        "generator": ["--src", "src/gen.pth"], "encoder": ["--src", "src/enc.pth"],
        "disc_t": ["--src", "src/disc_t.pth"], "disc_s": ["--src", "src/disc_s.pth"],
        "cinn": ["--src", "src/cinn.pth", "--n_flows", "4", "--z_dim", "16",
                 "--embedding_dim", "16"],
        "ae_encoder": ["--src", "src/ae_enc.pth", "--config", "src/ae.yaml"],
        "bigae": ["--src", "src/bigae.pth", "--config", "src/bigae.yaml", "--dst", "out/ae.msgpack"],
        "i3d": ["--src", "src/model_rgb.pth"], "dti3d16": ["--src", "src/I3D_16.pth.tar"],
        "dti3d32": ["--src", "src/I3D_16.pth.tar"],
        "fid": ["--src", "src/pt_inception-2015-12-05-6726825d.pth"],
        "i3d_tf": ["--src", "src/tf_i3d.npz"],
        "lpips": ["--src", "src/vgg.pth", "--vgg", "src/vgg16-397923af.pth"],
    }
    return root, argv


def run_jax(argv: list[str], monkeypatch) -> str:
    """``python scripts/convert_weights.py ARGV`` in this process: its stdout."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(SCRIPTS / "convert_weights.py"), run_name="__main__")
    return out.getvalue()


def run_port(argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcw.main(argv)
    return out.getvalue()


def _written(d: Path) -> dict:
    return {p.relative_to(d): p.read_bytes() for p in d.rglob("*.msgpack")}


@pytest.mark.parametrize("kind", [
    "generator", "encoder", "disc_t", "disc_s", "cinn", "ae_encoder", "bigae",
    "i3d", "dti3d16", "dti3d32", "fid", "i3d_tf", "lpips"])
def test_cli_kind_writes_the_jax_bytes(kind, sources, monkeypatch, tmp_path):
    """Synthetic files cannot match a published checksum, so both registries
    trust the sources on first use here (each run records into its own
    ``models/CHECKSUMS.json``); the refusals are held below."""
    root, argv = sources
    monkeypatch.syspath_prepend(str(SCRIPTS))
    import fetch_weights

    for name in ("fid", "lpips", "vgg16"):
        monkeypatch.setitem(fetch_weights.WEIGHTS, name, dict(
            fetch_weights.WEIGHTS[name], md5=None, sha256_prefix=None))
        monkeypatch.setitem(tcw.WEIGHTS, name, {})
    outs, files = [], []
    for who in ("jax", "port"):
        d = tmp_path / who  # the sources hard-linked: default destinations lie beside them
        shutil.copytree(root / "src", d / "src", copy_function=os.link)
        monkeypatch.chdir(d)
        outs.append(run_jax([kind] + argv[kind], monkeypatch) if who == "jax"
                    else run_port([kind] + argv[kind]))
        files.append(_written(d))
    assert outs[0] == outs[1] and "wrote" in outs[1]
    assert files[0].keys() == files[1].keys() and len(files[1]) == 1
    assert all(files[0][k] == files[1][k] for k in files[0])
    if kind in tcw.REGISTRY_NAME:  # the trust-on-first-use record or a published checksum
        assert "integrity OK" in outs[1]


def test_model_dir_serves_like_jax(tmp_path, monkeypatch):
    ref = Path(tt.make_reference_model_dir(str(tmp_path / "port"), "tiny", seed=11)).parent
    shutil.copytree(ref, tmp_path / "jax")
    port_dir, jax_dir = ref / "stage2", tmp_path / "jax" / "stage2"
    out_port = run_port(["model_dir", "--src", str(port_dir)])
    # the yamls name their own root: point the copy's chain at the copy
    for yaml_path in jax_dir.glob("*.yaml"):
        yaml_path.write_text(yaml_path.read_text().replace(str(tmp_path / "port"),
                                                           str(tmp_path / "jax")))
    out_jax = run_jax(["model_dir", "--src", str(jax_dir)], monkeypatch)
    assert out_port.replace("/port/", "/jax/") == out_jax and out_port.count("wrote") == 4
    ours, theirs = _written(tmp_path / "port"), _written(tmp_path / "jax")
    assert ours.keys() == theirs.keys() and len(ours) == 4
    assert all(ours[k] == theirs[k] for k in ours)
    assert run_port(["model_dir", "--src", str(port_dir)]) == \
        "nothing to convert (already converted or no .pth found)\n"

    rng = np.random.default_rng(7)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    residual = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(JaxModel(str(jax_dir) + "/", vid_length=8, use_pallas=False)
                      .forward(x0, residual=residual))
    got = Model(str(port_dir) + "/", vid_length=8, use_kernel=False, device="cpu").forward(
        x0, residual=residual).numpy()
    assert got.shape == want.shape == (2, 8, 3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # and exactly the video of the source modules' weights, given directly
    direct = tt.reference_model("tiny", 11, 8, use_kernel=False, device="cpu")
    np.testing.assert_array_equal(got, direct.forward(x0, residual=residual).numpy())


def test_integrity_check_matches_fetch_weights(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(SCRIPTS))
    import fetch_weights

    f = tmp_path / "model_rgb.pth"
    f.write_bytes(os.urandom(4096))
    roots = {who: tmp_path / who for who in ("port", "jax")}
    verify = {"port": tcw.verify, "jax": fetch_weights.verify}
    printed = {}
    for who in roots:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            md5 = verify[who]("pi3d", str(f), str(roots[who]))
        printed[who] = out.getvalue()
        assert md5 == fetch_weights.md5_file(str(f))
    assert printed["port"] == printed["jax"] and "trust-on-first-use" in printed["port"]
    assert (roots["port"] / tcw.CHECKSUMS).read_text() == \
        (roots["jax"] / fetch_weights.CHECKSUMS).read_text()
    f.write_bytes(os.urandom(4096))
    bad = tmp_path / "pt_inception-2015-12-05-6726825d.pth"
    bad.write_bytes(b"not the weights")
    for who in roots:
        with pytest.raises(ValueError, match="previously recorded"):
            verify[who]("pi3d", str(f), str(roots[who]))
        with pytest.raises(ValueError, match="!= expected d507d7349b931f0638a25a48a722f98a"):
            verify[who]("lpips", str(f), str(roots[who]))
        with pytest.raises(ValueError, match="does not match expected prefix 6726825d"):
            verify[who]("fid", str(bad), str(roots[who]))
    monkeypatch.chdir(roots["port"])
    with pytest.raises(ValueError, match="previously recorded"):
        run_port(["i3d", "--src", str(f)])
    assert not list(roots["port"].rglob("*.msgpack"))
