"""The port's reference-checkpoint path against the JAX package's, on the CPU.

* Every reference map: the port's ``convert_*`` and the JAX package's give
  the same tree from the same reference-layout state dict (paths, dtypes,
  shapes, values bitwise), the JAX map consumes every key (its
  ``_Filler.finish`` made strict), the JAX ``merge_into_template(strict=True)``
  takes the tree onto the JAX module's variables, and the tree is the one the
  file was written from (``convert.to_reference`` of a seeded port module).
  The model families come from ``make_reference_model_dir``'s files at the
  tiny preset, the fixed-width backbones at full size.
* ``merge_into_template`` and ``pretrained_init_biggan`` (``AE.pretrained``)
  against the JAX ones, bitwise; the AE trainer's init.
* ``checkpoint.find``/``load`` side by side with the JAX ones on ``.msgpack``,
  ``.pth`` and ``.pth.tar`` stems and the missing-``.msgpack`` fallback; the
  serving loader's refusal of a reference payload.
* ``utils/profiling.py``: ``StepTimer``, and ``annotate`` under a profiler (a span
  nested in its parent in the trace).

The CLI (``cli/convert_weights.py``) is held against the JAX script in
``test_torch_port_convert_cli.py``.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu import testing as jtesting
from image2video_synthesis_using_cinns_tpu.metrics.inception import InceptionV3FID as JInception
from image2video_synthesis_using_cinns_tpu.models.backbones.i3d import I3D as JI3D
from image2video_synthesis_using_cinns_tpu.models.backbones.lpips import LPIPS as JLPIPS
from image2video_synthesis_using_cinns_tpu.models.backbones.vgg16 import VGG16Features as JVGG
from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
from image2video_synthesis_using_cinns_tpu.models.stage1.decoder import Generator as JGenerator
from image2video_synthesis_using_cinns_tpu.models.stage1.patch_disc import (
    NLayerDiscriminator as JPatch)
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Discriminator as JDisc
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
from image2video_synthesis_using_cinns_tpu.models.stage2.biggan import BigAE as JBigAE
from image2video_synthesis_using_cinns_tpu.models.stage2.inn import SupervisedTransformer as JST
from image2video_synthesis_using_cinns_tpu.models.stage2.resnet2d import ResnetEncoder as JRes
from image2video_synthesis_using_cinns_tpu.utils import checkpoint as jckpt
from image2video_synthesis_using_cinns_tpu.utils import convert as JC
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch import testing as tt
from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.patch_disc import (
    NLayerDiscriminator)
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Discriminator
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.biggan import BigAE
from image2video_synthesis_using_cinns_tpu_torch.models.stage2.resnet2d import ResnetEncoder
from image2video_synthesis_using_cinns_tpu_torch.train import stage1 as ts1
from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae as tae
from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as tckpt
from image2video_synthesis_using_cinns_tpu_torch.utils import convert as TC
from image2video_synthesis_using_cinns_tpu_torch.utils import profiling
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

P = jtesting.PRESETS["tiny"]
S1 = jtesting.stage1_config(P)
AE64 = dict(jtesting.stage2_ae_config(jtesting.PRESETS["bair"]).AE, encoder_type="resnet18",
            norm="bn", chn=8)


@pytest.fixture(scope="module")
def ref_dirs(tmp_path_factory):
    """Tiny reference directories (seed 3), plain and with endpoint control."""
    return {c: tt.make_reference_model_dir(str(tmp_path_factory.mktemp(f"ref{int(c)}")),
                                           "tiny", seed=3, control=c)
            for c in (False, True)}


@pytest.fixture
def strict_jax_filler(monkeypatch):
    finish = JC._Filler.finish
    monkeypatch.setattr(JC._Filler, "finish", lambda self, strict=False: finish(self, True))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_same_tree(a, b, what=""):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys(), (what, sorted(set(fa) ^ set(fb))[:5])
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, (what, k)
        assert np.array_equal(fa[k], fb[k]), (what, k)


def jax_template(module, *args, rngs=("params",)):
    """The JAX module's variables tree, as zeros of its shapes (no compile)."""
    keys = {r: jax.random.PRNGKey(i) for i, r in enumerate(rngs)}
    shapes = jax.eval_shape(lambda: module.init(keys, *args))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _model_file(ref_dirs, control, rel, wrapped=False):
    root = os.path.dirname(ref_dirs[control])
    path = os.path.join(root, rel)
    ours, theirs = TC.load_torch_state_dict(path), JC.load_torch_state_dict(path)
    assert ours.keys() == theirs.keys()
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    assert (torch.load(path, weights_only=False).keys() >= {"state_dict"}) == wrapped
    return ours


def _flow_args(control):
    return (P["n_flows"], 2, P["z_dim"], P["cond_z"] + (30 if control else 0), control)


def case(name, ref_dirs):
    """(reference state dict, converter args, the source tree, JAX template
    of the tree's module) for one map."""
    img, z = P["img_size"], P["z_dim"]
    src = tt.reference_sources("tiny", 3, control=name == "cinn_control")
    tree = {k: TC.to_variables(m.state_dict()) for k, m in src.items()}
    if name == "generator":
        sd = _model_file(ref_dirs, False, "stage1/best_PFVD_GEN.pth", wrapped=True)
        tmpl = jax_template(JGenerator.from_config(S1.Decoder), jnp.zeros((1, img, img, 3)),
                            jnp.zeros((1, z)))
        return sd, (), tree["decoder"], tmpl
    if name == "encoder":
        sd = _model_file(ref_dirs, False, "stage1/best_PFVD_ENC.pth", wrapped=True)
        tmpl = jax_template(JEncoder.from_config(S1.Encoder), jnp.zeros((1, 8, img, img, 3)),
                            rngs=("params", "sample"))
        return sd, ("resnet18",), tree["encoder"], tmpl
    if name in ("cinn", "cinn_control"):
        control = name == "cinn_control"
        sd = _model_file(ref_dirs, control, "stage2/cINN.pth")
        s2 = jtesting.stage2_config(P, "s1/", "ae/", control)
        ae = jtesting.stage2_ae_config(P).AE
        cond = [jnp.zeros((1, img, img, 3))] + ([jnp.zeros((1, 3))] if control else [])
        full = jax_template(JST.from_configs(s2, S1.Decoder, ae), jnp.zeros((1, z)), cond)
        tmpl = {"params": full["params"]["flow"], "buffers": full["buffers"]["flow"]}
        return sd, _flow_args(control), tree["flow"], tmpl
    if name == "ae_encoder_in":
        sd = _model_file(ref_dirs, False, "AE/Encoder_stage2.pth")
        tmpl = jax_template(JRes.from_config(jtesting.stage2_ae_config(P).AE),
                            jnp.zeros((1, img, img, 3)))
        return sd, ("resnet18", "in"), tree["embedder"], tmpl
    if name == "ae_encoder_bn":
        torch.manual_seed(4)
        module = ResnetEncoder(z_dim=16, encoder_type="resnet18", norm="bn")
        t = TC.to_variables(module.state_dict())
        tmpl = jax_template(JRes(z_dim=16, encoder_type="resnet18", norm="bn"),
                            jnp.zeros((1, img, img, 3)))
        return TC.to_reference(TC.convert_resnet_encoder, t, "resnet18", "bn"), \
            ("resnet18", "bn"), t, tmpl
    if name == "disc_t":
        torch.manual_seed(5)
        t = TC.to_variables(Discriminator.from_config(S1.Discriminator_Temporal).state_dict())
        tmpl = jax_template(JDisc.from_config(S1.Discriminator_Temporal),
                            jnp.zeros((1, 16, img, img, 3)))
        return TC.to_reference(TC.convert_stage1_discriminator, t, "resnet18"), ("resnet18",), \
            t, tmpl
    if name == "disc_s":
        torch.manual_seed(6)
        t = ts1.variables(NLayerDiscriminator.from_config(S1.Discriminator_Patch))
        t["actnorm_stats"] = jax.tree.map(lambda a: np.ones_like(a), t["actnorm_stats"])
        tmpl = jax_template(JPatch.from_config(S1.Discriminator_Patch),
                            jnp.zeros((1, img, img, 3)))
        return TC.to_reference(TC.convert_patch_discriminator, t), (), t, tmpl
    if name in ("biggan64", "biggan128", "bigae"):
        cfg = AE64 if name != "biggan128" else dict(AE64, in_size=128, z_dim=128)
        torch.manual_seed(7)
        full = ts1.variables(BigAE(cfg))
        tmpl = jax_template(JBigAE(config=cfg), jnp.zeros((1, cfg["in_size"], cfg["in_size"], 3)))
        if name == "bigae":
            return TC.to_reference(TC.convert_bigae, full, cfg), (cfg,), full, tmpl
        t = TC.subtree(full, "decoder_wrap", "decoder")
        size = cfg["in_size"]
        sd = TC.to_reference(TC.convert_biggan_generator, t, size)
        if size == 64:  # the reference's dead attention parameters at 64 px
            sd.update({"attention.gamma": np.zeros((), np.float32),
                       "attention.theta.module.weight_bar": np.ones((96, 768, 1, 1), np.float32)})
        return sd, (size,), t, TC.subtree(tmpl, "decoder_wrap", "decoder")
    module, jmod, args, conv = {
        "i3d": ("i3d", JI3D(num_classes=400), (jnp.zeros((1, 16, 224, 224, 3)),), None),
        "dti3d": ("dti3d16", JI3D(num_classes=18, head="logits", bn_eps=1e-5),
                  (jnp.zeros((1, 16, 224, 224, 3)),), None),
        "i3d_tf": ("i3d_tf", JI3D(num_classes=400), (jnp.zeros((1, 16, 224, 224, 3)),), None),
        "inception": ("fid", JInception(), (jnp.zeros((1, 64, 64, 3)),), None),
        "lpips": ("lpips", JLPIPS(), (jnp.zeros((1, 64, 64, 3)),) * 2, None),
        "vgg16": ("lpips", JVGG(), (jnp.zeros((1, 64, 64, 3)),), TC.convert_vgg16),
    }[name]
    m = tt.reference_backbone(module, seed=8)
    t = TC.to_variables(m.state_dict())
    if name == "vgg16":
        t = {"params": t["params"]["net"]}
    sd = TC.to_reference(conv or tt.REFERENCE_CONVERTERS[module], t)
    return sd, (), t, jax_template(jmod, *args)


CASES = ["generator", "encoder", "cinn", "cinn_control", "ae_encoder_in", "ae_encoder_bn",
         "disc_t", "disc_s", "biggan64", "biggan128", "bigae", "i3d", "dti3d", "i3d_tf",
         "inception", "lpips", "vgg16"]
CONVERTERS = {"generator": "convert_stage1_generator", "encoder": "convert_stage1_encoder",
              "cinn": "convert_conditional_flow", "cinn_control": "convert_conditional_flow",
              "ae_encoder_in": "convert_resnet_encoder", "ae_encoder_bn": "convert_resnet_encoder",
              "disc_t": "convert_stage1_discriminator", "disc_s": "convert_patch_discriminator",
              "biggan64": "convert_biggan_generator", "biggan128": "convert_biggan_generator",
              "bigae": "convert_bigae", "i3d": "convert_i3d_kinetics", "dti3d": "convert_i3d_dt",
              "i3d_tf": "convert_i3d_tf_hub", "inception": "convert_inception_fid",
              "lpips": "convert_lpips", "vgg16": "convert_vgg16"}


@pytest.mark.parametrize("name", CASES)
def test_reference_map_matches_jax(name, ref_dirs, strict_jax_filler):
    sd, args, source, tmpl = case(name, ref_dirs)
    fn = CONVERTERS[name]
    if name == "lpips":
        ours, theirs = TC.convert_lpips(*sd), JC.convert_lpips(*sd)
    else:
        ours, theirs = getattr(TC, fn)(sd, *args), getattr(JC, fn)(sd, *args)
    assert_same_tree(ours, theirs, name)
    merged, missing = JC.merge_into_template(tmpl, ours, strict=True)
    got = {c: t for c, t in ours.items() if c != "actnorm_stats"}
    want = {c: t for c, t in source.items() if c != "actnorm_stats"}
    if name.startswith("big"):
        # BigGAN's weight_v is not carried: the template keeps its v
        lost = [k for k in flat(want) if k not in flat(got)]
        assert lost and all(k[0] == "spectral" and k[-1] == "v" for k in lost)
        got = TC.merge_into_template(want, got)[0]
    assert_same_tree(got, want, name + " written and read back")
    if name in ("generator", "encoder", "cinn", "inception", "lpips", "vgg16"):
        assert not [p for p in missing if p[0] == "params"]  # every weight came from the file


def test_reference_maps_keep_the_quirks(ref_dirs, strict_jax_filler):
    """The spectral leaves of the stage-1 files, BigGAN's weight_bar with its
    skipped (wrongly sized) v, the ActNorm bookkeeping and the frozen-BN
    leaves, and a leftover key refused by a strict finish in both packages."""
    sd = _model_file(ref_dirs, False, "stage1/best_PFVD_GEN.pth", wrapped=True)
    assert {"g_0.conv_0.weight_orig", "g_0.conv_0.weight_u", "g_0.conv_0.weight_v"} <= set(sd)
    out = TC.convert_stage1_generator(sd)
    assert out["spectral"]["g_0"]["conv_0"].keys() == {"u", "v"}
    big, args, _, _ = case("biggan64", ref_dirs)
    assert big["colorize.module.weight_v"].shape == big["colorize.module.weight_u"].shape
    out = TC.convert_biggan_generator(big, *args)
    assert out["spectral"]["colorize"].keys() == {"u"}
    assert "attention" not in out["params"]
    patch, _, _, _ = case("disc_s", ref_dirs)
    out = TC.convert_patch_discriminator(patch)
    assert out["actnorm_stats"]["norm1"]["initialized"].dtype == np.uint8
    assert out["actnorm_stats"]["norm1"]["initialized"].shape == ()
    sd = dict(sd, extra=np.zeros(1, np.float32))
    for conv in (TC, JC):
        f = conv._Filler(sd)
        f.take("fc.weight")
        with pytest.raises(KeyError, match="unconsumed torch keys"):
            f.finish(strict=True)
    f = TC._Filler(sd)
    f.finish()
    assert "extra" in f.leftover and "fc.weight" in f.leftover


def test_merge_into_template_matches_jax():
    rng = np.random.default_rng(0)
    template = {"params": {"a": {"kernel": np.zeros((2, 3), np.float32),
                                 "bias": np.zeros(3, np.float32)}, "empty": {}},
                "batch_stats": {"bn": {"mean": np.zeros(3, np.float32)}}}
    conv = {"params": {"a": {"kernel": rng.standard_normal((2, 3))}}}
    ours, theirs = TC.merge_into_template(template, conv), JC.merge_into_template(template, conv)
    assert_same_tree(ours[0], theirs[0])
    assert ours[1] == theirs[1] == [("params", "a", "bias"), ("batch_stats", "bn", "mean")]
    assert ours[0]["params"]["a"]["kernel"].dtype == np.float32
    for m in (TC, JC):
        with pytest.raises(KeyError, match="not in template"):
            m.merge_into_template(template, {"params": {"b": np.zeros(1)}})
        assert m.merge_into_template(template, {"params": {"b": np.zeros(1)}}, strict=False)[1]
        with pytest.raises(ValueError, match="shape mismatch"):
            m.merge_into_template(template, {"params": {"a": {"bias": np.zeros(4)}}})


def test_pretrained_biggan_init_matches_jax(tmp_path, monkeypatch):
    """``AE.pretrained``: the port's init equals ``pretrained_init_biggan`` on
    the same state dict, bitwise; the AE trainer takes every decoder weight
    from the file but ``G_linear``, which keeps the fresh init; a missing
    file raises the JAX package's error."""
    torch.manual_seed(9)
    file_tree = TC.subtree(ts1.variables(BigAE(AE64)), "decoder_wrap", "decoder")
    sd = TC.to_reference(TC.convert_biggan_generator, file_tree, 64)
    gen_vars = ts1.variables(BigAE(AE64))
    ours = TC.pretrained_init_biggan(gen_vars, AE64, sd=sd)
    assert_same_tree(ours, JC.pretrained_init_biggan(gen_vars, AE64, sd=sd))
    dec = ours["params"]["decoder_wrap"]["decoder"]
    np.testing.assert_array_equal(dec["G_linear"]["kernel"],
                                  gen_vars["params"]["decoder_wrap"]["decoder"]["G_linear"]["kernel"])
    np.testing.assert_array_equal(dec["colorize"]["kernel"], file_tree["params"]["colorize"]["kernel"])

    opt = tcfg.Config(jtesting.stage2_ae_config(jtesting.PRESETS["bair"]).to_dict())
    opt.AE.update(AE64, pretrained=True)
    opt.Discriminator_Patch["ndf"] = 8
    TC.save_reference(str(tmp_path / "biggan" / "biggan_64.pth"), sd)
    models = tae.build_models(opt, seed=0, weights_root=str(tmp_path))
    fresh = tae.build_models(tcfg.Config(dict(opt.to_dict(), AE=dict(AE64, pretrained=False))),
                             seed=0)
    got = models.network.decoder_wrap.decoder.state_dict()
    want = TC.to_state_dict(TC.merge_into_template(file_tree, {})[0], fold_spectral=False)
    for k, v in got.items():
        if k.startswith("G_linear."):
            assert torch.equal(v, fresh.network.decoder_wrap.decoder.state_dict()[k]), k
        elif k.endswith(".v"):  # not in the file: the fresh init's
            assert torch.equal(v, fresh.network.decoder_wrap.decoder.state_dict()[k]), k
        else:
            assert torch.equal(v, want[k]), k
    for part in ("encoder", "decoder_wrap.map_to_class_embedding"):
        a = dict(models.network.named_parameters())
        b = dict(fresh.network.named_parameters())
        assert all(torch.equal(a[k], b[k]) for k in a if k.startswith(part))

    monkeypatch.chdir(tmp_path / "biggan")
    errors = []
    for m in (TC, JC):
        with pytest.raises(FileNotFoundError) as e:
            m.pretrained_init_biggan(gen_vars, AE64)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "models/biggan/biggan_64.pth" in errors[0]


@pytest.mark.parametrize("suffix", [".msgpack", ".pth", ".pth.tar", "fallback"])
def test_find_and_load_match_jax(tmp_path, suffix):
    stem = str(tmp_path / "model")
    sd = {"w.weight": torch.arange(6.0).reshape(2, 3)}
    tree = {"state_dict": {"params": {"w": np.arange(3, dtype=np.float32)}}}
    if suffix == ".msgpack":
        jckpt.save(stem + ".msgpack", tree)
    else:
        torch.save({"epoch": 2, "state_dict": sd}, stem + (".pth.tar" if suffix == ".pth.tar"
                                                          else ".pth"))
    assert tckpt.find(stem) == jckpt.find(stem)
    if suffix == ".msgpack":
        assert_same_tree(tckpt.load(stem + ".msgpack"), jckpt.load(stem + ".msgpack"))
        return
    path = stem + ".msgpack" if suffix == "fallback" else tckpt.find(stem)
    ours = tckpt.load(path)
    assert ours["epoch"] == 2 and torch.equal(ours["state_dict"]["w.weight"], sd["w.weight"])
    if suffix == "fallback":
        theirs = jckpt.load(path)
        assert theirs.keys() == ours.keys()
        assert torch.equal(theirs["state_dict"]["w.weight"], ours["state_dict"]["w.weight"])
    with pytest.raises(ValueError, match="cli.convert_weights model_dir"):
        tckpt.variables(ours, path)


def test_serving_loaders_refuse_a_reference_payload(ref_dirs):
    """The port's ``Model`` on an unconverted reference directory raises and
    names the converter (the JAX facade fails on it too); so do the metric
    loaders on a ``.pth`` under their stem."""
    d = ref_dirs[False] + "/"
    with pytest.raises(ValueError, match="cli.convert_weights model_dir"):
        Model(d, vid_length=8, device="cpu")
    with pytest.raises(Exception):
        JaxModel(d, vid_length=8, use_pallas=False)
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid
    root = os.path.join(os.path.dirname(d.rstrip("/")), "weights")
    os.makedirs(os.path.join(root, "FID"), exist_ok=True)
    torch.save({"x.weight": torch.zeros(1)}, os.path.join(root, "FID", "pt_inception.pth"))
    with pytest.raises(ValueError, match="cli.convert_weights"):
        fid.load_inception(root, device="cpu")


def test_fvd_loader_drops_the_dt_logits_head(tmp_path):
    """A converted DT I3D file holds the 18-class logits head, which the JAX
    module ignores; the port's loader drops it and loads the rest strictly."""
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fvd
    src = tt.reference_backbone("dti3d16", seed=1)
    tree = TC.to_variables(src.state_dict())
    path = tmp_path / "DTI3D" / "length16" / "I3D_16.msgpack"
    os.makedirs(path.parent)
    tckpt.save(str(path), {"state_dict": tree})
    model = fvd.load_model("dt16", str(tmp_path), device="cpu")
    got = model.module.state_dict()
    assert "conv3d_0c_1x1.conv3d.weight" in src.state_dict() and not any(
        k.startswith("conv3d_0c_1x1") for k in got)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in got.items())
    with pytest.raises(FileNotFoundError, match="cli.convert_weights dti3d32"):
        fvd.load_model("dt32", str(tmp_path), device="cpu")


def test_step_timer_follows_jax_ema():
    t = profiling.StepTimer(ema=0.5)
    with t.measure():
        torch.ones(100, 100).sum()
    assert t.last_ms > 0 and t.ema_ms == t.last_ms
    first = t.ema_ms
    t.start()
    dt = t.stop(torch.ones(3))
    assert dt == t.last_ms and t.ema_ms == pytest.approx(0.5 * first + 0.5 * dt)


def test_trace_annotate_and_server_write_traces(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert isinstance(profiling.annotate("port/phase"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("port/phase"):
            with profiling.annotate("port/inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    keys = {e.key for e in prof.key_averages()}
    assert {"port/phase", "port/inner"} <= keys
    path = tmp_path / "t.pt.trace.json"
    prof.export_chrome_trace(str(path))
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    outer, inner = spans["port/phase"], spans["port/inner"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert isinstance(profiling.annotate("port/phase"), contextlib.nullcontext)
