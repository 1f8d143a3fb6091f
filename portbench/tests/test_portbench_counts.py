"""``portbench/count.py`` against ``torch.utils.flop_counter.FlopCounterMode``
at the tiny preset on the CPU: each forward count exactly, the stage-1 step's
count within its stated approximation."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from portbench import count
from portbench.reference import discriminators as ref_disc
from portbench.reference import flow as ref_flow
from portbench.reference import resnet as ref_resnet
from portbench.reference import stage1 as ref_stage1
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH_PY_DECODER_GFLOP = 370.0  # bench.py's figure for one BAIR video


def plain(module):
    """``module`` with its spectral layers' sigma left out: the counts take
    the data path's convolutions and dense layers, not the sigma's two
    matrix-vector products a layer."""
    for m in module.modules():
        if hasattr(m, "spectral"):
            m.spectral = False
    return module


class _Flops(TorchDispatchMode):
    """FlopCounterMode's rules without its module hooks, which autograd.grad
    (the gradient penalty) does not take."""

    total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = flop_registry.get(func._overloadpacket)
        if rule is not None:
            self.total += rule(*args, **kwargs, out_val=out)
        return out


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("upsample_s", [[1, 1], [2, 1], [2, 2]])
def test_decoder_count_is_the_ports_eager_decoder(upsample_s, two_threads):
    from image2video_synthesis_using_cinns_tpu_torch.models.stage1.decoder import Generator

    dec = dict(tiny.TINY["Decoder"], upsample_s=upsample_s, upsample_t=[2, 1])
    g = Generator.from_config(dec)
    img = 4 * 8 * upsample_s[0] * upsample_s[1]
    x0, z = torch.zeros(2, 3, img, img), torch.zeros(2, dec["z_dim"])
    assert count.decoder_flops(dec, 2) == counted(lambda: g(x0, z))
    assert count.decoder_weight_count(dec) == sum(p.numel() for p in g.parameters())


def test_bair_decoder_against_bench_py():
    """The BAIR decoder is 384.8 GFLOP a video by its shapes, 4.0% above the
    370 that bench.py assumed (bench.py's figure was never counted)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "bair.json").read_text())
    gflop = count.decoder_flops(cfg["Decoder"], 1) / 1e9
    assert round(gflop, 2) == 384.79
    assert round(gflop / BENCH_PY_DECODER_GFLOP - 1, 3) == 0.040


@pytest.mark.parametrize("kind,norm", [("resnet18", "in"), ("resnet50", "bn")])
def test_embedder_count(kind, norm, two_threads):
    ae = {"encoder_type": kind, "norm": norm, "z_dim": 16}
    m = ref_resnet.ResnetEncoder(16, kind, norm).eval()
    assert count.embedder_flops(ae, 64, 2) == counted(lambda: m(torch.zeros(2, 3, 64, 64)))


def test_encoder_and_discriminator_counts(two_threads):
    cfg = tiny.tiny_config()
    enc = ref_resnet.Encoder(cfg["Encoder"])
    clip = torch.zeros(2, 3, 8, 32, 32)
    assert count.encoder_flops(cfg["Encoder"], 8, 32, 2) == counted(lambda: enc.moments(clip))
    dt = plain(ref_resnet.Discriminator(cfg["Discriminator_Temporal"]))
    assert count.disc_t_flops(cfg["Discriminator_Temporal"], 8, 32, 2) == counted(lambda: dt(clip))
    ds = plain(ref_disc.NLayerDiscriminator(cfg["Discriminator_Patch"]))
    img = torch.zeros(5, 3, 64, 64)
    assert count.patch_disc_flops(cfg["Discriminator_Patch"], 64, 5) == counted(lambda: ds(img))
    lp = ref_disc.LPIPS()
    assert count.lpips_flops(32, 3) == counted(lambda: lp(torch.zeros(3, 3, 32, 32),
                                                            torch.zeros(3, 3, 32, 32)))


def test_chain_count(two_threads):
    cfg = tiny.tiny_config()
    net = ref_flow.SupervisedTransformer.from_config(cfg)
    c, e, h, d, n = count.chain_shape(cfg)
    x, emb = torch.zeros(3, c), torch.zeros(3, e)
    assert count.chain_flops(c, e, h, d, n, 3) == counted(lambda: net.flow.reverse(x, emb))
    assert count.chain_flops(c, e, h, d, n, 3) == counted(lambda: net.flow(x, emb))
    weights = sum(p.numel() for k, p in net.flow.named_parameters() if k.endswith("weight"))
    assert count.chain_weight_count(c, e, h, d, n) == weights


def test_stage1_step_count_within_its_approximation(two_threads):
    """The step's count takes a network's backward as twice its forward and
    an input gradient alone as once; held to 15% of what FlopCounterMode
    counts over the reference's step, gates open."""
    cfg = tiny.tiny_config()
    torch.manual_seed(0)
    models = ref_stage1.Models.from_config(cfg)
    models.lpips.requires_grad_(False)
    step = ref_stage1.Step(models, cfg["Training"])
    b, t, img = 4, cfg["Data"]["sequence_length"], cfg["Data"]["img_size"]
    seq = torch.rand(b, t, img, img, 3) * 2 - 1
    eps, patches = torch.randn(b, cfg["Decoder"]["z_dim"]), torch.randint(0, b * (t - 1), (20,))
    with _Flops() as fc:
        step(seq, 1, eps, 0, patches)
    want = fc.total
    got = count.stage1_step_flops(cfg, b)
    assert abs(got / want - 1) < 0.15, (got, want)
