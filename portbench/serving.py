"""What the two serving runners share: the port's configs from a
configuration file, the seeded serving weights, the benchmark's spans on a
``Model``, the reference of a call, and the comparison.

Weights: the decoder is drawn in its served precision (``precision.decoder``,
bf16), the flow with its embedder and the dynamics encoder in fp32; the port
gets them through ``Model.from_configs(..., state_dicts=)`` and the reference
the same tensors, cast to fp32. The port packs its chain weights in bf16
itself; the reference takes the fp32 weights.

The comparison, per kept call: ``z_gap``, the largest over rows of the
relative distance between the port's z and the reference's (the reference
runs its own embedder, encoder and chains from the inputs), and
``video_gap``, the same between the port's video and the reference decoder's
video from the port's z (both decodes and the extension). A control
(``lowered``) runs the reference one precision below the configuration's:
fp8 for the bf16 decoder and chain weights, TF32 for the fp32 embedder and
encoder.
"""

from __future__ import annotations

import contextlib

import torch

from . import count, harness, tracing
from .reference import decoder as ref_decoder
from .reference import flow as ref_flow
from .reference import resnet as ref_resnet
from .reference.nn import set_precision
from .weights import draw_state, seeded

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_configs(cfg: dict):
    """(stage-2 config, stage-1 config, AE section) in the port's ``Config``."""
    from image2video_synthesis_using_cinns_tpu_torch.config import Config

    stage2 = Config({"Flow": cfg["Flow"], "Conditioning_Model": {"z_dim": cfg["AE"]["z_dim"]},
                     "Training": {"control": False}})
    stage1 = Config({"Decoder": cfg["Decoder"], "Encoder": cfg["Encoder"]})
    return stage2, stage1, Config(cfg["AE"])


def draw_serving(cfg: dict, seed: int, device: torch.device, transfer: bool) -> dict:
    """The serving state dicts: ``decoder`` (served precision), ``flow`` (the
    flow and its embedder) and, for transfer, ``encoder``."""
    prec = cfg["precision"]
    sd = {"decoder": draw_state(lambda: ref_decoder.Generator.from_config(cfg["Decoder"]),
                                seeded(seed, device, 1), device, DTYPES[prec["decoder"]]),
          "flow": draw_state(lambda: ref_flow.SupervisedTransformer.from_config(cfg),
                             seeded(seed, device, 2), device)}
    if transfer:
        sd["encoder"] = draw_state(lambda: ref_resnet.Encoder(cfg["Encoder"]),
                                   seeded(seed, device, 3), device)
    return sd


def build_model(cfg: dict, seed: int, device: torch.device, vid_length: int, transfer: bool,
                state_dicts: dict):
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

    stage2, stage1, ae = port_configs(cfg)
    return Model.from_configs(stage2, stage1, ae, vid_length, transfer=transfer,
                              seed=seed % (1 << 63), use_kernel=True,
                              compute_dtype=cfg["precision"]["decoder"], device=device,
                              state_dicts=state_dicts)


@contextlib.contextmanager
def model_spans(model):
    """The benchmark's spans on a ``Model``: its decoder, its dynamics
    encoder and its embedder's ``encode``."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(tracing.module_span(model.decoder, "bench/decoder"))
        if model.encoder is not None:
            stack.enter_context(tracing.module_span(model.encoder, "bench/encoder"))
        stack.enter_context(tracing.method_span(model.flow.embedder, "encode", "bench/embedder"))
        yield


class Reference:
    """The reference of the serving path, fp32, or ``lowered`` (the control)."""

    def __init__(self, cfg: dict, state_dicts: dict, device: torch.device, lowered: bool = False):
        self.cfg = cfg
        builders = {"flow": lambda: ref_flow.SupervisedTransformer.from_config(cfg),
                    "decoder": lambda: ref_decoder.Generator.from_config(cfg["Decoder"]),
                    "encoder": lambda: ref_resnet.Encoder(cfg["Encoder"])}
        built = {}
        for name, sd in state_dicts.items():
            with torch.device(device):
                module = builders[name]()
            module.load_state_dict({k: v.float() for k, v in sd.items()})
            built[name] = module.eval().requires_grad_(False)
        self.net, self.decoder, self.encoder = built["flow"], built["decoder"], built.get("encoder")
        self.fp32 = self.decoder
        if lowered:
            set_precision(self.net.embedder, "tf32")
            self.net.flow.weight_rounding = "fp8"
            if self.encoder is not None:
                set_precision(self.encoder, "tf32")
            with torch.device(device):
                self.fp32 = builders["decoder"]()
            self.fp32.load_state_dict(self.decoder.state_dict())
            self.fp32.eval().requires_grad_(False)
            set_precision(self.decoder, "fp8")

    @torch.no_grad()
    def sample_z(self, x0: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
        return self.net.flow.reverse(nu, self.net.embed(x0))

    @torch.no_grad()
    def transfer_z(self, query: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """The query's posterior mean of frames 1:, the forward chain under
        its first frame, the reverse chain under each start frame."""
        mu, _ = self.encoder.moments(query[:, 1:].permute(0, 2, 1, 3, 4))
        nu, _ = self.net.flow(mu, self.net.embed(query[:, 0]))
        return self.net.flow.reverse(nu.repeat(x0.shape[0], 1), self.net.embed(x0))

    @torch.no_grad()
    def video(self, x0: torch.Tensor, z: torch.Tensor, vid_length: int, rows: int,
              fp32: bool = True) -> torch.Tensor:
        dec = self.fp32 if fp32 else self.decoder
        return ref_decoder.render(dec, x0, z, vid_length, rows)


def gaps(ref: Reference, kept: list, vid_length: int, rows: int, transfer: bool) -> dict:
    """``z_gap`` and ``video_gap`` over the kept calls, each an
    ``(inputs, (video, z))`` pair of the port's."""
    z_gap = video_gap = 0.0
    for inputs, (video, z) in kept:
        z_ref = ref.transfer_z(*inputs) if transfer else ref.sample_z(*inputs)
        x0 = inputs[1] if transfer else inputs[0]
        z_gap = max(z_gap, harness.rel_gap_rows(z, z_ref))
        video_gap = max(video_gap, harness.rel_gap_rows(
            video, ref.video(x0, z.to(x0.device), vid_length, rows)))
    return {"z_gap": z_gap, "video_gap": video_gap}


def serving_counts(cfg: dict, rows: int, vid_length: int, chains: list[int],
                   embedded: int, encoder_clips: int = 0) -> dict:
    """Operations and bytes one call needs: ``rows`` videos of ``vid_length``
    frames, the chains over ``chains`` rows each, ``embedded`` start frames
    through the embedder, ``encoder_clips`` query clips through the encoder."""
    prec = cfg["precision"]
    img = cfg["Data"]["img_size"]
    shape = count.chain_shape(cfg)
    n_dec = count.decodes(cfg, vid_length)
    out = {
        "decoder": {"flops": n_dec * count.decoder_flops(cfg["Decoder"], rows),
                    "bytes": n_dec * (count.decoder_weight_count(cfg["Decoder"])
                                      * count.ITEM_BYTES[prec["decoder"]]
                                      + 4 * rows * 3 * img * img * (1 + count.decoder_frames(
                                          cfg["Decoder"]))),
                    "precision": prec["decoder"]},
        "embedder": {"flops": count.embedder_flops(cfg["AE"], img, embedded),
                     "precision": prec["embedder"]},
        "chain": {"flops": sum(count.chain_flops(*shape, b) for b in chains),
                  "bytes": sum(count.chain_bytes(*shape, b, prec["chain_weights"]) for b in chains),
                  "precision": prec["chain_weights"]},
    }
    if encoder_clips:
        frames = cfg["Data"]["sequence_length"] - 1
        out["encoder"] = {"flops": count.encoder_flops(cfg["Encoder"], frames, img, encoder_clips),
                          "precision": prec["encoder"]}
    return out


def control_gaps(runner, transfer: bool) -> dict:
    """The control's ``z_gap`` and ``video_gap`` on ``keep_calls`` calls of
    ``runner``'s inputs: the lowered reference in the port's place, judged
    as the port is."""
    cfg, dev, traffic = runner.cfg, runner.device, runner.traffic
    state = draw_serving(cfg, runner.seed, dev, transfer)
    rows, vid = int(traffic["reference_rows"]), runner.vid_length
    low = Reference(cfg, state, dev, lowered=True)
    kept = []
    for i in range(int(traffic["keep_calls"])):
        x = runner.inputs(i)
        z = low.transfer_z(*x) if transfer else low.sample_z(*x)
        kept.append((x, (low.video(x[1] if transfer else x[0], z, vid, rows, fp32=False), z)))
    del low
    harness.free(dev)
    return gaps(Reference(cfg, state, dev), kept, vid, rows, transfer)


class ServingRunner:
    """A closed-loop serving runner: ``rows`` videos of ``vid_length``
    frames a call from new inputs (``inputs(i)``, drawn on the device from
    the seed and the call's index), ``keep_calls`` calls kept over the
    window for the check. A subclass gives ``transfer``, ``rows``,
    ``inputs``, ``run`` (the program's entry point on them) and ``counts``."""

    loop = "closed"
    unit_metric = "frames_per_s"
    transfer = False

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.vid_length = int(traffic["vid_length"])
        self.kept = harness.Reservoir(int(traffic["keep_calls"]), seed)

    def setup(self, phases) -> None:
        self.state = draw_serving(self.cfg, self.seed, self.device, self.transfer)
        phases("weights")
        self.model = build_model(self.cfg, self.seed, self.device, self.vid_length,
                                 self.transfer, self.state)
        phases("program build")
        for i in range(2):  # the window's one shape
            self.run(self.inputs(-1 - i))

    def uniform(self, gen: torch.Generator, *shape: int) -> torch.Tensor:
        return torch.rand(shape, device=self.device, generator=gen) * 2 - 1

    def call(self, i: int) -> int:
        x = self.inputs(i)
        self.kept.offer((x, self.run(x)))
        return self.rows * self.vid_length

    def spans(self):
        return model_spans(self.model)

    def control(self) -> dict:
        return control_gaps(self, self.transfer)

    def check(self) -> list[tuple[str, float, float]]:
        self.model = None
        harness.free(self.device)
        got = gaps(Reference(self.cfg, self.state, self.device), self.kept.items,
                   self.vid_length, int(self.traffic["reference_rows"]), self.transfer)
        limits = self.traffic["limits"]
        return [(k, got[k], float(limits[k])) for k in ("z_gap", "video_gap")]
