"""FVD / DTFVD activations (port of ``metrics/fvd.py``).

* Kinetics FVD: frames bilinearly resized to 224 with align-corners
  sampling, denormalised from the *declared* input range to [0, 1] (never
  by the batch's content), I3D 400-d logits.
* DTFVD: the DTDB-trained I3D's 1024-d representation; the 16-frame variant
  tiles the clip 3x in time and keeps 16 frames (``prep_dt_time``), the
  32-frame one needs 32 frames.

Weights: ``<weights_root>/PI3D/model_rgb.msgpack`` and
``<weights_root>/DTI3D/length{16,32}/I3D_{16,32}.msgpack``, variables trees
of the JAX package's I3D (``cli/convert_weights.py`` writes them from the
reference's ``.pth`` files; the DT nets' converted ``logits`` head is unused
and dropped at load, as the JAX module ignores it). A missing file raises
``FileNotFoundError``: there is no random fallback.

Videos are the port's layout, (N, T, C, H, W); activations come back as
float32 rows. The eval CLIs stream (``streaming_eval.py``); the
materialised scorers ``calculate_FVD`` and ``compute_fvd_official_protocol``
take whole sets of clips, which they hold in memory, and compute the same
populations and values.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.backbones.i3d import I3D
from ..models.facade import resolve_device
from ..ops.resize import resize_bilinear_align_corners
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from .frechet import frechet_from_activations


class I3DModel(NamedTuple):
    module: I3D  # weights loaded, on its device, in eval mode
    kind: str  # 'kinetics' | 'dt16' | 'dt32'


def build(kind: str) -> I3D:
    """The I3D of ``kind`` with the module's own random initialisation."""
    if kind == "kinetics":
        return I3D(num_classes=400, head="logits")
    if kind == "dt16":
        return I3D(num_classes=18, head="representation", avg_pool_t=2, bn_eps=1e-5)
    if kind == "dt32":
        return I3D(num_classes=18, head="representation", avg_pool_t=4, bn_eps=1e-5)
    raise ValueError(kind)


WEIGHT_FILES = {
    "kinetics": os.path.join("PI3D", "model_rgb.msgpack"),
    "dt16": os.path.join("DTI3D", "length16", "I3D_16.msgpack"),
    "dt32": os.path.join("DTI3D", "length32", "I3D_32.msgpack"),
}


CLI_KINDS = {"kinetics": "i3d", "dt16": "dti3d16", "dt32": "dti3d32"}
REGISTRY = {"kinetics": "pi3d", "dt16": "dti3d16", "dt32": "dti3d32"}


def load_model(kind: str = "kinetics", weights_root: str = "models", device=None) -> I3DModel:
    module = build(kind)
    path = os.path.join(weights_root, WEIGHT_FILES[kind])
    found = ckpt_io.find(os.path.splitext(path)[0])
    if found is None:
        raise FileNotFoundError(
            f"I3D weights not found at {path}; convert the reference weights with "
            f"python -m image2video_synthesis_using_cinns_tpu_torch.cli.convert_weights "
            f"{CLI_KINDS[kind]} --src <file> (docs/WEIGHTS.md, entry {REGISTRY[kind]})"
        )
    convert.load_checkpoint(module, found, drop=() if kind == "kinetics" else ("conv3d_0c_1x1",))
    return I3DModel(module.to(resolve_device(device)).eval(), kind)


def _resize224(videos: torch.Tensor) -> torch.Tensor:
    b, t = videos.shape[:2]
    flat = resize_bilinear_align_corners(videos.reshape((-1,) + videos.shape[2:]), (224, 224))
    return flat.reshape(b, t, videos.shape[2], 224, 224)


def activation_fn(model: I3DModel, input_range: tuple[float, float] = (-1.0, 1.0)
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-batch activation program: videos (B, T, C, H, W) with values in
    ``input_range`` -> (B, D) on the model's device."""
    lo, hi = float(input_range[0]), float(input_range[1])
    device = next(model.module.parameters()).device

    @torch.inference_mode()
    def run(videos: torch.Tensor) -> torch.Tensor:
        x = _resize224(torch.as_tensor(videos).to(device, torch.float32))
        x = (x - lo) / (hi - lo)  # by the declared range, never the batch's content
        out = model.module(x.permute(0, 2, 1, 3, 4))
        return out[1] if model.kind == "kinetics" else out

    return run


def prep_dt_time(videos: torch.Tensor, length: int) -> torch.Tensor:
    """(B, T, ...) -> the DT net's clip: tiled 3x in time and cut to 16 frames
    for DT-16; DT-32 takes 32 frames as they are."""
    if length == 16:
        return torch.cat([videos] * 3, dim=1)[:, :16]
    if videos.shape[1] != 32:
        raise ValueError("DTFVD-32 requires 32-frame videos")
    return videos


def get_activations(model: I3DModel, videos, batch_size: int,
                    input_range: tuple[float, float] = (-1.0, 1.0)) -> np.ndarray:
    """videos: (N, T, C, H, W), a tensor on any device or a numpy array.

    The ``N % batch_size`` trailing clips are dropped on purpose, as the
    reference's FID-style batching does; pass a divisor to score every clip."""
    run = activation_fn(model, input_range)
    n = videos.shape[0]
    bs = min(batch_size, n)
    outs = [run(torch.as_tensor(videos[i * bs : (i + 1) * bs])).cpu().numpy()
            for i in range(n // bs)]
    return np.concatenate(outs, axis=0)


def _prep_dt(videos, length: int) -> torch.Tensor:
    """A whole set's DT clips: ``prep_dt_time`` on (N, T, C, H, W)."""
    return prep_dt_time(torch.as_tensor(videos), length)


def calculate_FVD(model: I3DModel, data_gen, data_orig, batch_size: int,
                  input_range: tuple[float, float] = (-1.0, 1.0)) -> float:
    """The Fréchet distance of two sets of clips (N, T, C, H, W), tensors on
    any device or numpy arrays with values in ``input_range`` (pass (0, 1)
    for clips already in [0, 1]), held in memory whole. The DT nets take
    their clips through ``_prep_dt``; each set's ``N % batch_size`` trailing
    clips are dropped (``get_activations``)."""
    if model.kind in ("dt16", "dt32"):
        length = 16 if model.kind == "dt16" else 32
        data_gen, data_orig = _prep_dt(data_gen, length), _prep_dt(data_orig, length)
    act1 = get_activations(model, data_gen, batch_size, input_range)
    act2 = get_activations(model, data_orig, batch_size, input_range)
    return frechet_from_activations(act1, act2)


def compute_fvd_official_protocol(seq_fake, seq_real, weights_root: str = "models",
                                  device=None) -> float:
    """FVD of the grouped (G, 16, T, C, H, W) sets the eval CLI builds,
    flattened and scored by the kinetics I3D in batches of 16, as the JAX
    package replaces the reference's TF1 official-FVD script. The score
    equals the official FVD only with weights converted from the TF-hub
    module (``cli/convert_weights.py i3d_tf``)."""
    model = load_model("kinetics", weights_root, device)
    f, r = torch.as_tensor(seq_fake), torch.as_tensor(seq_real)
    return calculate_FVD(model, f.flatten(0, 1), r.flatten(0, 1), batch_size=16)
