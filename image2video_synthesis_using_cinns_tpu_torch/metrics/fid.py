"""FID activations (port of ``metrics/fid.py``): InceptionV3 pool3 2048-d
rows over frames in [-1, 1], batch size 50, as the reference's
``metrics/FID/FID_Score.py``.

Weights: ``<weights_root>/FID/pt_inception.msgpack``, a variables tree of the
JAX package's ``InceptionV3FID`` (``cli/convert_weights.py fid`` writes it
from the reference's ``.pth``); a missing file raises. The eval CLIs
stream (``streaming_eval.py``); ``calculate_FID`` scores two whole sets of
frames held in memory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.facade import resolve_device
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from .frechet import frechet_from_activations
from .inception import InceptionV3FID

WEIGHT_FILE = os.path.join("FID", "pt_inception.msgpack")


def load_inception(weights_root: str = "models", device=None) -> InceptionV3FID:
    path = ckpt_io.find(os.path.splitext(os.path.join(weights_root, WEIGHT_FILE))[0])
    if path is None:
        raise FileNotFoundError(
            f"FID inception weights not found under {weights_root}/FID/; convert "
            "pt_inception-2015-12-05 with python -m image2video_synthesis_using_cinns_tpu_torch"
            ".cli.convert_weights fid --src <file> (docs/WEIGHTS.md, entry fid)"
        )
    module = convert.load_checkpoint(InceptionV3FID(), path)
    return module.to(resolve_device(device)).eval()


@torch.inference_mode()
def get_activations(module: InceptionV3FID, images, batch_size: int = 50) -> np.ndarray:
    """images: (N, C, H, W) in [-1, 1], a tensor on any device or a numpy
    array; the ``N % batch_size`` trailing frames are dropped, as the
    reference does."""
    device = next(module.parameters()).device
    n = images.shape[0]
    bs = min(batch_size, n)
    outs = [module(torch.as_tensor(images[i * bs : (i + 1) * bs]).to(device, torch.float32))
            .cpu().numpy() for i in range(n // bs)]
    return np.concatenate(outs, axis=0)


def calculate_FID(inception: InceptionV3FID, seq_gen, seq_orig, batch_size: int = 50,
                  dims: int = 2048) -> tuple[float, int]:
    """The reference's signature: two sets of frames (N, C, H, W) in [-1, 1],
    held in memory whole -> (FID, N). Each set's ``N % batch_size`` trailing
    frames are dropped (``get_activations``); ``dims`` is the pool3 width,
    the only one the network gives."""
    a1 = get_activations(inception, seq_gen, batch_size)
    a2 = get_activations(inception, seq_orig, batch_size)
    return frechet_from_activations(a1, a2), seq_gen.shape[0]
