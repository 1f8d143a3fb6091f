"""LPIPS for the offline evaluation (port of ``metrics/lpips_eval.py``): the
VGG flavour, scored in batches of 10 frame pairs by ``streaming_eval.py``.

``load_lpips`` reads ``<weights_root>/lpips/vgg_lpips.msgpack`` (a variables
tree of the JAX package's ``LPIPS``). Without it the module runs with random
weights, as the JAX package's does, so pipelines and timings work offline;
the port draws them from its own fixed torch seed (``RANDOM_INIT_SEED``),
which cannot reproduce JAX's ``PRNGKey(0)`` draw, so the two random LPIPS
differ (ROADMAP §C). The materialised ``compute_lpips`` is not ported.
"""

from __future__ import annotations

import os

import torch

from ..models.backbones.lpips import LPIPS
from ..models.facade import resolve_device
from ..utils import checkpoint as ckpt_io
from ..utils import convert

WEIGHT_FILE = os.path.join("lpips", "vgg_lpips.msgpack")
RANDOM_INIT_SEED = 0


def load_lpips(weights_root: str = "models", device=None, path: str | None = None) -> LPIPS:
    """LPIPS from ``path`` when given, else from under ``weights_root``, else
    with its fixed-seed random weights."""
    if path is None:
        path = ckpt_io.find(os.path.splitext(os.path.join(weights_root, WEIGHT_FILE))[0])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(RANDOM_INIT_SEED)
        module = LPIPS()
    if path is not None:
        convert.load_checkpoint(module, path)
    return module.to(resolve_device(device)).eval()
