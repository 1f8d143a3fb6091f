"""LPIPS for the offline evaluation (port of ``metrics/lpips_eval.py``): the
VGG flavour, scored in batches of 10 frame pairs by ``streaming_eval.py``
or, over two whole sets of frames held in memory, by ``compute_lpips``.

``load_lpips`` reads ``<weights_root>/lpips/vgg_lpips.msgpack`` (a variables
tree of the JAX package's ``LPIPS``, which ``python -m
image2video_synthesis_using_cinns_tpu_torch.cli.convert_weights lpips --src
vgg.pth --vgg vgg16-397923af.pth`` writes; docs/WEIGHTS.md, entry lpips).
Without it the module runs with random
weights, as the JAX package's does, so pipelines and timings work offline;
the port draws them from its own fixed torch seed (``RANDOM_INIT_SEED``),
which cannot reproduce JAX's ``PRNGKey(0)`` draw, so the two random LPIPS
differ (ROADMAP §C).
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


@torch.inference_mode()
def compute_lpips(pd_imgs, gt_imgs, batch_size: int = 10, weights_root: str = "models",
                  device=None) -> float:
    """The mean over whole batches of ``batch_size`` frame pairs (N, C, H, W)
    in [-1, 1] of each batch's mean distance; the ``N % batch_size``
    trailing pairs are dropped, as in the reference."""
    dev = resolve_device(device)
    module = load_lpips(weights_root, dev)
    n_batches = pd_imgs.shape[0] // batch_size
    total = 0.0
    for i in range(n_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        pd = torch.as_tensor(pd_imgs[sl]).to(dev, torch.float32)
        gt = torch.as_tensor(gt_imgs[sl]).to(dev, torch.float32)
        total += float(module(pd, gt).mean())
    return total / max(n_batches, 1)
