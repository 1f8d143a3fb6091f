"""Endpoint-controlled synthesis with the port (the flags and outputs of the
root ``visualize_endpoint.py``; BAIR only)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.visualize_endpoint \
        -dataset bair -data_path DATA/ [-ckpt_path DIR/] [-seq_length 16] \
        [-n_samples 15] [-n_realiz 8] [-bs 6] [-compute_dtype bfloat16] \
        [-device cuda] [-gpu 0] [-data_parallel] [-spatial_shard N]

Loads the control model (``models/bair/stage2_control/`` by default), reads
the BAIR endpoint test split (``seq_length + 1`` frames a clip and the
end-effector target of its last frame), and for each of ``-n_realiz``
realisations samples ``Model(x0, cond=target)`` over the batches until
``-n_samples`` videos; writes ``assets/results/bair_endpoint/endpoint_<i>.gif``
(the realisations side by side) and ``endpoint_<i>.png`` (their last frames).
``-device`` defaults to ``cuda``; ``-data_parallel`` splits each batch over
the serving replicas and ``-spatial_shard N``
width-shards the decoder, as in ``generate_samples``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .generate_samples import add_serving_flags, serving_options

SAVE_PATH = "./assets/results/bair_endpoint/"


def generate(model, loader, n_realiz: int, n_samples: int) -> torch.Tensor:
    """The CLI's loop: ``n_realiz`` passes over the loader, each sampling
    every batch's start frame under its end-effector target until
    ``n_samples`` videos; -> (n_samples, n_realiz, T, C, H, W) on the host."""
    from ..data.augment import build_augment

    augment = build_augment(model.config.Data["img_size"], None, False, False)
    realisations = []
    for _ in range(n_realiz):
        videos, n = [], 0
        for batch in loader.epoch_iter(0):
            seq = augment(torch.from_numpy(batch["seq_raw"]).to(model.device))
            videos.append(model(seq[:, 0].permute(0, 3, 1, 2), cond=batch["cond"]).cpu())
            n += videos[-1].shape[0]
            if n >= n_samples:
                break
        realisations.append(torch.cat(videos))
    return torch.stack(realisations, dim=1)[:n_samples]


def write(videos: np.ndarray, save_path: str = SAVE_PATH) -> None:
    """One GIF of each video's realisations side by side, and a PNG of
    their last frames."""
    from ..utils import video as vid

    os.makedirs(save_path, exist_ok=True)
    for idx, v in enumerate(videos):
        gif = vid.convert_seq2gif(v)
        vid.write_gif(os.path.join(save_path, f"endpoint_{idx}.gif"), gif, fps=3)
        last = np.transpose(v[:, -1], (0, 2, 3, 1))
        grid = np.concatenate(list(np.clip((last + 1) / 2, 0, 1)), axis=1)
        vid.write_image(os.path.join(save_path, f"endpoint_{idx}.png"), grid * 255)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    add_serving_flags(parser)
    parser.add_argument("-data_path", type=str, required=False)
    parser.add_argument("-n_samples", type=int, default=15)
    parser.add_argument("-n_realiz", type=int, default=8)
    args = parser.parse_args(argv)
    if args.dataset != "bair":
        raise ValueError("endpoint control is trained on BAIR only (-dataset bair)")
    serving = serving_options(args)

    from ..data import get_eval_loader
    from ..data.framestore import open_or_build
    from ..data.loader import Loader
    from ..models.facade import Model

    ckpt_path = args.ckpt_path or f"./models/{args.dataset}/stage2_control/"
    model = Model(ckpt_path, args.seq_length, compute_dtype=args.compute_dtype, **serving)
    dataset = get_eval_loader(args.dataset, args.seq_length + 1, args.data_path, model.config,
                              control=True)
    fs = open_or_build(dataset, model.config.Data.get("framestore", "off"), "test")
    loader = Loader(dataset, args.bs, shuffle=False, drop_last=False, workers=10, framestore=fs)
    write(generate(model, loader, args.n_realiz, args.n_samples).numpy())
    print(f"Animations saved in {SAVE_PATH}")


if __name__ == "__main__":
    main()
