"""Motion transfer with the port (the flags and outputs of the root
``generate_transfer.py``; landscape only, as the reference)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.generate_transfer \
        -dataset landscape [-ckpt_path DIR/] [-seq_length 16] \
        [-compute_dtype bfloat16] [-device cuda] [-gpu 0] [-data_parallel] [-spatial_shard N]

Reads one frame sequence per folder of ``assets/GT_samples/landscape/transfer/``
(folders and frames in natural order, at most ``-seq_length`` frames each),
transfers each query video's motion onto the first frames of all videos, in
batches of 6 (the reference parses ``-bs`` but batches by 6), prepends the
query's own row and writes ``assets/results/landscape/transfer_<idx>.gif``.
``-device``, ``-gpu``, ``-data_parallel`` (the start frames split across the
replicas; the query is encoded once) and ``-spatial_shard N`` (the decoder's width
split over N cards) are as in ``generate_samples``.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import re

import numpy as np

from .generate_samples import IMG_SUFFIX, add_serving_flags, read_frames, serving_options


def natsorted(items):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(items, key=key)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    add_serving_flags(parser)
    args = parser.parse_args(argv)
    if args.dataset != "landscape":
        parser.error("Only implemented for landscape")
    serving = serving_options(args)

    import imageio

    from ..models.facade import Model
    from ..utils import video as vid

    ckpt_path = args.ckpt_path or f"./models/{args.dataset}/stage2/"
    model = Model(ckpt_path, args.seq_length, transfer=True, compute_dtype=args.compute_dtype,
                  **serving)
    img_res = model.config_stage1.Data["img_size"]

    img_path = f"./assets/GT_samples/{args.dataset}/transfer/"
    videos = []
    for video_dir in natsorted(os.listdir(img_path)):
        names = []
        for suffix in IMG_SUFFIX:
            names.extend(glob.glob(os.path.join(img_path, video_dir, f"*.{suffix}")))
        videos.append(read_frames(natsorted(names)[: args.seq_length], img_res))
    videos = np.stack(videos)  # (N, T, C, H, W)

    bs = 6  # generate_transfer.py:81-83 of the root CLI: the reference's batch
    save_path = f"./assets/results/{args.dataset}/"
    os.makedirs(save_path, exist_ok=True)
    for idx, query in enumerate(videos):
        rows = [model.transfer(query[None], videos[i * bs:(i + 1) * bs, 0]).cpu().numpy()
                for i in range(math.ceil(videos.shape[0] / bs))]
        transfer = np.concatenate(rows, axis=0)
        transfer = np.concatenate((query[None, : transfer.shape[1]], transfer), axis=0)
        gif = vid.convert_seq2gif(transfer)
        imageio.mimsave(save_path + f"transfer_{idx}.gif", gif.astype(np.uint8), fps=3)
    print(f"Animations saved in {save_path}")


if __name__ == "__main__":
    main()
