"""Stochastic video sampling with the port (the flags and outputs of the root
``generate_samples.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.generate_samples \
        -dataset bair [-ckpt_path DIR/] [-seq_length 16] [-bs 6] [-seed 0] \
        [-compute_dtype bfloat16] [-device cuda] [-gpu 0] [-data_parallel] \
        [-spatial_shard N]

Reads every jpg/png/jpeg start frame under ``assets/GT_samples/<dataset>``
(``<dataset>/<texture>`` for DTDB), scales it to [-1, 1] and resizes it to the
model's image size, samples videos in batches of ``-bs`` and writes
``assets/results/<path>/results.gif``. The checkpoint directory defaults to
``models/<path>/stage2/``. ``-device`` defaults to ``cuda`` (``-gpu`` picks the
card). ``-data_parallel`` serves one replica per card over every visible
card, splitting each batch across them (``Model(data_parallel=True)``;
``CUDA_VISIBLE_DEVICES`` picks the cards). ``-spatial_shard N`` splits the
decoder's width over N cards for the latency of one video
(``Model(spatial_shard=N)``); beside ``-data_parallel`` the visible cards
form a (data, model) grid with N on the model axis. ``0``, the default, is
off.
"""

from __future__ import annotations

import argparse
import glob
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

IMG_SUFFIX = ["jpg", "png", "jpeg"]


def add_serving_flags(parser: argparse.ArgumentParser) -> None:
    """The flags both sampling entry points share with the root CLIs, and ``-device``."""
    parser.add_argument("-gpu", type=str, required=False, help="index of the CUDA card")
    parser.add_argument("-dataset", type=str, required=True, help="Specify dataset")
    parser.add_argument("-ckpt_path", type=str, required=False, help="If ckpt outside of repo")
    parser.add_argument("-seq_length", type=int, default=16)
    parser.add_argument("-bs", type=int, default=6, help="Batchsize")
    parser.add_argument("-compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="decoder dtype (the encoder, embedder and flow stay fp32)")
    parser.add_argument("-device", type=str, default="cuda", help="cuda or cpu")
    parser.add_argument("-data_parallel", action="store_true",
                        help="serve one replica per card over every visible card, each batch "
                             "split across them")
    parser.add_argument("-spatial_shard", type=int, default=0,
                        help="width-shard the decoder over N cards for single-video latency "
                             "(composes with -data_parallel via a 2-D (data, model) grid; "
                             "0 = off)")


def serving_device(args: argparse.Namespace) -> str:
    """The device the flags ask for."""
    if args.device == "cuda" and args.gpu is not None:
        return f"cuda:{int(args.gpu)}"
    return args.device


def serving_options(args: argparse.Namespace) -> dict:
    """``Model``'s ``device``, ``data_parallel`` and ``spatial_shard`` as the
    flags ask for them."""
    return {"device": serving_device(args), "data_parallel": args.data_parallel,
            "spatial_shard": args.spatial_shard or False}


def read_frames(names: list[str], img_res: int) -> np.ndarray:
    """Image files -> (N, 3, img_res, img_res) float32 in [-1, 1]: RGB scaled to
    [-1, 1], then resized bilinearly (align_corners=False, no antialias), as
    the reference's kornia resize of the normalised image."""
    from PIL import Image

    frames = []
    for name in names:
        img = np.asarray(Image.open(name).convert("RGB"), dtype=np.float32) / 255.0
        x = (torch.from_numpy(img).permute(2, 0, 1)[None] - 0.5) / 0.5
        x = F.interpolate(x, size=(img_res, img_res), mode="bilinear", align_corners=False)
        frames.append(x[0].numpy())
    return np.stack(frames)


def load_images(img_path: str, img_res: int) -> np.ndarray:
    """Every jpg, then png, then jpeg image under ``img_path`` (each group sorted)."""
    names = []
    for suffix in IMG_SUFFIX:
        names.extend(sorted(glob.glob(os.path.join(img_path, f"*.{suffix}"))))
    if not names:
        raise FileNotFoundError(f"no images found under {img_path}")
    return read_frames(names, img_res)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    add_serving_flags(parser)
    parser.add_argument("-texture", type=str, help="Specify texture when using DTDB")
    parser.add_argument("-seed", type=int, default=0)
    args = parser.parse_args(argv)
    serving = serving_options(args)

    from ..models.facade import Model
    from ..utils import video as vid

    path_ds = f"{args.dataset}/{args.texture}" if args.dataset == "DTDB" else args.dataset
    ckpt_path = args.ckpt_path or f"./models/{path_ds}/stage2/"
    model = Model(ckpt_path, args.seq_length, seed=args.seed,
                  compute_dtype=args.compute_dtype, **serving)
    imgs = load_images(f"./assets/GT_samples/{path_ds}/", model.config_stage1.Data["img_size"])

    bs = args.bs
    videos = [model(imgs[i * bs:(i + 1) * bs]).cpu().numpy()
              for i in range(math.ceil(imgs.shape[0] / bs))]
    save_path = f"./assets/results/{path_ds}/"
    os.makedirs(save_path, exist_ok=True)
    gif = vid.convert_seq2gif(np.concatenate(videos, axis=0))
    vid.write_gif(save_path + "results.gif", gif)
    print(f"Animations saved in {save_path}")


if __name__ == "__main__":
    main()
