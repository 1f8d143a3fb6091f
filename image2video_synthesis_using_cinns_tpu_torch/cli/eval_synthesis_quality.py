"""Synthesis-quality evaluation with the port (the flags, protocol and output of
the root ``eval_synthesis_quality.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.eval_synthesis_quality \
        -dataset bair -data_path DATA/ [-ckpt_path DIR/] [-seq_length 16] [-bs 6] \
        [-FID 1] [-LPIPS 1] [-FVD 1] [-DTFVD 1] [-compute_dtype bfloat16] \
        [-device cuda] [-gpu 0] [-data_parallel] [-spatial_shard N]

Seed 249; the eval loader reads ``seq_length + 1`` frames per clip; the
dataset's frame concatenation (BAIR: GT frame 0 prepended, the last
generated frame dropped; iPER: GT frame 0 prepended; the others: the
generated frames) feeds a ``SynthesisQualityStream``, whose backbones load
from ``models/`` (a missing I3D or Inception file raises). ``-device``
defaults to ``cuda``; ``-data_parallel`` splits each batch over the serving
replicas and ``-spatial_shard N``
width-shards the decoder, as in ``generate_samples``.
"""

from __future__ import annotations

import argparse

import torch

from .generate_samples import add_serving_flags, serving_options


def clip_pairs(dataset: str, seq: torch.Tensor, gen: torch.Tensor):
    """(generated, real) clips of one batch under the dataset's protocol;
    ``seq`` holds ``seq_length + 1`` real frames, ``gen`` the model's video."""
    if dataset == "bair":
        return torch.cat((seq[:, :1], gen[:, :-1]), dim=1), seq[:, :-1]
    if dataset == "iPER":
        return torch.cat((seq[:, :1], gen), dim=1), seq
    return gen, seq[:, :-1]


def evaluate(model, loader, stream, dataset: str) -> dict[str, float]:
    """The CLI's loop: augment each batch on the model's device, sample from
    its first frame, feed the protocol's clip pairs to ``stream``; returns
    ``stream.results()``."""
    from ..data.augment import build_augment

    augment = build_augment(model.config.Data["img_size"], None, False, False)
    for batch in loader.epoch_iter(0):
        raw = torch.from_numpy(batch["seq_raw"]).to(model.device)
        seq = augment(raw).permute(0, 1, 4, 2, 3)  # (B, T, C, H, W)
        stream.add_batch(*clip_pairs(dataset, seq, model(seq[:, 0])))
    return stream.results()


def main(argv: list[str] | None = None) -> dict[str, float]:
    """The CLI; returns the scores it printed."""
    parser = argparse.ArgumentParser()
    add_serving_flags(parser)
    parser.add_argument("-texture", type=str, required=False)
    parser.add_argument("-data_path", type=str, required=False)
    parser.add_argument("-FID", type=bool)
    parser.add_argument("-FVD", type=bool)
    parser.add_argument("-DTFVD", type=bool)
    parser.add_argument("-LPIPS", type=bool)
    args = parser.parse_args(argv)
    serving = serving_options(args)

    from ..data import get_eval_loader
    from ..data.framestore import open_or_build
    from ..data.loader import Loader
    from ..metrics.streaming_eval import SynthesisQualityStream
    from ..models.facade import Model
    from ..utils.seed import set_seed

    set_seed(249)
    path_ds = f"{args.dataset}/{args.texture}/" if args.dataset == "DTDB" else args.dataset
    ckpt_path = args.ckpt_path or f"./models/{path_ds}/stage2/"
    model = Model(ckpt_path, args.seq_length, seed=249, compute_dtype=args.compute_dtype,
                  **serving)
    dataset = get_eval_loader(args.dataset, args.seq_length + 1, args.data_path, model.config)
    fs = open_or_build(dataset, model.config.Data.get("framestore", "off"), "test")
    loader = Loader(dataset, args.bs, shuffle=False, drop_last=False, workers=10, framestore=fs)
    stream = SynthesisQualityStream(
        want_fid=bool(args.FID), want_lpips=bool(args.LPIPS), want_fvd=bool(args.FVD),
        want_dtfvd=bool(args.DTFVD), seq_length=args.seq_length, device=model.device,
    )
    results = evaluate(model, loader, stream, args.dataset)
    if args.FID:
        print("Evaluate FID")
        print(f"FID score of {results['FID']}")
    if args.LPIPS:
        print("Evaluate LPIPS")
        print(f"LPIPS score of {results['LPIPS']}")
    if args.DTFVD:
        print("Evaluate DTFVD")
        print(f"DTFVD score of {results['DTFVD']}")
    if args.FVD:
        print("Evaluate FVD")
        print(f"FVD score of {results['FVD']}")
    return results


if __name__ == "__main__":
    main()
