"""Diversity evaluation with the port (the flags, protocol and output of the
root ``eval_diversity.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.eval_diversity \
        -dataset bair -data_path DATA/ [-ckpt_path DIR/] [-seq_length 16] [-bs 6] \
        [-n_realiz 5] [-VGG 1] [-I3D 1] [-DTI3D 1] [-compute_dtype bfloat16] \
        [-device cuda] [-gpu 0] [-data_parallel]

Seed 249; each eval batch is sampled ``-n_realiz`` times and fed to a
``DiversityStream``. The residuals nu are drawn up front realisation-major
(every batch of realisation 0, then of realisation 1, ...), so each
(realisation, batch) pair gets the noise the reference's realisation-major
loop gave it, while the loop runs batch-major. ``-device`` defaults to
``cuda``; ``-data_parallel`` splits each batch over the serving replicas and
``-spatial_shard`` raises, as in ``generate_samples``.
"""

from __future__ import annotations

import argparse

import torch

from .generate_samples import add_serving_flags, serving_options


def evaluate(model, loader, stream, n_realiz: int) -> dict[str, float]:
    """The CLI's loop; returns ``stream.results()``."""
    from ..data.augment import build_augment

    augment = build_augment(model.config.Data["img_size"], None, False, False)
    n, bs = len(loader.dataset), loader.batch_size
    sizes = [bs] * (n // bs) + ([n % bs] if n % bs else [])
    residuals = [[model.draw_residual(s) for s in sizes] for _ in range(n_realiz)]
    for i, batch in enumerate(loader.epoch_iter(0)):
        raw = torch.from_numpy(batch["seq_raw"]).to(model.device)
        x0 = augment(raw).permute(0, 1, 4, 2, 3)[:, 0]
        gens = [model.forward(x0, residual=residuals[r][i]) for r in range(n_realiz)]
        stream.add_batch(torch.stack(gens, dim=1))  # (B, n_realiz, T, C, H, W)
    return stream.results()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    add_serving_flags(parser)
    parser.add_argument("-texture", type=str)
    parser.add_argument("-data_path", type=str, required=True)
    parser.add_argument("-n_realiz", type=int, default=5)
    parser.add_argument("-I3D", type=bool)
    parser.add_argument("-VGG", type=bool)
    parser.add_argument("-DTI3D", type=bool)
    args = parser.parse_args(argv)
    serving = serving_options(args)

    from ..data import get_eval_loader
    from ..data.framestore import open_or_build
    from ..data.loader import Loader
    from ..metrics.streaming_eval import DiversityStream
    from ..models.facade import Model
    from ..utils.seed import set_seed

    set_seed(249)
    path_ds = f"{args.dataset}/{args.texture}/" if args.dataset == "DTDB" else args.dataset
    ckpt_path = args.ckpt_path or f"./models/{path_ds}/stage2/"
    model = Model(ckpt_path, args.seq_length, seed=249, compute_dtype=args.compute_dtype,
                  **serving)
    dataset = get_eval_loader(args.dataset, args.seq_length, args.data_path, model.config)
    fs = open_or_build(dataset, model.config.Data.get("framestore", "off"), "test")
    loader = Loader(dataset, args.bs, shuffle=False, drop_last=False, workers=10, framestore=fs)
    stream = DiversityStream(
        args.n_realiz, want_vgg=bool(args.VGG), want_i3d=bool(args.I3D),
        want_dti3d=bool(args.DTI3D), seq_length=args.seq_length, device=model.device,
    )
    results = evaluate(model, loader, stream, args.n_realiz)
    if args.VGG:
        print(f"Diversity score of {results['VGG']} using VGG backbone")
    if args.DTI3D:
        print(f"Diversity score of {results['DTI3D']} using I3D backbone pretrained on "
              "dynamic textures")
    if args.I3D:
        print(f"Diversity score of {results['I3D']} using I3D kinetics backbone")


if __name__ == "__main__":
    main()
