"""Stage-1 video-VAE training with the port (the flags of the root
``train_stage1.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.train_stage1 \
        -cf CONFIG.yaml [-device cuda] [-gpu 0]

``-device`` defaults to ``cuda``; ``-device cpu`` trains on the CPU.
``-gpu`` is accepted and ignored, as in the root CLI: pick the card with
``-device cuda:N``.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-cf", "--config", type=str, required=True, help="Define config file")
    parser.add_argument("-gpu", type=str, required=False, help="ignored")
    parser.add_argument("-device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .. import config as cfg
    from ..train.stage1 import main as train_main

    return train_main(cfg.load(args.config), device=args.device)


if __name__ == "__main__":
    main()
