"""Stage-2 conditioning-AE training with the port (the flags of the root
``train_stage2_AE.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.train_stage2_AE \
        [-cf configs/stage2_AE/bair_config.yaml] [-device cuda] [-gpu 0]

``-device`` defaults to ``cuda``; ``-device cpu`` trains on the CPU.
``-gpu`` is accepted and ignored, as in the root CLI: pick the card with
``-device cuda:N``.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-cf", "--config", type=str, default="configs/stage2_AE/bair_config.yaml",
                        help="Define config file")
    parser.add_argument("-gpu", type=str, required=False, help="ignored")
    parser.add_argument("-device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .. import config as cfg
    from ..train.stage2_ae import main as train_main

    return train_main(cfg.load(args.config), device=args.device)


if __name__ == "__main__":
    main()
