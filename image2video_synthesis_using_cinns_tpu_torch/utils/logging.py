"""In-memory metric accumulator and CSV epoch logger (port of
``utils/logging.py``).

The same method names and CSV layout as the JAX package's, so the trainers'
logs read the same. wandb is optional: ``WandbSink`` logs there only when
``Logging.mode`` is not ``disabled`` and ``wandb`` imports; otherwise every
call is a no-op, as in the JAX package.
"""

from __future__ import annotations

import csv

import numpy as np


class CSVlogger:
    def __init__(self, logname: str, header_names: list[str]):
        self.header_names = header_names
        self.logname = logname
        with open(logname, "a") as csv_file:
            writer = csv.writer(csv_file, delimiter=",")
            writer.writerow(header_names)

    def write(self, inputs: list) -> None:
        with open(self.logname, "a") as csv_file:
            writer = csv.writer(csv_file, delimiter=",")
            writer.writerow(inputs)


class Logging:
    def __init__(self, keys: list[str]):
        self.keys = keys
        self.dic = {x: [] for x in self.keys}

    def reset(self) -> None:
        self.dic = {x: [] for x in self.keys}

    def append(self, loss_dic: dict) -> None:
        for key in self.dic:
            self.dic[key].append(float(loss_dic[key]))

    def log(self) -> list[float]:
        return [float(np.mean(v)) if v else float("nan") for v in self.dic.values()]


class WandbSink:
    """Lazily initialised optional wandb logger."""

    def __init__(self):
        self._run = None
        self.enabled = False

    def init(self, log_cfg, config, save_path: str, name: str) -> None:
        mode = (log_cfg or {}).get("mode", "disabled")
        if mode in (None, "disabled", "off"):
            return
        try:
            import wandb

            self._run = wandb.init(
                entity=(log_cfg or {}).get("entity"),
                project=(log_cfg or {}).get("project"),
                dir=save_path,
                name=name,
                mode=mode,
                config=config.to_dict() if hasattr(config, "to_dict") else dict(config or {}),
            )
            self.enabled = True
        except Exception:  # wandb missing or unreachable: log nowhere, as the JAX package
            self._run = None
            self.enabled = False

    def log(self, dic: dict) -> None:
        if self.enabled and self._run is not None:
            self._run.log(dic)

    def log_image(self, key: str, image, caption: str | None = None) -> None:
        """image: (H, W, C) uint8 (the AE trainer's recon grid)."""
        if self.enabled and self._run is not None:
            import wandb

            self._run.log({key: [wandb.Image(image, caption=caption)]})

    def log_video(self, key: str, frames, fps: int = 3) -> None:
        """frames: (T, C, H, W) uint8, as ``plot_vid`` returns them."""
        if self.enabled and self._run is not None:
            import wandb

            self._run.log({key: wandb.Video(frames, fps=fps, format="gif")})
