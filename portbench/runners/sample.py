"""Sampling: ``Model.sample(x0, residual=nu)``, one closed-loop caller.

Each call draws ``batch`` new start frames, U(-1, 1), and a new nu ~ N(0, I)
on the device from the run's seed and the call's index, and makes
``vid_length`` frames a video. ``keep_calls`` calls, chosen over the window
from the seed, are compared with the reference after the window.
"""

from __future__ import annotations

import torch

from portbench import serving
from portbench.weights import seeded


class Runner(serving.ServingRunner):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(cfg, traffic, seed, device)
        self.rows = int(traffic["batch"])

    def inputs(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        gen = seeded(self.seed, self.device, 1000 + i)
        img = self.cfg["Data"]["img_size"]
        x0 = self.uniform(gen, self.rows, 3, img, img)
        nu = torch.randn((self.rows, self.cfg["Decoder"]["z_dim"]), device=self.device,
                         generator=gen)
        return x0, nu

    def run(self, x: tuple[torch.Tensor, torch.Tensor]):
        x0, nu = x
        return self.model.sample(x0, residual=nu)

    def counts(self) -> dict:
        return serving.serving_counts(self.cfg, self.rows, self.vid_length, [self.rows],
                                      self.rows)
