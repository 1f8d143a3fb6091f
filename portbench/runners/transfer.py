"""Motion transfer: ``Model.transfer_sample(query, x0)``, one closed-loop
caller.

Each call draws one new query clip of ``query_frames`` frames and ``starts``
new start frames, U(-1, 1), on the device from the run's seed and the
call's index, and makes ``vid_length`` frames a video. ``keep_calls``
calls, chosen over the window from the seed, are compared with the
reference after the window.
"""

from __future__ import annotations

import torch

from portbench import serving
from portbench.weights import seeded


class Runner(serving.ServingRunner):
    transfer = True

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(cfg, traffic, seed, device)
        self.rows = int(traffic["starts"])

    def inputs(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        gen = seeded(self.seed, self.device, 1000 + i)
        img = self.cfg["Data"]["img_size"]
        query = self.uniform(gen, 1, int(self.traffic["query_frames"]), 3, img, img)
        return query, self.uniform(gen, self.rows, 3, img, img)

    def run(self, x: tuple[torch.Tensor, torch.Tensor]):
        return self.model.transfer_sample(*x)

    def counts(self) -> dict:
        return serving.serving_counts(self.cfg, self.rows, self.vid_length, [1, self.rows],
                                      1 + self.rows, encoder_clips=1)
