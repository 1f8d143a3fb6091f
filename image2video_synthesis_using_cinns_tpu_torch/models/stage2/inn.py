"""Conditional-INN wrapper: frozen start-frame embedder + flow (+ control).

Port of ``models/stage2/inn.py`` (``SupervisedTransformer``). The embedding
is the frozen ``ResnetEncoder``'s posterior mode; with endpoint control the
3-dof normalised end-effector position is quantised into 3 x 10 one-hot
bins and appended to it. ``forward(x, cond)`` gives (gauss, logdet) and
``reverse(out, cond)`` samples.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .flow import ConditionalFlow
from .resnet2d import ResnetEncoder


class SupervisedTransformer(nn.Module):
    def __init__(self, flow_in_channels: int, flow_embedding_channels: int,
                 flow_mid_channels: int, flow_hidden_depth: int, n_flows: int,
                 control: bool = False, embedder_config: dict | None = None,
                 use_kernel: bool = False):
        super().__init__()
        self.control = control
        self.flow = ConditionalFlow(
            in_channels=flow_in_channels,
            embedding_dim=flow_embedding_channels + self.cond_size * 3,
            hidden_dim=flow_mid_channels,
            hidden_depth=flow_hidden_depth,
            n_flows=n_flows,
            control=control,
            use_kernel=use_kernel,
        )
        cfg = embedder_config or {"z_dim": flow_embedding_channels}
        self.embedder = ResnetEncoder(
            z_dim=cfg["z_dim"],
            encoder_type=cfg.get("encoder_type", "resnet50"),
            norm=cfg.get("norm", "in"),
        )

    @property
    def cond_size(self) -> int:
        return 10 if self.control else 0

    def embed_pos(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) normalised positions -> (B, 30) one-hot bin embedding."""
        n = self.cond_size
        idx = (pos.float() * n - 1e-4).to(torch.int64)  # truncation, as torch .long()
        idx = torch.clamp(idx, 0, n - 1)
        return torch.cat([F.one_hot(idx[:, d], n).float() for d in range(3)], dim=1)

    @torch.no_grad()
    def embed(self, cond: Sequence[torch.Tensor]) -> torch.Tensor:
        x0 = cond[0]
        emb = self.embedder.encode(x0).mode().reshape(x0.shape[0], -1)
        if self.control:
            emb = torch.cat([emb, self.embed_pos(cond[1])], dim=1)
        return emb.contiguous()

    def forward(self, x: torch.Tensor, cond: Sequence[torch.Tensor], reverse: bool = False):
        emb = self.embed(cond)
        return self.flow(x, emb, reverse=reverse)

    def reverse(self, out: torch.Tensor, cond: Sequence[torch.Tensor]) -> torch.Tensor:
        return self(out, cond, reverse=True)

    @classmethod
    def from_configs(cls, stage2_cfg, stage1_decoder_cfg, ae_cfg=None, use_kernel: bool = False):
        """Build from the chained configs (``Flow``, ``Conditioning_Model``,
        ``Training.control`` of stage 2; ``z_dim`` of the stage-1 decoder)."""
        z_dim = stage1_decoder_cfg["z_dim"]
        flow_cfg = stage2_cfg["Flow"]
        return cls(
            flow_in_channels=z_dim,
            flow_embedding_channels=stage2_cfg["Conditioning_Model"]["z_dim"],
            flow_mid_channels=z_dim * flow_cfg["flow_mid_channels_factor"],
            flow_hidden_depth=flow_cfg["flow_hidden_depth"],
            n_flows=flow_cfg["n_flows"],
            control=bool(stage2_cfg["Training"].get("control", False)),
            embedder_config=None if ae_cfg is None else dict(ae_cfg),
            use_kernel=use_kernel,
        )
