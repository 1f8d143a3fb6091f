"""The stage-2 (cINN) training step in plain float32 PyTorch: the frozen 3-D
encoder's posterior sample of frames 1:, the frozen embedder's mode of the
start frame, the flow's forward with its log-determinant, the NLL loss, its
gradient by autograd and an AMSGrad step (the port's ``train/stage2.py``
without the posterior cache, ``losses/flow_loss.py``, ``models/stage2/
flow.py``'s ``actnorm_init`` and ``train/optim.py``, frozen, one process).

``Step.lower("tf32")`` rounds every convolution's and dense layer's
operands to TF32, the coupling MLPs' straight through, so that the control
trains through them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .flow import INV_LRELU_ALPHA, LRELU_SLOPE, ConditionalFlow
from .nn import rounded, set_precision
from .resnet import Encoder, ResnetEncoder
from .stage1 import Adam, grads_of


class TrainingFlow(ConditionalFlow):
    """``ConditionalFlow`` with its coupling MLPs' operands rounded by
    ``nn.rounded`` (the identity in the backward): the same flow at fp32."""

    def _mlp(self, net: str, i: int, h: torch.Tensor) -> torch.Tensor:
        layers = list(self.blocks.coupling[net].values())
        kind = self.weight_rounding
        for li, lay in enumerate(layers):
            h = F.linear(rounded(h, kind), rounded(lay.weight[i], kind), lay.bias[i])
            if li < len(layers) - 1:
                h = torch.where(h >= 0, h, LRELU_SLOPE * h)
        return h


class Network(nn.Module):
    """The frozen embedder and the trained flow, under the port's names
    (``flow...``, ``embedder...``), so the cINN's state dict loads into it."""

    def __init__(self, cfg: dict):
        super().__init__()
        z, fl, ae = cfg["Decoder"]["z_dim"], cfg["Flow"], cfg["AE"]
        self.flow = TrainingFlow(z, ae["z_dim"], z * fl["flow_mid_channels_factor"],
                                 fl["flow_hidden_depth"], fl["n_flows"])
        self.embedder = ResnetEncoder(ae["z_dim"], ae["encoder_type"], ae["norm"])


class AMSGrad(Adam):
    """optax's ``add_decayed_weights`` -> ``scale_by_amsgrad`` -> ``scale(-lr)``
    in float32: the running maximum of the bias-corrected second moment.
    (``torch.optim.Adam(amsgrad=True)`` keeps the maximum of the raw one.)"""

    def __init__(self, params, lr: float, betas, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr, betas, eps, weight_decay)
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            g = g + self.wd * p if self.wd else g
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            torch.maximum(nu_max, nu / bc2, out=nu_max)
            p.add_(-self.lr * (mu / bc1) / (nu_max.sqrt() + self.eps))


class Step:
    """The stage-2 step from the state dicts ``network`` (the cINN with its
    embedder) and ``encoder``, on ``device``, with the optimizer settings
    ``tr`` (``lr``, ``beta1``, ``beta2``, ``weight_decay``; AMSGrad)."""

    def __init__(self, cfg: dict, tr: dict, state: dict, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device(device):
            self.net = Network(cfg)
            self.encoder = Encoder(cfg["Encoder"])
        self.net.load_state_dict(state["network"])
        self.encoder.load_state_dict(state["encoder"])
        self.net.embedder.requires_grad_(False)
        self.encoder.requires_grad_(False)
        self.opt = AMSGrad(self.net.flow.parameters(), float(tr["lr"]),
                           (float(tr["beta1"]), float(tr["beta2"])),
                           weight_decay=float(tr["weight_decay"]))

    def lower(self, kind: str) -> None:
        """Compute every convolution and dense layer in ``kind`` (the control)."""
        set_precision(self.net.embedder, kind)
        set_precision(self.encoder, kind)
        self.net.flow.weight_rounding = kind

    @torch.no_grad()
    def posterior(self, seq: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) in [-1, 1] -> the sample of frames 1:, (B, z)."""
        post, _, _ = self.encoder(seq[:, 1:].permute(0, 4, 1, 2, 3), eps.to(seq.device))
        return post.reshape(post.shape[0], -1)

    @torch.no_grad()
    def embed(self, seq: torch.Tensor) -> torch.Tensor:
        x0 = seq[:, 0].permute(0, 3, 1, 2)
        return self.net.embedder.mode(x0).reshape(x0.shape[0], -1)

    @torch.no_grad()
    def init_actnorm(self, seq: torch.Tensor, eps: torch.Tensor) -> None:
        """The data-dependent ActNorm init on one batch: block by block,
        ``loc = -mean`` and ``scale = 1 / (std + 1e-6)`` of the block's input
        over the batch (std with ddof 1), carried through the chain."""
        flow, emb = self.net.flow, self.embed(seq)
        x = self.posterior(seq, eps)
        a = flow.blocks.actnorm
        for i in range(a.loc.shape[0]):
            var, mean = torch.var_mean(x, dim=0, correction=1)
            a.loc[i] = -mean
            a.scale[i] = 1.0 / (var.sqrt() + 1e-6)
            x = (x + a.loc[i]) * a.scale[i]
            x = torch.where(x >= 0, x, INV_LRELU_ALPHA * x)
            x, _ = flow._coupling(i, 0, x, emb, False)
            x = flow._swap(x)
            x, _ = flow._coupling(i, 1, x, emb, False)
            x = x[:, flow.shuffle.fwd[i]]

    def __call__(self, seq: torch.Tensor, eps: torch.Tensor) -> dict[str, float]:
        """One step on the augmented batch ``seq`` with posterior noise
        ``eps``; returns its loss terms."""
        gauss, logdet = self.net.flow(self.posterior(seq, eps), self.embed(seq))
        nll = 0.5 * gauss.square().sum(dim=1).mean()
        nlogdet = -logdet.mean()
        loss = nll + nlogdet
        self.opt.step(grads_of(loss, self.opt.params))
        return {"Loss": float(loss.detach()), "nll_loss": float(nll.detach()),
                "nlogdet_loss": float(nlogdet.detach())}
