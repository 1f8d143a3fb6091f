"""The optimizer and the LR schedule of the trainers (port of ``train/optim.py``).

The JAX package's ``adam_torch`` is the optax chain ``add_decayed_weights``
(coupled L2: ``wd * p`` added to the gradient) -> ``scale_by_amsgrad`` or
``scale_by_adam`` -> ``scale(-lr)``, with the learning rate injected as a
hyperparameter. ``Adam`` below computes that chain in float32, as optax
0.2.6 does. It is not ``torch.optim.Adam``: with ``amsgrad`` optax keeps the
running maximum of the *bias-corrected* second moment and divides the
bias-corrected first moment by ``sqrt(nu_max) + eps``, while torch keeps the
maximum of the raw second moment and corrects it afterwards. The two agree
at step 1 and drift apart after it (every stage-2 config sets ``amsgrad``).

``optax_state`` / ``load_optax_state`` convert the optimizer's state to and
from the layout that ``flax.serialization.to_state_dict`` gives the JAX
chain's state, so checkpoints pass between the packages. ``LRController``
is the host-side scheduler, copied as it is.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch


class Adam(torch.optim.Optimizer):
    """The JAX package's ``adam_torch`` chain. One step count for all
    parameters (optax's ``count``); per parameter ``mu``, ``nu`` and, with
    ``amsgrad``, ``nu_max``."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, amsgrad: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, amsgrad=amsgrad))
        self.count = 0

    def reset(self) -> None:
        """Zero the moments and the count, as ``optimizer.init`` does."""
        self.state.clear()
        self.count = 0

    def _moments(self, p: torch.Tensor, amsgrad: bool) -> dict:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
            if amsgrad:
                st["nu_max"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            amsgrad = group["amsgrad"]
            states = [self._moments(p, amsgrad) for p in params]
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
            mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            # bias corrections in float32, as optax computes 1 - decay**count
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
            mu_hat = torch._foreach_div(mus, bc1)
            nu_hat = torch._foreach_div(nus, bc2)
            if amsgrad:
                nu_max = [s["nu_max"] for s in states]
                torch._foreach_maximum_(nu_max, nu_hat)
                nu_hat = nu_max
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)


def adam_torch(params, lr: float, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, amsgrad: bool = False) -> Adam:
    """The JAX package's ``adam_torch(lr, ...)`` over ``params``."""
    return Adam(params, lr, betas=betas, eps=eps, weight_decay=weight_decay, amsgrad=amsgrad)


def get_lr(opt: torch.optim.Optimizer) -> float:
    """The learning rate as the update applies it, in float32 (as the JAX
    package's injected hyperparameter holds it)."""
    return float(np.float32(opt.param_groups[0]["lr"]))


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


def _adam_index(group: dict) -> int:
    """Position of the Adam state in optax's chain: after the decay's."""
    return 1 if group["weight_decay"] else 0


def optax_state(opt: Adam, names: Sequence[str],
                to_tree: Callable[[dict[str, torch.Tensor]], dict]) -> dict:
    """The optimizer's state as ``to_state_dict`` lays out the JAX chain's:
    ``{count, hyperparams: {learning_rate}, hyperparams_states: {},
    inner_state: {"0": ..., ...}}``, the Adam state ``{count, mu, nu[,
    nu_max]}`` at its place in the chain and ``{}`` for the stateless links.
    ``names`` names the parameters of the one param group in order;
    ``to_tree`` maps ``{name: tensor}`` to the JAX parameter tree."""
    group = opt.param_groups[0]
    params = group["params"]
    if len(opt.param_groups) != 1 or len(names) != len(params):
        raise ValueError("optax_state takes one param group and a name for each parameter")
    count = np.asarray(opt.count, np.int32)
    adam: dict[str, Any] = {"count": count}
    keys = ("mu", "nu", "nu_max") if group["amsgrad"] else ("mu", "nu")
    for key in keys:
        adam[key] = to_tree({n: opt.state[p][key] if opt.state.get(p) else torch.zeros_like(p)
                             for n, p in zip(names, params)})
    n_links = 3 if group["weight_decay"] else 2
    inner = {str(i): {} for i in range(n_links)}
    inner[str(_adam_index(group))] = adam
    return {"count": count, "hyperparams": {"learning_rate": np.asarray(group["lr"], np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def load_optax_state(opt: Adam, state: dict, names: Sequence[str],
                     from_tree: Callable[[dict], dict[str, torch.Tensor]]) -> Adam:
    """The inverse of ``optax_state``: the moments, the count and the
    learning rate of a JAX chain's state (``from_tree`` maps a JAX parameter
    tree to ``{name: tensor}``)."""
    group = opt.param_groups[0]
    adam = state["inner_state"][str(_adam_index(group))]
    keys = ("mu", "nu", "nu_max") if group["amsgrad"] else ("mu", "nu")
    if set(adam) != {"count", *keys}:
        raise ValueError(f"the checkpoint's optimizer state has {sorted(adam)}, this "
                         f"optimizer keeps {sorted({'count', *keys})}")
    opt.reset()
    opt.count = int(np.asarray(adam["count"]))
    trees = {key: from_tree(adam[key]) for key in keys}
    for n, p in zip(names, group["params"]):
        opt.state[p] = {key: trees[key][n].to(p.device, p.dtype) for key in keys}
    set_lr(opt, float(np.asarray(state["hyperparams"]["learning_rate"])))
    return opt


class LRController:
    """Host-side scheduler mirroring the torch schedulers of the reference's
    trainers.

    modes:
      * 'exponential': lr *= gamma per ``step()`` (stage 1, ExponentialLR)
      * 'step': lr *= gamma every ``step_size`` steps (stage 2, StepLR)
      * 'plateau': ReduceLROnPlateau(factor=0.5, patience=1, min_lr=1e-8,
        threshold=1e-4 abs) (stage-2 AE)
    """

    def __init__(self, base_lr: float, mode: str, gamma: float = 0.98,
                 step_size: int = 1, factor: float = 0.5, patience: int = 1,
                 min_lr: float = 1e-8, threshold: float = 1e-4):
        self.lr = base_lr
        self.mode = mode
        self.gamma = gamma
        self.step_size = step_size
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self._count = 0
        self._best = float("inf")
        self._bad_epochs = 0

    def step(self, metric: float | None = None) -> float:
        self._count += 1
        if self.mode == "exponential":
            self.lr *= self.gamma
        elif self.mode == "step":
            if self._count % self.step_size == 0:
                self.lr *= self.gamma
        elif self.mode == "plateau":
            if metric is None:
                raise ValueError("the plateau mode steps on a metric")
            if metric < self._best - self.threshold:
                self._best = metric
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if self._bad_epochs > self.patience:
                    self.lr = max(self.lr * self.factor, self.min_lr)
                    self._bad_epochs = 0
        else:
            raise ValueError(self.mode)
        return self.lr

    def state_dict(self) -> dict[str, Any]:
        return {
            "lr": self.lr, "count": self._count,
            "best": self._best, "bad_epochs": self._bad_epochs,
        }

    def load_state_dict(self, d: dict[str, Any]) -> None:
        self.lr = d["lr"]
        self._count = d["count"]
        self._best = d["best"]
        self._bad_epochs = d["bad_epochs"]
