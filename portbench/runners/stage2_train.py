"""Stage-2 (cINN) training: the train augment on the device, then
``train.stage2.train_step(network, optimizer, encoder, seq, cond, eps, ref)``,
one step a call, fp32, as ``train.stage2.train`` calls it without the
posterior cache: the frozen encoder's posterior, the frozen embedder, the
plain flow by autograd with ``flow_loss``, and the port's AMSGrad ``Adam`` on
the flow's parameters. The loss terms stay on the device and are fetched
every ``fetch_every`` steps.

The clips are ``n_clips`` uint8 moving-square clips made on the device from
the seed (``stage1_train.moving_squares``), taken ``batch`` at a time in
order, so the first steps' rows all differ. Each step's augment draws,
posterior eps and reference noise come from a CPU generator keyed by the
seed and the step, as the trainer's ``Draws`` give CPU tensors. The
optimizer's settings are the traffic's ``Training``: the stage-2 YAML's,
which the configuration file (stage 1's ``Training``) does not hold.

Set-up builds the models with the trainer's ``build_models_from_configs``,
loads the seeded weights, runs the flow's data-dependent ActNorm init on the
first batch with its own eps, as ``train`` does, and drives the one network
and optimizer through their first ``checked_steps`` steps by the window's
own call, reading each step's loss terms, the first gradient from the
optimizer's state (mu / (1 - beta1)) and the parameters' change after the
last. The window goes on with the same objects. ``check`` runs the
reference's step from the same weights, batches and draws, with its own
ActNorm init, and compares the three.
"""

from __future__ import annotations

import contextlib
import statistics
import sys

import torch

from portbench import count, harness
from portbench.reference import flow as ref_flow
from portbench.reference import resnet as ref_resnet
from portbench.reference import stage1 as ref_stage1
from portbench.reference import stage2 as ref_stage2
from portbench.runners.stage1_train import augment_draws, moving_squares, worst_leaf
from portbench.serving import port_configs
from portbench.weights import draw_state, seeded

LOSSES = ("Loss", "nll_loss", "nlogdet_loss")
ACTNORM = -1  # the draw key of the ActNorm init's eps


class Runner:
    loop = "steps"
    unit_metric = "train_clips_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = int(traffic["batch"])
        self.tr = traffic["Training"]
        self.params = cfg["Data"]["Augmentation"]
        self.pending: list[dict] = []

    # -- inputs -------------------------------------------------------------------
    def raw(self, i: int) -> torch.Tensor:
        k = (i * self.batch) % self.clips.shape[0]
        return self.clips[k:k + self.batch]

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator().manual_seed((self.seed * 1_000_003 + 6000 + i) % (1 << 63))

    def draws(self, i: int):
        """Step ``i``'s augment draws, posterior eps and reference noise."""
        gen = self.generator(i)
        shape = (self.batch, self.cfg["Decoder"]["z_dim"])
        aug = augment_draws(self.batch, self.params, gen)
        eps = torch.randn(shape, generator=gen)
        return aug, eps, torch.randn(shape, generator=gen)

    def actnorm_eps(self) -> torch.Tensor:
        return torch.randn(self.batch, self.cfg["Decoder"]["z_dim"],
                           generator=self.generator(ACTNORM))

    def prepare(self) -> None:
        """The weights and clips alone, for readings without the program."""
        cfg, dev = self.cfg, self.device
        self.state = {
            "network": draw_state(lambda: ref_flow.SupervisedTransformer.from_config(cfg),
                                  seeded(self.seed, dev, 20), dev),
            "encoder": draw_state(lambda: ref_resnet.Encoder(cfg["Encoder"]),
                                  seeded(self.seed, dev, 21), dev)}
        self.clips = moving_squares(int(self.traffic["n_clips"]),
                                    cfg["Data"]["sequence_length"], cfg["Data"]["img_size"],
                                    seeded(self.seed, dev, 7), dev)

    # -- set-up ---------------------------------------------------------------------
    def setup(self, phases) -> None:
        from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
        from image2video_synthesis_using_cinns_tpu_torch.train import stage2
        from image2video_synthesis_using_cinns_tpu_torch.train.optim import adam_torch

        dev, tr = self.device, self.tr
        self.prepare()
        phases("weights and clips")
        models = stage2.build_models_from_configs(*port_configs(self.cfg))
        self.encoder = models.encoder.to(dev).eval().requires_grad_(False)
        self.network = models.network.to(dev).eval()
        self.network.embedder.requires_grad_(False)
        self.encoder.load_state_dict(self.state["encoder"])
        self.network.load_state_dict(self.state["network"])
        phases("program build")
        self.aug = build_augment(self.cfg["Data"]["img_size"], self.params, False, True)
        seq = self.aug(self.raw(0), draws=self.draws(0)[0])
        self.network.init_actnorm(stage2.posterior(self.encoder, seq, self.actnorm_eps()),
                                  stage2.conditioning(seq, None))
        self.named = dict(self.network.flow.named_parameters())
        self.optimizer = adam_torch(list(self.named.values()), float(tr["lr"]),
                                    betas=(float(tr["beta1"]), float(tr["beta2"])),
                                    weight_decay=float(tr["weight_decay"]),
                                    amsgrad=bool(tr["amsgrad"]))
        phases("ActNorm init")
        before = {k: p.detach().clone() for k, p in self.named.items()}
        self.losses = []
        for i in range(int(self.traffic["checked_steps"])):
            self.call(i)
            self.losses.append(self.fetch()[0])
            if i == 0:
                b1 = float(tr["beta1"])
                self.grad_norms = {
                    k: float(self.optimizer.state[p]["mu"].norm()) / (1.0 - b1)
                    if self.optimizer.state.get(p) else 0.0 for k, p in self.named.items()}
        self.change_norms = {k: float((p.detach() - before[k]).norm())
                             for k, p in self.named.items()}

    # -- the window ------------------------------------------------------------------
    def call(self, i: int) -> int:
        from image2video_synthesis_using_cinns_tpu_torch.train import stage2

        aug_draws, eps, ref = self.draws(i)
        seq = self.aug(self.raw(i), draws=aug_draws)
        self.pending.append(stage2.train_step(self.network, self.optimizer, self.encoder, seq,
                                              stage2.conditioning(seq, None), eps, ref))
        return self.batch

    def fetch(self) -> list[dict]:
        """The pending steps' loss terms, in one copy to the host."""
        keys = list(self.pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in self.pending])
        values = rows.cpu().tolist()
        self.pending = []
        return [dict(zip(keys, v)) for v in values]

    def spans(self):
        """No span of the benchmark's own: the step's are the program's."""
        return contextlib.nullcontext()

    def counts(self) -> dict:
        return {"step": {"flops": count.stage2_step_flops(self.cfg, self.batch),
                         "precision": self.cfg["precision"]["train"]}}

    # -- the reference ----------------------------------------------------------------
    def reference_readings(self, lowered: bool = False, half: bool = False) -> dict:
        """The reference's readings of the checked steps from the drawn
        weights, batches and draws: each step's loss terms, the first
        gradient and the change of each leaf. ``lowered`` computes it in
        TF32 (the control); ``half`` leaves out the second half of each
        step's batch (a fault)."""
        step = ref_stage2.Step(self.cfg, self.tr, self.state, self.device)
        if lowered:
            step.lower("tf32")
        img = self.cfg["Data"]["img_size"]
        step.init_actnorm(ref_stage1.augment(self.raw(0), img, self.params, self.draws(0)[0]),
                          self.actnorm_eps())
        named = dict(step.net.flow.named_parameters())
        index = {id(p): j for j, p in enumerate(step.opt.params)}
        before = {k: p.detach().clone() for k, p in named.items()}
        rows = self.batch // 2 if half else self.batch
        losses, grads = [], {}
        for i in range(int(self.traffic["checked_steps"])):
            aug_draws, eps, _ = self.draws(i)
            seq = ref_stage1.augment(self.raw(i), img, self.params, aug_draws)
            losses.append(step(seq[:rows], eps[:rows]))
            if i == 0:
                grads = {k: float(step.opt.mu[index[id(p)]].norm()) / (1.0 - step.opt.b1)
                         for k, p in named.items()}
        change = {k: float((p.detach() - before[k]).norm()) for k, p in named.items()}
        return {"losses": losses, "grads": grads, "change": change}

    def compare(self, got: dict, want: dict) -> dict[str, float]:
        """``loss_gap``: the largest relative gap of the three loss terms
        over the checked steps. ``grad_gap``: the worst leaf of the first
        gradient. ``change_gap``: the worst leaf of the change over the
        checked steps, of the leaves whose reference gradient is at least a
        thousandth of the median leaf's."""
        steps = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in LOSSES)
                 for g, w in zip(got["losses"], want["losses"])]
        print("loss gap by step: " + ", ".join(f"{v:.3g}" for v in steps), file=sys.stderr)
        print("reference loss terms by step: " + "; ".join(
            ", ".join(f"{k} {w[k]:.6g}" for k in LOSSES) for w in want["losses"]), file=sys.stderr)
        median = statistics.median(want["grads"].values())
        moving = {k for k, v in want["grads"].items() if v >= 1e-3 * median}
        print(f"change: {len(want['grads']) - len(moving)} of {len(want['grads'])} leaves left "
              "out (reference gradient under 1e-3 of the median leaf's)", file=sys.stderr)
        return {"loss_gap": max(steps),
                "grad_gap": worst_leaf(got["grads"], want["grads"]),
                "change_gap": worst_leaf(got["change"], want["change"], moving)}

    def control(self) -> dict:
        """The reference in TF32 in the program's place."""
        self.prepare()
        return self.compare(self.reference_readings(lowered=True), self.reference_readings())

    def fault_half(self) -> dict:
        """The reference on half of each batch in the program's place."""
        self.prepare()
        return self.compare(self.reference_readings(half=True), self.reference_readings())

    def check(self) -> list[tuple[str, float, float]]:
        self.network = self.encoder = self.optimizer = self.named = self.pending = None
        harness.free(self.device)
        got = self.compare({"losses": self.losses, "grads": self.grad_norms,
                            "change": self.change_norms}, self.reference_readings())
        limits = self.traffic["limits"]
        return [(k, got[k], float(limits[k])) for k in ("loss_gap", "grad_gap", "change_gap")]
