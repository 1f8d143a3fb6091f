"""Stage-1 training: the train augment on the device, then
``Stage1Step.__call__(seq, epoch, draws)`` with the gates open, one step a
call; the metrics stay on the device and are fetched every ``fetch_every``
steps.

The clips are ``n_clips`` uint8 moving-square clips made on the device from
the seed (after ``cli/convergence_drive.py::moving_squares``), taken
``batch`` at a time in order, so the first steps' rows all differ. Each
step's augment draws (flip, colour factors and order) and ``StepDraws``
(eps, subsample start, patch frames) come from a CPU generator keyed by the
seed and the step, as the trainer's ``Draws`` give CPU tensors.

Set-up builds the models with the trainer's ``build_models``, loads the
seeded weights, runs the patch discriminator's ActNorm init on the first
batch's first 20 frames, and drives the one ``Stage1Step`` through its
first ``checked_steps`` steps by the window's own call, reading each step's
losses, the first step's gradient from the optimizers' state
(mu / (1 - beta1)) and the parameters' change after the last. The window
goes on with that same object. ``check`` runs the reference's step from the
same weights, batches and draws and compares the three.
"""

from __future__ import annotations

import contextlib
import statistics
import sys

import torch
from torch.profiler import record_function

from portbench import count, harness
from portbench.reference import stage1 as ref_stage1
from portbench.reference.nn import init_actnorm, set_precision
from portbench.weights import draw_state, seeded

NETWORKS = ("decoder", "encoder", "disc_t", "disc_s", "lpips")
SQUARE = 8
COLOUR = (250, 120, 30)


def moving_squares(n: int, frames: int, img: int, gen: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """``n`` uint8 clips (frames, img, img, 3): an 8 px square on a static
    noise background, moving by (dx, dy) in [-2, 2] a frame."""
    base = torch.randint(0, 40, (n, 1, img, img, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    start = torch.randint(0, img - SQUARE, (n, 1, 2), generator=gen, device=device)
    step = torch.randint(-2, 3, (n, 1, 2), generator=gen, device=device)
    f = torch.arange(frames, device=device).view(1, -1, 1)
    pos = (start + f * step).clamp(0, img - SQUARE)  # (n, frames, 2): x, y
    ax = torch.arange(img, device=device)
    in_x = (ax >= pos[..., 0:1]) & (ax < pos[..., 0:1] + SQUARE)
    in_y = (ax >= pos[..., 1:2]) & (ax < pos[..., 1:2] + SQUARE)
    mask = (in_y[..., :, None] & in_x[..., None, :])[..., None]
    colour = torch.tensor(COLOUR, dtype=torch.uint8, device=device)
    return torch.where(mask, colour, base.expand(n, frames, img, img, 3))


def augment_draws(n: int, params: dict, gen: torch.Generator) -> dict:
    """The per-clip draws of the train augment (no random crop): ``flip``,
    ``crop`` (zeros), ``factors`` ~ U(max(0, 1 - x), 1 + x) and ``order``, a
    permutation of the enabled colour ops."""
    ops = [o for o in ref_stage1.COLOUR_OPS if params.get(o, 0.0)]
    lo = torch.tensor([max(0.0, 1.0 - params[o]) for o in ops])
    hi = torch.tensor([1.0 + params[o] for o in ops])
    return {"flip": torch.rand(n, generator=gen) < params.get("prob_hflip", 0.5),
            "crop": torch.zeros(n, 2, dtype=torch.int64),
            "factors": (lo + (hi - lo) * torch.rand(n, len(ops), generator=gen)).float(),
            "order": torch.argsort(torch.rand(n, len(ops), generator=gen), dim=1)}


def first_frames(seq: torch.Tensor) -> torch.Tensor:
    """The batch's first 20 frames, (20, 3, H, W): the patch discriminator's
    ActNorm init, as the trainer takes it."""
    return seq.reshape((-1,) + seq.shape[2:])[:ref_stage1.N_PATCH].permute(0, 3, 1, 2)


def objectives(losses: dict, w_gp: float) -> dict[str, float]:
    """The three optimizers' objectives of a step."""
    return {"vae": float(losses["Loss_VAE"]),
            "disc_t": float(losses["Loss_Disc_T"]) + w_gp * float(losses["L_GP"]),
            "disc_s": float(losses["Loss_Disc_S"])}


def worst_leaf(got: dict[str, float], want: dict[str, float], keep=None) -> float:
    """The largest gap |got - want| over leaves, each against the larger of
    its reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names)


class Runner:
    loop = "steps"
    unit_metric = "train_clips_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = int(traffic["batch"])
        self.epoch = int(traffic.get("epoch", cfg["Training"]["pretrain"]))
        self.tr = dict(cfg["Training"], bs=self.batch)
        self.params = cfg["Data"]["Augmentation"]
        self.traced = False
        self.pending: list[dict] = []

    # -- inputs -------------------------------------------------------------------
    def raw(self, i: int) -> torch.Tensor:
        n = self.clips.shape[0]
        k = (i * self.batch) % n
        return self.clips[k:k + self.batch]

    def draws(self, i: int):
        gen = torch.Generator().manual_seed((self.seed * 1_000_003 + 5000 + i) % (1 << 63))
        frames = self.cfg["Data"]["sequence_length"] - 1
        sub = int(self.tr["subsample_length"])
        aug = augment_draws(self.batch, self.params, gen)
        eps = torch.randn(self.batch, self.cfg["Decoder"]["z_dim"], generator=gen)
        start = int(torch.randint(0, max(1, frames - sub + 1), (), generator=gen))
        patches = torch.randint(0, self.batch * frames, (ref_stage1.N_PATCH,), generator=gen)
        return aug, eps, start, patches

    def state_dicts(self) -> dict:
        cfg = self.cfg
        fns = {"decoder": lambda: ref_stage1.Generator.from_config(cfg["Decoder"], trainable=True),
               "encoder": lambda: ref_stage1.Encoder(cfg["Encoder"]),
               "disc_t": lambda: ref_stage1.Discriminator(cfg["Discriminator_Temporal"]),
               "disc_s": lambda: ref_stage1.NLayerDiscriminator(cfg["Discriminator_Patch"]),
               "lpips": ref_stage1.LPIPS}
        return {name: draw_state(fn, seeded(self.seed, self.device, 10 + k), self.device)
                for k, (name, fn) in enumerate(fns.items())}

    # -- set-up ---------------------------------------------------------------------
    def setup(self, phases) -> None:
        from image2video_synthesis_using_cinns_tpu_torch.config import Config
        from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
        from image2video_synthesis_using_cinns_tpu_torch.models import layers
        from image2video_synthesis_using_cinns_tpu_torch.train import stage1
        from image2video_synthesis_using_cinns_tpu_torch.train.stage1_step import (
            Stage1Step, make_optimizers)

        cfg, dev = self.cfg, self.device
        opt = Config({k: cfg[k] for k in ("Decoder", "Encoder", "Discriminator_Temporal",
                                          "Discriminator_Patch", "Data")})
        opt.Training = Config(self.tr)
        self.prepare()
        phases("weights and clips")
        models = stage1.build_models(opt, weights_root=str(harness.ROOT / "portbench" / "none"))
        for name in NETWORKS:
            getattr(models, name).load_state_dict(self.state[name])
        self.models = models.to(dev)
        phases("program build")
        self.aug = build_augment(cfg["Data"]["img_size"], self.params, False, True)
        first = self.aug(self.raw(0), draws=self.draws(0)[0])
        layers.init_actnorm(self.models.disc_s, first_frames(first))
        optimizers = make_optimizers(self.models, float(self.tr["lr"]),
                                     float(self.tr["weight_decay"]))
        self.step = Stage1Step(self.models, optimizers, self.tr)
        phases("ActNorm init")
        self.named = {name: dict(getattr(self.models, name).named_parameters())
                      for name in ("decoder", "encoder", "disc_t", "disc_s")}
        before = {f"{n}.{k}": p.detach().clone() for n, ps in self.named.items()
                  for k, p in ps.items()}
        self.losses = []
        for i in range(int(self.traffic["checked_steps"])):
            self.call(i)
            self.losses.append({k: float(v) for k, v in self.fetch()[0].items()})
            if i == 0:
                self.grad_norms = self.first_grads(optimizers)
        self.change_norms = {f"{n}.{k}": float((p.detach() - before[f"{n}.{k}"]).norm())
                             for n, ps in self.named.items() for k, p in ps.items()}
        del before

    def first_grads(self, optimizers) -> dict[str, float]:
        """Each leaf's first gradient as its optimizer got it: mu / (1 - beta1)."""
        opt_ae, opt_dt, opt_ds = optimizers
        owner = {"decoder": opt_ae, "encoder": opt_ae, "disc_t": opt_dt, "disc_s": opt_ds}
        out = {}
        for n, ps in self.named.items():
            opt = owner[n]
            b1 = opt.param_groups[0]["betas"][0]
            for k, p in ps.items():
                st = opt.state.get(p) or {}
                mu = st.get("mu")
                out[f"{n}.{k}"] = 0.0 if mu is None else float(mu.norm()) / (1.0 - b1)
        return out

    # -- the window ------------------------------------------------------------------
    def call(self, i: int) -> int:
        from image2video_synthesis_using_cinns_tpu_torch.train.stage1_step import StepDraws

        aug_draws, eps, start, patches = self.draws(i)
        if self.traced:
            with record_function("bench/augment"):
                seq = self.aug(self.raw(i), draws=aug_draws)
        else:
            seq = self.aug(self.raw(i), draws=aug_draws)
        metrics, _ = self.step(seq, self.epoch, StepDraws(eps, start, patches))
        self.pending.append(metrics)
        return self.batch

    def fetch(self) -> list[dict]:
        """The pending steps' metrics, in one copy to the host."""
        keys = list(self.pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in self.pending])
        values = rows.cpu().tolist()
        self.pending = []
        return [dict(zip(keys, v)) for v in values]

    @contextlib.contextmanager
    def spans(self):
        """The benchmark's span around the augment (the step's own spans are
        the program's)."""
        self.traced = True
        try:
            yield
        finally:
            self.traced = False

    def counts(self) -> dict:
        return {"step": {"flops": count.stage1_step_flops(self.cfg, self.batch),
                         "precision": self.cfg["precision"]["train"]}}

    # -- the reference ----------------------------------------------------------------
    def reference_readings(self, lowered: bool = False, half: bool = False) -> dict:
        """The reference's readings of the checked steps from the drawn
        weights, batches and draws: each step's losses, the first gradient
        and the change of each leaf. ``lowered`` computes it in TF32 (the
        control); ``half`` leaves out the second half of each batch (a
        fault)."""
        with torch.device(self.device):
            ref = ref_stage1.Models.from_config(self.cfg)
        for name, module in ref.named().items():
            module.load_state_dict(self.state[name])
            if lowered:
                set_precision(module, "tf32")
        ref.lpips.requires_grad_(False)
        img = self.cfg["Data"]["img_size"]
        first = ref_stage1.augment(self.raw(0), img, self.params, self.draws(0)[0])
        init_actnorm(ref.disc_s, first_frames(first))
        step = ref_stage1.Step(ref, self.tr)
        named = {n: dict(getattr(ref, n).named_parameters())
                 for n in ("decoder", "encoder", "disc_t", "disc_s")}
        before = {f"{n}.{k}": p.detach().clone() for n, ps in named.items() for k, p in ps.items()}
        owner = {"decoder": step.opt_ae, "encoder": step.opt_ae, "disc_t": step.opt_dt,
                 "disc_s": step.opt_ds}
        frames = self.cfg["Data"]["sequence_length"] - 1
        rows = self.batch // 2 if half else self.batch
        losses, grads = [], {}
        for i in range(int(self.traffic["checked_steps"])):
            aug_draws, eps, start, patches = self.draws(i)
            seq = ref_stage1.augment(self.raw(i), img, self.params, aug_draws)
            losses.append(step(seq[:rows], self.epoch, eps[:rows], start,
                               patches % (rows * frames)))
            if i == 0:
                for n, ps in named.items():
                    opt = owner[n]
                    index = {id(p): j for j, p in enumerate(opt.params)}
                    for k, p in ps.items():
                        grads[f"{n}.{k}"] = float(opt.mu[index[id(p)]].norm()) / (1.0 - opt.b1)
        change = {f"{n}.{k}": float((p.detach() - before[f"{n}.{k}"]).norm())
                  for n, ps in named.items() for k, p in ps.items()}
        return {"losses": losses, "grads": grads, "change": change}

    def compare(self, got: dict, want: dict) -> dict[str, float]:
        """``loss_gap``: the first step's three objectives, the largest
        relative gap. ``grad_gap``: the worst leaf of the first gradient.
        ``change_gap``: the worst leaf of the change over the checked
        steps, of the leaves whose reference gradient is at least a
        thousandth of the median leaf's."""
        w_gp = float(self.tr["w_GP"])
        steps = []
        for got_i, want_i in zip(got["losses"], want["losses"]):
            g, w = objectives(got_i, w_gp), objectives(want_i, w_gp)
            steps.append(max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w))
        print("loss gap by step (the first is compared): "
              + ", ".join(f"{v:.3g}" for v in steps), file=sys.stderr)
        median = statistics.median(want["grads"].values())
        moving = {k for k, v in want["grads"].items() if v >= 1e-3 * median}
        print(f"change: {len(want['grads']) - len(moving)} of {len(want['grads'])} leaves left "
              "out (reference gradient under 1e-3 of the median leaf's)", file=sys.stderr)
        return {"loss_gap": steps[0],
                "grad_gap": worst_leaf(got["grads"], want["grads"]),
                "change_gap": worst_leaf(got["change"], want["change"], moving)}

    def prepare(self) -> None:
        """The weights and clips alone, for readings without the program."""
        self.state = self.state_dicts()
        self.clips = moving_squares(int(self.traffic["n_clips"]),
                                    self.cfg["Data"]["sequence_length"],
                                    self.cfg["Data"]["img_size"], seeded(self.seed, self.device, 7),
                                    self.device)

    def control(self) -> dict:
        """The reference in TF32 in the program's place."""
        self.prepare()
        return self.compare(self.reference_readings(lowered=True), self.reference_readings())

    def fault_half(self) -> dict:
        """The reference on half of each batch in the program's place."""
        self.prepare()
        return self.compare(self.reference_readings(half=True), self.reference_readings())

    def check(self) -> list[tuple[str, float, float]]:
        self.step = self.models = self.named = self.pending = None
        harness.free(self.device)
        got = self.compare({"losses": self.losses, "grads": self.grad_norms,
                            "change": self.change_norms}, self.reference_readings())
        limits = self.traffic["limits"]
        return [(k, got[k], float(limits[k])) for k in ("loss_gap", "grad_gap", "change_gap")]
