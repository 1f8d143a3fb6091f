#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: versions, the card's name and power limit; TF32 off for
   matmuls and convolutions, so fp32 means fp32.
2. Build every CUDA source of the sampling path from ``csrc/`` (one nvcc per
   source, all started together: the chain kernel and its timeline build)
   and print the build time and ptxas report.
3. Kernel against its plain PyTorch version on the card at the BAIR flow
   shape (B=6, C=64, E=64 or 94 with control, hidden 512, 20 blocks), with
   seeded random weights and a non-trivial ActNorm (and one block alone, at
   a tighter tolerance): reverse, forward with logdet, a forward -> reverse
   round trip, in fp32- and bf16-weight mode. Then at the landscape flow
   shape (E=128): reverse at B=6, forward at B=6 and at B=1 (the transfer's
   query), the round trip at B=1, in both weight modes.
4. The sampling path at the full BAIR preset with random weights:
   ``Model.sample`` (bs=6, 64x64 x0) at 16 and 24 frames (the autoregressive
   extension), fp32 and bf16 decoder, and ``Model.forward``. Launch counters
   are zeroed just before these calls and read just after; every chain must
   have been one device kernel. Then, outside that window, the flow forward
   (``SupervisedTransformer``) maps the sampled z back to nu.
   4b. The transfer path at the full landscape preset with random weights:
   ``Model.transfer_sample`` (one 17-frame 128x128 query, 6 start frames),
   fp32 and bf16 decoder, and a landscape ``Model.sample`` (bs=6, 16 frames),
   in a second counted window: both chains must have launched, one device
   kernel each. Checks: videos, z against the plain chains, z the same
   across decoders, and the query's own motion back through its own frame.
   4c. Offline evaluation at the full BAIR preset: synthetic BAIR test
   splits (50 and 16 clips of 30 64x64 frames drawn from a seed, no image
   codec) packed into FrameStores; full-size I3D (kinetics, DT-16),
   Inception and LPIPS with random weights from a seed, written with the
   port's ``save`` where the loaders look for them. The eval CLIs' bodies
   run each in its own counted window: synthesis quality (fp32 decoder,
   bs=6, 16 frames, FID+LPIPS+FVD+DTFVD; 9 chains) and diversity (bf16
   decoder, 5 realisations, VGG+I3D+DTI3D; 15 chains), one device kernel per
   chain and no forward chain. Checks: every metric finite; FVD, DTFVD and
   FID of a set against itself near 0 (``self_distance``), LPIPS(x, x) = 0;
   each backbone on the card against the same module on the CPU
   (``BACKBONE_TOL``); the stream's Fréchet values against activations taken
   at another batch size (``BATCHING_TOL``). Then the eval's wall time and
   clips/s for each body and its stages, each timed alone.
   4d. Stage-2 training at the full BAIR preset: the trainer's ``train``
   (``configs/stage2/bair_config.yaml``'s Training and Data: bs 50, amsgrad,
   the train augment) over synthetic train and eval splits of 100 and 40
   clips packed into FrameStores, random full-size models, the I3D of 4c for
   the prior FVD, 2 epochs of 2 steps with the ActNorm init, validation,
   prior FVD and checkpoints, in its own counted window: one forward chain
   per validation batch and one reverse chain per prior-FVD batch, fp32
   weights, each one device kernel. Checks: losses and the FVD finite; one
   step on the card against the CPU at bs 4: in fp32 the posterior, the
   embedding and the loss, each no further from the CPU's fp64 step than
   the CPU's fp32 (``FP32_RATIO``), in fp64 the loss and the flow's
   gradients (``F64_LOSS_TOL``, ``F64_GRAD_TOL``); the validation NLL through the
   forward kernel against the plain flow's (``KERNEL_NLL_TOL``); the reverse
   chain back to the posterior (``INVERSE_TOL``); both checkpoints reload
   into a fresh cINN; 10 steps on one batch lower its NLL. Then the step's
   time at bs 50 (fp32 and bf16 encoder), its stages each alone, the
   validation pass and the prior FVD, and both chains in fp32 at B=10.
   4e. Stage-1 training at the full BAIR preset: the trainer's ``train``
   (``configs/stage1/bair_config.yaml``: the 3-D ResNet-18 encoder, the
   SPADE/ADAIN decoder with spectral norm, the temporal and patch
   discriminators, bs 10, 12-frame subsample, three Adams) over synthetic
   train and eval splits of 20 clips in FrameStores, random full-size
   networks, the LPIPS and I3D of 4c, 2 epochs of 2 steps (epoch 0 with the
   discriminators gated) with the ActNorm init, validation, posterior FVD and
   checkpoints, in its own counted window (no flow chain on this path).
   Checks: every loss, PSNR, SSIM and the FVD finite; one whole step on the
   card against the CPU at bs 1, in fp64 the metrics and the three
   optimizers' gradients (``F64_LOSS_TOL``, ``F64_GRAD_TOL``), fp32
   reported; a gated step leaves both discriminators' parameters bitwise and
   their Adam counts at 0 while their ``u`` moves, an open one moves them;
   the ActNorm init normalises each ActNorm's output (``ACTNORM_TOL``); the
   run's GEN and ENC in the folded serving modules reconstruct as the
   training modules (``SERVE_TOL``); every checkpoint reloads; 10 gated steps
   at ``S1_LEARN_LR_SCALE`` of the config's lr on one batch lower its L1 (the
   same at the config's lr reported). Then the step's time at bs 10 (fp32 and bf16)
   and its peak memory, its stages each alone, the validation pass and the
   posterior FVD.
   4f. Stage-2 AE training at the full BAIR preset: the trainer's ``train``
   (``configs/stage2_AE/bair_config.yaml``: the ResNet-50 'in' encoder, the
   BigGAN decoder at chn 96, z 64, the patch discriminator, bs 30, w_kl
   1e-5, lr 2e-4) over synthetic train and eval splits of 60 clips in
   FrameStores, random full-size networks, 2 epochs of 2 steps (pretrain
   cut to 1: epoch 0 gated, epoch 1 open) with the discriminator's ActNorm
   init, validation and ``Encoder_stage2``, in its own counted window (no
   flow chain on this path). Checks: losses, ``Logvar`` and ``Disc_weight``
   finite; one whole step on the card against the CPU at bs 2, with the
   discriminator's spectral vectors converged before its ActNorm init, in
   fp64 the losses (``F64_LOSS_TOL``), and ``Disc_weight`` (a ratio of
   gradient norms) and both optimizers' gradients (``F64_GRAD_TOL``), fp32
   and the run's own collapsed-discriminator state reported; a gated step leaves
   the discriminator bitwise with its Adam count 0 while its ``u`` moves, an
   open one with d_loss > 0 moves it; the ActNorm init normalises
   (``ACTNORM_TOL``); each BatchNorm's running statistics move once in a
   train step and not in an eval step; the written ``Encoder_stage2`` in the
   serving ``ResnetEncoder`` and in a stage-2 ``build_models`` embedder
   (chained to 4e's run) embeds as the training module did (``SERVE_TOL``);
   10 steps at ``AE_LEARN_LR_SCALE`` of the lr lower one batch's
   ``Loss_recon``. Then the step's time at bs 30 and its peak memory, the
   validation pass, and one step of the landscape AE (128 px, 'bn' encoder,
   z 128, the attention) timed and checked finite.
   4g. Endpoint control: ``visualize_endpoint``'s body on a synthetic BAIR
   endpoint test split (12 clips with end-effector positions) and a random
   full-size control model, in its own counted window (4 reverse chains).
   Checks: the videos finite in [-1, 1]; the chain's z against its plain
   version.
5. Timings: each kernel's median ms beside its plain version and its bound;
   the reverse chain at B = 1, 6 and 16; where a chain's time goes, from the
   timeline build (per layer and pass, and the kernel's own span), and a
   probe of a grid barrier written by hand beside cooperative groups' grid
   sync (the chain itself has no grid barrier); and ``Model.forward``
   latency and frames/s. Then the transfer: its latency and frames/s, its
   stages each timed alone (encoder, embedder, flow forward at B=1, flow
   reverse at B=6, decoder), and both kernels at the landscape shape beside
   their plain versions and bounds. Each line carries the card's name and
   power limit.
6. ``torch.profiler`` traces of two bf16 ``Model.forward`` calls, of two
   bf16 landscape ``Model.transfer`` calls, of two synthesis-eval steps
   (sample a batch, all four backbones), of two stage-2 training steps, of
   two stage-1 training steps and of two stage-2 AE training steps (device
   time by stage span): the top device kernels, the flow
   chain's share, the device's idle share, and the host and device time
   before the first flow chain (the embedder; in transfer, the encoder and
   the query's embedding). The traces are written to ``smoke_out/`` (listed
   in ``.gitignore``).
7. A ``{"kernels": [...]}`` line (launches summed over the eight counted
   windows), then the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible, and when the
port's package is not beside it.
"""

from __future__ import annotations

import ctypes
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 outside the tensor cores
# allclose tolerances (|a - b| <= tol + tol * |b|) for the 20-block chain:
# fp32 differs only in the order of sums; bf16 as tests/test_pallas_flow.py
# holds the Pallas kernel, since 20 blocks of exp(+-s) amplify the rare bf16
# input that a differently ordered fp32 sum rounds the other way
TOL = {"fp32": 1e-4, "bf16": 2e-2}
# one block alone: float rounding, plus in bf16 the odd input rounded the
# other way (a few 1e-5); a missed bf16 rounding point moves the output by
# about 1e-3, which phase 3 shows by holding the kernel against a plain
# version that does not round its activations
TOL_ONE_BLOCK = {"fp32": 1e-5, "bf16": 1e-4}
PALLAS_KERNEL = "image2video_synthesis_using_cinns_tpu/ops/pallas/flow_kernel.py"
SOURCE = "image2video_synthesis_using_cinns_tpu_torch/csrc/flow_chain.cu"
LIBRARIES = ("flow_chain", "flow_chain_timeline")  # csrc/<name>.cu, built at once
SWEEP = (1, 6, 16)  # batch sizes of the reverse chain's sweep
OUT_DIR = Path(__file__).resolve().parent / "smoke_out"
DEVICE = "cuda"
PRESET = "bair"  # the sampling path's model: full width, random weights
TRANSFER_PRESET = "landscape"  # the transfer path's model: full width, random weights
QUERY_FRAMES = 17  # the encoder sees the 16 after the first
BATCH = 6
# phase 4c, offline evaluation at the BAIR preset: a synthetic test split of
# 30-frame 64x64 clips; 50 clips give the synthesis run a ragged last batch
# (9 batches of 6, the last of 2), the FVD x16 drop (keeps 48) and the DTFVD
# drop (keeps 40); diversity takes 16 clips of 5 realisations (3 batches)
EVAL_CLIPS, DIVERSITY_CLIPS, N_REALIZ, EVAL_SEQ = 50, 16, 5, 16
BAIR_FRAMES, BAIR_PX = 30, 64
# card against CPU, relative to the largest output: fp32 through 20 (VGG) to
# 100 (Inception) layers, sums in another order on each side, TF32 off
BACKBONE_TOL = 1e-4
# the stream's Fréchet values against activations taken at another batch size
BATCHING_TOL = 1e-6
# phase 4d, stage-2 training at the BAIR preset: the Training and Data
# sections of configs/stage2/bair_config.yaml (copied here: the card's machine
# may have no YAML reader), its 30 loader workers cut to the machine's 8
# cores, 2 epochs; synthetic train and eval splits of 100 and 40 clips of 30
# 64x64 frames (2 steps of 50 clips an epoch, 4 eval batches of 10)
TRAIN_CLIPS, TRAIN_EVAL_CLIPS, TRAIN_EPOCHS, TRAIN_WORKERS = 100, 40, 2, 8
TRAIN_CONFIG = dict(n_epochs=TRAIN_EPOCHS, lr=1.0e-05, workers=TRAIN_WORKERS, bs=50, bs_eval=10,
                    control=False, verbose_idx=30, weight_decay=0, gamma=0.5, step_size=7,
                    beta1=0.9, beta2=0.99, amsgrad=True, steps_per_dispatch=8,
                    savename="chip_smoke")
TRAIN_DATA = dict(sequence_length=17, dataset="BAIR", img_size=64, reverse=False, aug=True,
                  framestore="off", Augmentation=dict(brightness=0.1, contrast=0.1,
                                                      saturation=0.1, hue=0, prob_hflip=0.5))
GRAD_CHECK_BATCH = 4  # clips of the card-against-CPU step
# card against CPU, one step on the same batch and eps, TF32 off. In fp32
# the posterior and the embedding (over their largest magnitude) and the loss
# (over the scale of its two terms) are held against the CPU's fp64 step: the
# card's error may be at most FP32_RATIO times the CPU's own fp32 error (or
# FP32_FLOOR): random weights make the InstanceNorm embedder amplify rounding
# (2.7e-4 card vs CPU on an H100), and TF32 rounds about 1e4 times
# coarser than fp32. The fp32 gradients are reported, not bounded: a rounding difference
# that moves a pre-activation across a LeakyReLU kink changes a whole row of
# a gradient (the card's and the CPU's fp32 both 2.8e-2 of the largest from
# fp64 on an H100). The same step in fp64 holds the loss and the
# gradients, where rounding cannot reach a kink.
FP32_RATIO, FP32_FLOOR = 10.0, 1e-6
F64_LOSS_TOL, F64_GRAD_TOL = 1e-10, 1e-8
# the validation NLL through the forward kernel against the plain flow's,
# relative to the loss; and the reverse chain back to the posterior (allclose)
KERNEL_NLL_TOL, INVERSE_TOL = 1e-5, 1e-4
TRAIN_SPANS = ("stage2/posterior", "stage2/embedder", "stage2/flow", "stage2/optimizer")
# phase 4e, stage-1 training at the BAIR preset: configs/stage1/bair_config.yaml
# (copied here), its 20 loader workers cut to the machine's 8, 2 epochs (epoch
# 0 with the discriminators gated, epoch 1 open); synthetic train and eval
# splits of 20 clips of 30 64x64 frames (2 steps of 10 clips an epoch, 2 eval
# batches)
S1_CLIPS, S1_EPOCHS = 20, 2
S1_MODELS = dict(
    Decoder=dict(channel_factor=64, z_dim=64, upsample_s=[2, 1], upsample_t=[2, 1],
                 spectral_norm=True),
    Encoder=dict(res_type_encoder="resnet18", deterministic=False, use_max_pool=False, z_dim=64,
                 channels=[64, 128, 256, 512, 512], stride_t=[1, 2, 2, 2], stride_s=[1, 2, 2, 2]),
    Discriminator_Temporal=dict(eval_seq_length=16, res_type_encoder="resnet18",
                                deterministic=False, use_max_pool=True,
                                channels=[64, 64, 128, 256, 512], stride_t=[2, 2, 2, 2],
                                stride_s=[1, 1, 2, 2], spectral_norm=True),
    Discriminator_Patch=dict(in_channels=3, ndf=64, n_layers=3, use_actnorm=True,
                             spectral_norm=True))
S1_TRAINING = dict(patch_GAN="basic", GAN_Loss="hinge", w_coup_s=1, w_coup_t=1, w_fmap_t=10,
                   w_percep=30, w_recon=10, w_GP=10, w_kl=1.0e-05, subsample_length=12,
                   pretrain=1, n_epochs=S1_EPOCHS, lr=0.0002, workers=TRAIN_WORKERS, bs=10,
                   bs_eval=10, verbose_idx=30, weight_decay=1.0e-05, lr_gamma=0.98, FVD="FVD",
                   savename="chip_smoke", reload_path="")
S1_DATA = dict(sequence_length=17, dataset="BAIR", img_size=64, reverse=False, aug=True,
               framestore="off", Augmentation=dict(brightness=0.1, contrast=0.1, saturation=0.1,
                                                   hue=0, prob_hflip=0.5))
S1_CHECK_BATCH = 1  # clips of the card-against-CPU step
# the learning check's lr, a fraction of the config's (as the CPU step tests
# take): at the config's 2e-4, fresh Adam's sign-like steps (beta1 0.5) have
# left the random decoder's tanh saturated after the run's 4 steps, and 10
# more move one batch's L1 up or down by chance (it is reported, not checked)
S1_LEARN_LR_SCALE = 0.1
# the ActNorm init: each ActNorm's output on the init frames, per channel,
# |mean| and |std - 1| (the scale is 1 / (std + 1e-6), fp32 sums over the frames)
ACTNORM_TOL = 1e-3
# the run's checkpoints in the folded serving modules against the training
# modules' eval forward (sigma folded in fp64 at load, divided in fp32 there)
SERVE_TOL = 1e-5
S1_SPANS = ("stage1/vae_forward", "stage1/disc_t", "stage1/disc_s", "stage1/spectral",
            "stage1/vae_loss", "stage1/vae_backward", "stage1/optimizer")
# phase 4f, stage-2 AE training at the BAIR preset: configs/stage2_AE/bair_config.yaml
# (copied here), its 30 loader workers cut to the machine's 8, its pretrain 20 cut to 1
# (epoch 0 gated, epoch 1 open), 2 epochs; synthetic train and eval splits of 60
# clips (2 steps of 30 an epoch, 2 eval batches). chn is the AE's default, 96.
AE_CLIPS, AE_EPOCHS = 60, 2
AE_MODELS = dict(
    AE=dict(deterministic=False, in_size=64, norm="in", encoder_type="resnet50",
            use_actnorm_in_dec=False, z_dim=64, pre_process=False, pretrained=False),
    Discriminator_Patch=dict(in_channels=3, ndf=64, n_layers=3, use_actnorm=True,
                             spectral_norm=True))
AE_TRAINING = dict(w_kl=1.0e-05, n_epochs=AE_EPOCHS, lr=0.0002, bs=30, weight_decay=0,
                   workers=TRAIN_WORKERS, pretrain=1, steps_per_dispatch=8, savename="chip_smoke")
AE_DATA = dict(sequence_length=1, dataset="BAIR", img_size=64, reverse=False, aug=True,
               framestore="off", Augmentation=dict(brightness=0.2, contrast=0.2, saturation=0.2,
                                                   hue=0.1, prob_hflip=0.5))
# the landscape AE (configs/stage2_AE/landscape_config.yaml: its AE, Training and Data
# sections copied here, with the BAIR phase's cuts): 128 px, where the generator's
# SelfAttention runs, and the encoder's BatchNorm on batch statistics
AE_LANDSCAPE = dict(AE_MODELS["AE"], in_size=128, norm="bn", z_dim=128)
AE_LANDSCAPE_TRAINING = dict(AE_TRAINING, w_kl=1.0e-04)
AE_LANDSCAPE_DATA = dict(sequence_length=1, dataset="landscape", img_size=128, iter_train=20,
                         iter_eval=2, iter_test=6, aug=True, framestore="off",
                         Augmentation=dict(brightness=0.3, contrast=0.3, saturation=0.3,
                                           hue=0.1, prob_hflip=0.5))
AE_CHECK_BATCH = 2  # images of the card-against-CPU step
AE_SN_ITERS = 20  # power iterations of the held card-against-CPU state (see phase_train_ae)
AE_LEARN_LR_SCALE = 0.1  # the learning check's lr, a fraction of the config's (as in 4e)
AE_SPANS = tuple(f"stage2_ae/{s}" for s in (
    "forward", "colorize_grads", "backward", "gen_optimizer", "recompute", "disc",
    "disc_optimizer", "spectral"))
# the endpoint phase: visualize_endpoint's body on a synthetic BAIR endpoint test
# split of 12 clips, 2 realisations in batches of 6 (4 reverse chains)
ENDPOINT_CLIPS, ENDPOINT_REALIZ = 12, 2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_ratio(a, b, tol: float) -> float:
    """max |a - b| / (tol + tol * |b|): at most 1 where allclose(rtol=atol=tol)
    holds; with tol 0, 0 where a equals b and infinity elsewhere."""
    a, b = a.float(), b.float()
    if tol == 0:
        return 0.0 if bool((a == b).all()) else float("inf")
    return float(((a - b).abs() / (tol + tol * b.abs())).max())


def check(key: str, a, b, tol: float) -> float:
    err, ratio = max_err(a, b), close_ratio(a, b, tol)
    ok = ratio <= 1.0
    log(f"  {key}: max_abs_err={err:.3e} max|b|={float(b.abs().max()):.3g} "
        f"allclose(rtol=atol={tol:g}) ratio={ratio:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}: disagrees beyond tolerance")
    return err


def flow_case(control: bool, n_flows: int = 20, seed: int = 0, cond_z: int = 64):
    """A ConditionalFlow of C=64, hidden 512 and embedding ``cond_z`` (+30 with
    control: the BAIR shape at 64, the landscape one at 128) on the card, with
    seeded random weights, and 6 rows of input."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.flow import ConditionalFlow

    e = cond_z + (30 if control else 0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        flow = ConditionalFlow(64, e, 512, 2, n_flows, control=control)
        flow.blocks.actnorm.loc.data.normal_(0.0, 0.2)
        flow.blocks.actnorm.scale.data.uniform_(0.8, 1.25)
        x = torch.randn(BATCH, 64)
        emb = torch.randn(BATCH, e)
    return flow.to(DEVICE), x.to(DEVICE), emb.to(DEVICE)


def bf16_weights_only(blocks: dict) -> dict:
    """The flow's blocks with the coupling weights rounded to bf16: packed in
    fp32 mode, the plain version then rounds no activation."""
    import torch

    return {**blocks, "coupling": {
        net: [(w.to(torch.bfloat16).float(), b) for w, b in layers]
        for net, layers in blocks["coupling"].items()}}


def phase_kernel_vs_plain():
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    errs = {}
    for control, n_flows in ((False, 1), (False, 20), (True, 20)):
        flow, x, emb = flow_case(control, n_flows)
        for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            p = fk.PackedFlow(flow.blocks_dict(), flow.shuffle.fwd, flow.shuffle.inv, flow.mask,
                              dtype)
            tol = (TOL_ONE_BLOCK if n_flows == 1 else TOL)[mode]
            with torch.no_grad():
                z = fk.flow_reverse_fused(p, x, emb)
                z_ref = fk.flow_reverse_fused_ref(p, x, emb)
                y, ld = fk.flow_forward_fused(p, x, emb)
                y_ref, ld_ref = fk.flow_forward_fused_ref(p, x, emb)
                x_rt = fk.flow_reverse_fused(p, y, emb)
                torch.cuda.synchronize()
                cases = {
                    "reverse": (z, z_ref),
                    "forward": (y, y_ref),
                    "logdet": (ld, ld_ref),
                    "roundtrip": (x_rt, x),
                }
                if mode == "fp32":  # the fp32 mode is the plain exact flow
                    bd, sd = flow.blocks_dict(), flow.shuffle_dict()
                    cases["reverse_vs_flow_reverse"] = (
                        z, tflow.flow_reverse(bd, sd, x, emb, flow.mask))
                    cases["forward_vs_flow_forward"] = (
                        y, tflow.flow_forward(bd, sd, x, emb, flow.mask)[0])
                for name, (a, b) in cases.items():
                    key = f"blocks={n_flows} control={int(control)} {mode} {name}"
                    errs[key] = check(key, a, b, tol)
                if mode == "bf16" and n_flows == 1:
                    # the one-block tolerance must tell a kernel that rounds
                    # at the Pallas kernel's places from one that does not
                    p_fp32 = fk.PackedFlow(bf16_weights_only(flow.blocks_dict()),
                                           flow.shuffle.fwd, flow.shuffle.inv, flow.mask,
                                           torch.float32)
                    z_unrounded = fk.flow_reverse_fused_ref(p_fp32, x, emb)
                    ratio = close_ratio(z, z_unrounded, tol)
                    log(f"  blocks=1 bf16 reverse vs plain without activation rounding: "
                        f"max_abs_err={max_err(z, z_unrounded):.3e} ratio={ratio:.3f} "
                        f"(must exceed 1 at allclose {tol:g})")
                    if ratio <= 1.0:
                        raise AssertionError("the one-block bf16 tolerance cannot tell a missed "
                                             "rounding point")
    return errs


def phase_landscape_flow():
    """Both chains at the landscape flow shape (C=64, E=128, hidden 512, 20
    blocks): reverse at B=6 (the start frames), forward at B=6 and at B=1 (the
    transfer's one query), and the B=1 round trip, in both weight modes."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    errs = {}
    flow, x, emb = flow_case(False, cond_z=128, seed=3)
    x1, emb1 = x[:1].contiguous(), emb[:1].contiguous()
    bd, sd = flow.blocks_dict(), flow.shuffle_dict()
    for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = fk.PackedFlow(bd, flow.shuffle.fwd, flow.shuffle.inv, flow.mask, dtype)
        with torch.no_grad():
            y6, ld6 = fk.flow_forward_fused(p, x, emb)
            y1, ld1 = fk.flow_forward_fused(p, x1, emb1)
            cases = {
                "reverse B=6": (fk.flow_reverse_fused(p, x, emb),
                                fk.flow_reverse_fused_ref(p, x, emb)),
                "forward B=6": (y6, fk.flow_forward_fused_ref(p, x, emb)[0]),
                "logdet B=6": (ld6, fk.flow_forward_fused_ref(p, x, emb)[1]),
                "forward B=1": (y1, fk.flow_forward_fused_ref(p, x1, emb1)[0]),
                "logdet B=1": (ld1, fk.flow_forward_fused_ref(p, x1, emb1)[1]),
                "roundtrip B=1": (fk.flow_reverse_fused(p, y1, emb1), x1),
            }
            if mode == "fp32":  # the fp32 mode is the plain exact flow
                cases["reverse_vs_flow_reverse B=6"] = (
                    cases["reverse B=6"][0], tflow.flow_reverse(bd, sd, x, emb, flow.mask))
                cases["forward_vs_flow_forward B=1"] = (
                    y1, tflow.flow_forward(bd, sd, x1, emb1, flow.mask)[0])
            torch.cuda.synchronize()
            for name, (a, b) in cases.items():
                key = f"landscape E=128 {mode} {name}"
                errs[key] = check(key, a, b, TOL[mode])
    return errs


def zero_counts() -> None:
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    for counts in (fk.launches, fk.device_launches):
        for k in counts:
            counts[k] = 0


def check_video(key: str, vid, shape) -> None:
    import torch

    ok = (tuple(vid.shape) == shape and bool(torch.isfinite(vid).all())
          and float(vid.abs().max()) <= 1.0)
    log(f"  {key}: shape={tuple(vid.shape)} finite_in_range={ok}")
    if not ok:
        raise AssertionError(f"bad video: {key}")


def phase_main_path():
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model

    p = PRESETS[PRESET]
    models = {dt: build_model(PRESET, vid_length=16, seed=0, compute_dtype=dt, device=DEVICE)
              for dt in ("float32", "bfloat16")}
    img = p["img_size"]
    rng = np.random.default_rng(1234)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    residual = torch.from_numpy(
        rng.standard_normal((BATCH, p["z_dim"])).astype(np.float32)).to(DEVICE)

    outs = {}
    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        for dt, model in models.items():
            for t in (16, 24):
                model.vid_length = t
                outs[(dt, t)] = model.sample(x0, residual=residual)
        models["float32"].vid_length = 16
        drawn = models["float32"].forward(x0)  # nu drawn from the model's generator
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  main-path chain launches: {launches}; device kernels they launched: "
        f"{device_launches}")
    # sampling runs the flow in reverse only; the forward chain is off this path
    if launches["flow_reverse_fused"] < 1:
        raise AssertionError("flow_reverse_fused was not launched on the main path")
    if device_launches != launches:
        raise AssertionError("a chain launched other than one device kernel")

    with torch.no_grad():
        flow = models["float32"].flow
        z = outs[("float32", 16)][1]
        nu_back, logdet = flow(z, [x0])

    outs[("float32 drawn nu", 16)] = (drawn, None)
    for (dt, t), (vid, _) in outs.items():
        check_video(f"sample {dt} T={t}", vid, (BATCH, t, 3, img, img))
    with torch.no_grad():
        emb = flow.embed([x0])
        z = outs[("float32", 16)][1]
        z_ref = fk.flow_reverse_fused_ref(flow.flow.packed, residual, emb)
    if not bool(torch.isfinite(logdet).all()):
        raise AssertionError("non-finite logdet")
    check("z_vs_plain", z, z_ref, TOL["bf16"])
    check("z_same_across_dtypes", outs[("bfloat16", 24)][1], z, 0.0)
    check("z_repeatable", outs[("float32", 24)][1], z, 0.0)
    check("base_clip_kept_by_extension", outs[("float32", 24)][0][:, :16],
          outs[("float32", 16)][0], 1e-5)
    check("nu_roundtrip", nu_back, residual, 1e-2)
    return models, x0, residual, launches, device_launches


def phase_transfer():
    """The transfer path at the full landscape preset, in its own counted
    window, with a landscape ``Model.sample`` beside it; then its checks."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model

    p = PRESETS[TRANSFER_PRESET]
    models = {dt: build_model(TRANSFER_PRESET, vid_length=16, seed=0, compute_dtype=dt,
                              transfer=True, device=DEVICE)
              for dt in ("float32", "bfloat16")}
    img = p["img_size"]
    rng = np.random.default_rng(4321)
    q = torch.from_numpy(
        rng.uniform(-1, 1, (1, QUERY_FRAMES, 3, img, img)).astype(np.float32)).to(DEVICE)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    residual = torch.from_numpy(
        rng.standard_normal((BATCH, p["z_dim"])).astype(np.float32)).to(DEVICE)

    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        outs = {dt: model.transfer_sample(q, x0) for dt, model in models.items()}
        sampled = models["float32"].sample(x0, residual=residual)
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  transfer-path chain launches: {launches}; device kernels they launched: "
        f"{device_launches}")
    for name in ("flow_forward_fused", "flow_reverse_fused"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the transfer path")
    if device_launches != launches:
        raise AssertionError("a chain launched other than one device kernel")

    for dt, (vid, _) in outs.items():
        check_video(f"transfer {dt}", vid, (BATCH, 16, 3, img, img))
    check_video("landscape sample float32", sampled[0], (BATCH, 16, 3, img, img))
    model = models["float32"]
    flow, packed = model.flow, model.flow.flow.packed
    with torch.no_grad():
        _, mu, _ = model.encoder(q[:, 1:].permute(0, 2, 1, 3, 4))
        nu_plain, _ = fk.flow_forward_fused_ref(packed, mu, flow.embed([q[:, 0]]))
        emb = flow.embed([x0])
        z_plain = fk.flow_reverse_fused_ref(packed, nu_plain.repeat(BATCH, 1), emb)
        z_sample_plain = fk.flow_reverse_fused_ref(packed, residual, emb)
        z_back = model.transfer_sample(q, q[:, 0])[1]
    check("transfer z_ref_vs_plain", outs["float32"][1], z_plain, TOL["bf16"])
    check("transfer z_ref_same_across_dtypes", outs["bfloat16"][1], outs["float32"][1], 0.0)
    check("transfer query_motion_roundtrip", z_back, mu, 1e-2)
    check("landscape sample z_vs_plain", sampled[1], z_sample_plain, TOL["bf16"])
    return models, q, x0, launches, device_launches


def seeded_imread(path: str):
    """A BAIR-like 64x64 frame drawn from a seed: a noise background fixed per
    clip and an 8x8 square that moves one step per frame, both from the crc32
    of the clip's ``traj_<k>/<n>`` (not of the temporary root, so every run
    sees the same data); the frame number is the file's stem. No image codec
    is needed."""
    import zlib

    import numpy as np

    *_, traj, clip, name = path.split("/")
    rng = np.random.default_rng(zlib.crc32(f"{traj}/{clip}".encode()))
    frame = rng.integers(0, 60, (BAIR_PX, BAIR_PX, 3), dtype=np.uint8)
    y0, x0 = rng.integers(0, BAIR_PX - 8, 2)
    dy, dx = rng.integers(-1, 2, 2)
    k = int(name.split(".")[0])
    y = int(np.clip(y0 + k * dy, 0, BAIR_PX - 8))
    x = int(np.clip(x0 + k * dx, 0, BAIR_PX - 8))
    frame[y:y + 8, x:x + 8] = rng.integers(120, 256, 3, dtype=np.uint8)
    return frame


def bair_split(root: Path, n_clips: int, mode: str = "test", first_traj: int = 0) -> str:
    """``<root>/<mode>/traj_<k>/<n>/``: the clip directories of a BAIR split,
    ten to a trajectory from ``traj_<first_traj>`` (the frames come from
    ``seeded_imread``, packed into a FrameStore; splits that must differ
    start at different trajectories)."""
    for i in range(n_clips):
        (root / mode / f"traj_{first_traj + i // 10}" / str(i % 10)).mkdir(parents=True)
    return str(root) + "/"


def random_backbone(module, seed: int):
    """Full-size backbone weights from a seed: each conv kernel N(0, 2/fan_in)
    (activations stay of order one through the depth; the modules' own init
    shrinks them about 6x a layer), biases zero, frozen BN the identity;
    LPIPS's 1x1 heads non-negative, as trained ones are."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() < 3:
                p.zero_()
                continue
            w = torch.randn(p.shape, generator=g) * math.sqrt(2.0 / p[0].numel())
            p.copy_(w.abs() if name.startswith("lin") else w)
    return module


def write_backbones(models_dir: Path) -> None:
    """Random full-size I3D (kinetics, DT-16), Inception and LPIPS weights,
    written with the port's ``save`` where ``load_model``, ``load_inception``
    and ``load_lpips`` look for them."""
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid, fvd, lpips_eval
    from image2video_synthesis_using_cinns_tpu_torch.metrics.inception import InceptionV3FID
    from image2video_synthesis_using_cinns_tpu_torch.models.backbones.lpips import LPIPS
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert

    for rel, module, seed in ((fvd.WEIGHT_FILES["kinetics"], fvd.build("kinetics"), 11),
                              (fvd.WEIGHT_FILES["dt16"], fvd.build("dt16"), 12),
                              (fid.WEIGHT_FILE, InceptionV3FID(), 13),
                              (lpips_eval.WEIGHT_FILE, LPIPS(), 14)):
        path = models_dir / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        variables = convert.to_variables(random_backbone(module, seed).state_dict())
        checkpoint.save(str(path), {"state_dict": variables})


def check_rel(key: str, a, b, tol: float) -> float:
    """max |a - b| over max |b|, held to ``tol``."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    rel = float((a - b).abs().max()) / scale
    ok = rel <= tol and bool(torch.isfinite(a).all()) and scale > 0
    log(f"  {key}: max|b|={scale:.4g} rel_err={rel:.3e} (bound {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}: disagrees beyond tolerance")
    return rel


def self_distance(key: str, acts) -> float:
    """The Fréchet distance of a set of activation rows to itself, held to
    |d| <= 2e-6 D + 1e-6 tr(Sigma): the 1e-6 offset on both covariances alone
    gives -2e-6 D, and float64 eigendecompositions of a covariance of rank
    below D leave about 1e-7 tr(Sigma)."""
    import numpy as np

    from image2video_synthesis_using_cinns_tpu_torch.metrics.frechet import (
        frechet_from_activations,
    )

    d = frechet_from_activations(acts, acts)
    tr = float(np.trace(np.cov(np.asarray(acts, np.float64), rowvar=False)))
    bound = 2e-6 * acts.shape[1] + 1e-6 * tr
    ok = abs(d) <= bound
    log(f"  {key}(x, x) over {acts.shape[0]} rows of {acts.shape[1]}: {d:.6g} "
        f"(bound {bound:.4g}, tr Sigma {tr:.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}(x, x) is not ~0")
    return d


def eval_window(label: str, run, expected_chains: int):
    """Run ``run()`` with the launch counts zeroed just before and read just
    after: one reverse chain per ``Model.forward``, one device kernel per
    chain, no forward chain."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    results = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  {label} chain launches: {launches}; device kernels they launched: {device_launches}")
    want = {"flow_reverse_fused": expected_chains, "flow_forward_fused": 0}
    if launches != want:
        raise AssertionError(f"{label}: chain launches {launches}, expected {want}")
    if device_launches != launches:
        raise AssertionError(f"{label}: a chain launched other than one device kernel")
    return results, wall, launches, device_launches


def phase_eval(card: str, models, tmp: Path):
    """Offline evaluation at the full BAIR preset: both eval CLI bodies with
    the port's loader, augment, FrameStore and full-size random backbones,
    each in its own counted window; then the checks and the stage times."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.cli import eval_diversity, eval_synthesis_quality
    from image2video_synthesis_using_cinns_tpu_torch.data import get_eval_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid, fvd, lpips_eval
    from image2video_synthesis_using_cinns_tpu_torch.metrics import streaming_eval as se
    from image2video_synthesis_using_cinns_tpu_torch.metrics.frechet import (
        frechet_from_activations,
    )

    t0 = time.perf_counter()
    models_dir = tmp / "models"
    write_backbones(models_dir)
    loaders = {}
    for name, n_clips, frames, model in (("synthesis", EVAL_CLIPS, EVAL_SEQ + 1, models["float32"]),
                                          ("diversity", DIVERSITY_CLIPS, EVAL_SEQ,
                                           models["bfloat16"])):
        model.vid_length = EVAL_SEQ
        dataset = get_eval_loader("bair", frames, bair_split(tmp / name, n_clips), model.config)
        store = FrameStore.build(dataset, str(tmp / f"{name}.fst"), imread=seeded_imread)
        loaders[name] = Loader(dataset, BATCH, shuffle=False, drop_last=False, workers=8,
                               framestore=store)
    log(f"  set-up {time.perf_counter() - t0:.2f} s: backbone weights written to {models_dir}, "
        f"two BAIR test splits packed ({EVAL_CLIPS} and {DIVERSITY_CLIPS} clips of "
        f"{BAIR_FRAMES} {BAIR_PX}x{BAIR_PX} frames); framestore backend: "
        f"{loaders['synthesis'].framestore.backend}")
    root = str(models_dir)

    # -- synthesis quality: fp32 decoder (the CLI's default) ----------------
    stream = se.SynthesisQualityStream(want_fid=True, want_lpips=True, want_fvd=True,
                                       want_dtfvd=True, seq_length=EVAL_SEQ, weights_root=root,
                                       device=DEVICE)
    clips = []
    add_batch = stream.add_batch

    def keep(fake, real):  # the clips, for the batching check after the window
        clips.append((fake.clone(), real.clone()))
        add_batch(fake, real)

    stream.add_batch = keep
    model = models["float32"]
    synth, s_wall, s_launches, s_dev = eval_window(
        "synthesis", lambda: eval_synthesis_quality.evaluate(model, loaders["synthesis"], stream,
                                                             "bair"),
        -(-EVAL_CLIPS // BATCH))
    log(f"  [{card}] eval_synthesis_quality body, bair bs={BATCH} seq_length={EVAL_SEQ} fp32 "
        f"decoder, FID+LPIPS+FVD+DTFVD over {EVAL_CLIPS} clips: {s_wall:.3f} s, "
        f"{EVAL_CLIPS / s_wall:.2f} clips/s; {synth}")

    # -- diversity: bf16 decoder ---------------------------------------------
    dstream = se.DiversityStream(N_REALIZ, want_vgg=True, want_i3d=True, want_dti3d=True,
                                 seq_length=EVAL_SEQ, weights_root=root, device=DEVICE)
    div, d_wall, d_launches, d_dev = eval_window(
        "diversity", lambda: eval_diversity.evaluate(models["bfloat16"], loaders["diversity"],
                                                     dstream, N_REALIZ),
        -(-DIVERSITY_CLIPS // BATCH) * N_REALIZ)
    log(f"  [{card}] eval_diversity body, bair bs={BATCH} n_realiz={N_REALIZ} "
        f"seq_length={EVAL_SEQ} bf16 decoder, VGG+I3D+DTI3D over {DIVERSITY_CLIPS} clips: "
        f"{d_wall:.3f} s, {DIVERSITY_CLIPS / d_wall:.2f} clips/s; {div}")

    # -- checks ----------------------------------------------------------------
    for name, v in {**synth, **div}.items():
        if not np.isfinite(v):
            raise AssertionError(f"{name} is not finite: {v}")
    log(f"  every metric finite: {sorted({**synth, **div})}")
    for name in ("FID", "FVD", "DTFVD"):
        real = stream.activations(name)[1]
        n = real.shape[0]  # the stream's populations
        keep_n = {"FID": se._tail_drop(n, 50), "FVD": n // 16 * 16,
                  "DTFVD": se._tail_drop(n, 40)}[name]
        self_distance(name, real[:keep_n])
    fake_all = torch.cat([f for f, _ in clips])
    real_all = torch.cat([r for _, r in clips])
    with torch.inference_mode():
        same = stream.lpips(real_all[0], real_all[0])
    log(f"  LPIPS(x, x) over {same.numel()} frames: max {float(same.abs().max())}")
    if float(same.abs().max()) != 0.0:
        raise AssertionError("LPIPS(x, x) is not 0")

    # the same backbones on the card and on the CPU
    i3d = {k: (fvd.load_model(k, root, DEVICE), fvd.load_model(k, root, "cpu"))
           for k in ("kinetics", "dt16")}
    clip = real_all[:1]
    for kind, (card_m, cpu_m) in i3d.items():
        x = clip if kind == "kinetics" else fvd.prep_dt_time(clip, 16)
        check_rel(f"I3D {kind} card vs CPU, 1 clip", fvd.activation_fn(card_m)(x),
                  fvd.activation_fn(cpu_m)(x.cpu()), BACKBONE_TOL)
    frames, other = real_all[0, :4], fake_all[0, :4]
    inc_cpu = fid.load_inception(root, "cpu")
    lp_cpu = lpips_eval.load_lpips(root, "cpu")
    vgg_cpu = se.vgg_features("cpu")
    x224 = torch.nn.functional.interpolate(frames, size=(224, 224), mode="bilinear",
                                           antialias=True)
    with torch.inference_mode():
        check_rel("Inception card vs CPU, 4 frames", stream.inception(frames),
                  inc_cpu(frames.cpu()), BACKBONE_TOL)
        check_rel("LPIPS card vs CPU, 4 frame pairs", stream.lpips(other, frames),
                  lp_cpu(other.cpu(), frames.cpu()), BACKBONE_TOL)
        for lvl, (a, b) in enumerate(zip(dstream.vgg(x224), vgg_cpu(x224.cpu()))):
            check_rel(f"VGG relu{lvl + 1} tap card vs CPU, 4 frames", a, b, BACKBONE_TOL)

    # batching: the stream's values against activations taken at another batch
    # size, 10 clips (so every clip is scored: EVAL_CLIPS is a multiple of 10)
    kin, n = i3d["kinetics"][0], fake_all.shape[0]
    if n % 10:
        raise ValueError(f"the batching check needs a multiple of 10 clips, not {n}")
    acts = {
        "FVD": [fvd.get_activations(kin, v, 10)[:n // 16 * 16] for v in (fake_all, real_all)],
        "DTFVD": [fvd.get_activations(i3d["dt16"][0], fvd.prep_dt_time(v, 16), 10)
                  [:se._tail_drop(n, 40)] for v in (fake_all, real_all)],
        "FID": [fid.get_activations(stream.inception, v.flatten(0, 1), 50)
                for v in (fake_all, real_all)],
    }
    for name, (a1, a2) in acts.items():
        redo = frechet_from_activations(a1, a2)
        rel = abs(redo - synth[name]) / abs(synth[name])
        log(f"  {name} from the stream (batches of {BATCH} clips) {synth[name]:.10g}, from "
            f"activations at batch size {50 if name == 'FID' else 10} {redo:.10g}: rel "
            f"{rel:.3e} (bound {BATCHING_TOL:g}) {'ok' if rel <= BATCHING_TOL else 'FAIL'}")
        if rel > BATCHING_TOL:
            raise AssertionError(f"{name} depends on the batch size")

    # -- stage times, each alone ---------------------------------------------
    augment = build_augment(BAIR_PX, None, False, False)
    t0 = time.perf_counter()
    n_batches = 0
    for batch in loaders["synthesis"].epoch_iter(0):
        augment(torch.from_numpy(batch["seq_raw"]).to(DEVICE))
        n_batches += 1
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    x0 = real_all[:BATCH, 0].contiguous()
    fake6, real6 = fake_all[:BATCH].contiguous(), real_all[:BATCH].contiguous()
    ff, rf = fake6.flatten(0, 1), real6.flatten(0, 1)
    video = torch.stack([fake6[0]] * N_REALIZ) * 0.5 + 0.5
    with torch.inference_mode():
        fwd = {dt: cuda_ms(lambda m=m: m.forward(x0), iters=3, reps=3)
               for dt, m in models.items()}
        i3d_ms = {k: cuda_ms(lambda f=fvd.activation_fn(m[0]), k=k: f(
            fake6 if k == "kinetics" else fvd.prep_dt_time(fake6, 16)), iters=2, reps=3) / BATCH
            for k, m in i3d.items()}
        inc_ms = cuda_ms(lambda: stream.inception(ff), iters=2, reps=3) / ff.shape[0]
        lp_ms = cuda_ms(lambda: stream.lpips(ff, rf), iters=2, reps=3) / ff.shape[0]
        vgg_ms = cuda_ms(lambda: dstream._vgg_pairs(video), iters=2, reps=3) / (N_REALIZ * EVAL_SEQ)
    log(f"  [{card}] eval stages, each alone: loader + augment {load_ms:.3f} ms per batch of "
        f"{BATCH} ({EVAL_SEQ + 1} frames, {loaders['synthesis'].framestore.backend} framestore); "
        f"Model.forward bs={BATCH} T={EVAL_SEQ} fp32 {fwd['float32']:.3f} ms, bf16 "
        f"{fwd['bfloat16']:.3f} ms; I3D kinetics {i3d_ms['kinetics']:.3f} ms per clip, DT-16 "
        f"{i3d_ms['dt16']:.3f} ms per clip (16 frames at 224, batches of {BATCH}); Inception "
        f"{inc_ms:.3f} ms per frame (299 px, batches of {ff.shape[0]}); LPIPS {lp_ms:.3f} ms per "
        f"frame pair (64 px); VGG diversity {vgg_ms:.3f} ms per frame (224 px, with its pairs, "
        f"{N_REALIZ * EVAL_SEQ} frames a video)")
    for loader in loaders.values():
        loader.framestore.close()
    t0 = time.perf_counter()
    stream.results()
    s_res = time.perf_counter() - t0
    t0 = time.perf_counter()
    dstream.results()
    log(f"  [{card}] results() on the host, each alone: synthesis (float64 Fréchet: FID 2048-d, "
        f"DTFVD 1024-d, FVD 400-d) {s_res * 1e3:.1f} ms, diversity "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    stream.add_batch = add_batch

    def synthesis_step():
        """One batch of the synthesis body after loading: sample, the BAIR
        frame protocol, all four backbones (its rows join the spent stream)."""
        gen = model(x0)
        stream.add_batch(torch.cat((real6[:, :1], gen[:, :-1]), dim=1), real6)

    launches = {"flow_reverse_fused": s_launches["flow_reverse_fused"]
                + d_launches["flow_reverse_fused"], "flow_forward_fused": 0}
    device_launches = {"flow_reverse_fused": s_dev["flow_reverse_fused"]
                       + d_dev["flow_reverse_fused"], "flow_forward_fused": 0}
    return launches, device_launches, synthesis_step


def first_batch(loader, epoch: int = 0) -> dict:
    it = loader.epoch_iter(epoch)
    try:
        return next(it)
    finally:
        it.close()


def phase_train(card: str, tmp: Path, weights_root: str):
    """Stage-2 training at the full BAIR preset: the trainer's ``train`` over
    synthetic splits packed into FrameStores, random full-size models, the
    prior FVD with the I3D under ``weights_root``, checkpoints in ``tmp``, in
    its own counted window (one forward chain per validation batch and one
    reverse chain per prior-FVD batch, each one device kernel); then its
    checks, its timings, and the step it traces."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.config import Config
    from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.data.registry import augment_params
    from image2video_synthesis_using_cinns_tpu_torch.losses.flow_loss import flow_loss
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.inn import SupervisedTransformer
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import configs
    from image2video_synthesis_using_cinns_tpu_torch.train import optim, stage2
    from image2video_synthesis_using_cinns_tpu_torch.train.fvd_eval import evaluate_FVD_prior
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert

    t0 = time.perf_counter()
    opt, config1, ae = configs(PRESET)
    root = tmp / "bair_train"
    bair_split(root, TRAIN_CLIPS, "train")
    bair_split(root, TRAIN_EVAL_CLIPS, "eval", first_traj=20)
    opt.Training = Config(dict(TRAIN_CONFIG, save_path=str(tmp / "runs")))
    opt.Data = Config(dict(TRAIN_DATA, data_path=str(root) + "/"))
    opt.Logging = Config({"mode": "disabled"})
    tr = opt.Training
    loaders = {}
    for mode, bs, seed in (("train", tr["bs"], 42), ("eval", tr["bs_eval"], 43)):
        ds = get_loader("BAIR")(opt, mode)
        store = FrameStore.build(ds, str(tmp / f"train_{mode}.fst"), imread=seeded_imread)
        loaders[mode] = Loader(ds, bs, workers=TRAIN_WORKERS, drop_last=False, seed=seed,
                               framestore=store)
    models = stage2.build_models_from_configs(opt, config1, ae, seed=0)
    n_eval = len(loaders["eval"])
    log(f"  set-up {time.perf_counter() - t0:.2f} s: BAIR train and eval splits of {TRAIN_CLIPS} "
        f"and {TRAIN_EVAL_CLIPS} clips packed, full-size random models built")

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = stage2.train(opt, models, loaders["train"], loaders["eval"], device=DEVICE,
                       weights_root=weights_root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  training chain launches: {launches}; device kernels they launched: {device_launches}")
    want = {"flow_reverse_fused": TRAIN_EPOCHS * n_eval, "flow_forward_fused": TRAIN_EPOCHS * n_eval}
    if launches != want:
        raise AssertionError(f"training: chain launches {launches}, expected {want}")
    if device_launches != launches:
        raise AssertionError("training: a chain launched other than one device kernel")
    log(f"  [{card}] stage2.train bair bs={tr['bs']} bs_eval={tr['bs_eval']}, {TRAIN_EPOCHS} "
        f"epochs of {len(loaders['train'])} steps with the ActNorm init, validation, prior FVD "
        f"and checkpoints: {wall:.3f} s; {out['global_step']} steps; train {out['train_loss']}, "
        f"eval {out['eval_loss']}, PFVD {out['PFVD']}")
    values = [*out["train_loss"], *out["eval_loss"], out["PFVD"]]
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"training: a loss or the prior FVD is not finite: {values}")
    log("  every loss and the prior FVD finite")

    # -- checks on the trained flow ----------------------------------------------
    network, encoder, decoder = models.network, models.encoder, models.decoder
    img, z = opt.Data["img_size"], config1.Decoder["z_dim"]
    params_aug, random_crop, _ = augment_params(opt, "train")
    aug = build_augment(img, params_aug, random_crop, True)
    aug_eval = build_augment(img, params_aug, random_crop, False)
    draws = stage2.Draws(7)
    raw = torch.from_numpy(first_batch(loaders["train"])["seq_raw"]).to(DEVICE)
    n = raw.shape[0]
    aug_draws = draws.augment(0, 0, 0, n, params_aug, random_crop)
    seq = aug(raw, draws=aug_draws)
    cond = stage2.conditioning(seq, None)
    eps = draws.normal("posterior", 0, 0, 0, (n, z))
    ref = draws.normal("reference", 0, 0, 0, (n, z))

    def step_terms(net, enc, s, e, r, dt):
        """The step's posterior, embedding, loss terms and flow gradients in
        ``dt`` (host copies)."""
        net, enc = copy.deepcopy(net).to(s.device, dt), copy.deepcopy(enc).to(s.device, dt)
        s = s.to(dt)
        with torch.no_grad():
            post = enc(s[:, 1:].permute(0, 4, 1, 2, 3), noise=e.to(s.device, dt))[0]
            emb = net.embed(stage2.conditioning(s, None))
        gauss, logdet = net.flow.plain(post.reshape(s.shape[0], -1), emb)
        loss, aux = flow_loss(gauss, logdet, noise=r)
        grads = torch.autograd.grad(loss, list(net.flow.parameters()))
        return {"posterior": post.cpu(), "embedding": emb.cpu(),
                "terms": {k: float(v) for k, v in aux.items()}, "grads": [g.cpu() for g in grads]}

    def versus(a, b) -> dict:
        """Card against CPU: the posterior and the embedding over their largest
        magnitude, the loss over the scale of its two terms (it is their
        difference), the flow's gradients over their largest magnitude."""
        def over_largest(x, y):
            return float((x.double() - y.double()).abs().max() / y.double().abs().max())
        t = b["terms"]
        scale = max(float(g.abs().max()) for g in b["grads"])
        return {"posterior": over_largest(a["posterior"], b["posterior"]),
                "embedding": over_largest(a["embedding"], b["embedding"]),
                "loss": abs(a["terms"]["Loss"] - t["Loss"])
                / (abs(t["nll_loss"]) + abs(t["nlogdet_loss"])),
                "grads": max(float((x.double() - y.double()).abs().max())
                             for x, y in zip(a["grads"], b["grads"])) / scale}

    b = GRAD_CHECK_BATCH
    s_card, s_cpu = seq[:b], seq[:b].cpu()
    runs = {(dev, dt): step_terms(network, encoder, s, eps[:b], ref[:b], dt)
            for dev, s in (("card", s_card), ("cpu", s_cpu))
            for dt in (torch.float32, torch.float64)}
    reference = runs["cpu", torch.float64]
    f32 = versus(runs["card", torch.float32], runs["cpu", torch.float32])
    f64 = versus(runs["card", torch.float64], reference)
    card_err = versus(runs["card", torch.float32], reference)
    cpu_err = versus(runs["cpu", torch.float32], reference)
    del runs
    for key in ("posterior", "embedding", "loss"):
        ok = card_err[key] <= FP32_RATIO * max(cpu_err[key], FP32_FLOOR)
        log(f"  card vs CPU, one step at bs={b} (the same batch and eps; TF32 off), fp32 {key}: "
            f"{f32[key]:.3e}; against the CPU's fp64 step the card's {card_err[key]:.3e}, the "
            f"CPU's {cpu_err[key]:.3e} (bound {FP32_RATIO:g} x max(CPU's, {FP32_FLOOR:g})) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"training: the card's fp32 {key} is further from fp64 than "
                                 "the CPU's")
    ok64 = f64["loss"] <= F64_LOSS_TOL and f64["grads"] <= F64_GRAD_TOL
    log(f"  card vs CPU, the same step in fp64: loss {f64['loss']:.3e} (bound {F64_LOSS_TOL:g}), "
        f"the flow's {len(reference['grads'])} gradients {f64['grads']:.3e} (bound "
        f"{F64_GRAD_TOL:g}) {'ok' if ok64 else 'FAIL'}")
    log(f"  fp32 gradients, over their largest (not bounded: LeakyReLU kinks): card vs CPU "
        f"{f32['grads']:.3e}; against the CPU's fp64 step the card's {card_err['grads']:.3e}, "
        f"the CPU's {cpu_err['grads']:.3e}")
    if not ok64:
        raise AssertionError("training: the card's fp64 step disagrees with the CPU's")

    eb = first_batch(loaders["eval"])
    eseq = aug_eval(torch.from_numpy(eb["seq_raw"]).to(DEVICE))
    econd = stage2.conditioning(eseq, None)
    ne = eseq.shape[0]
    e_eps = draws.normal("eval_posterior", 0, 0, 0, (ne, z))
    e_ref = draws.normal("eval_reference", 0, 0, 0, (ne, z))
    with torch.no_grad():
        kern = stage2.eval_step(network, encoder, eseq, econd, e_eps, e_ref)
        post = stage2.posterior(encoder, eseq, e_eps)
        emb = network.embed(econd)
        nu, logdet = network.flow.plain(post, emb)
        plain = flow_loss(nu, logdet, noise=e_ref)[1]
        back = network.flow.fused(nu, emb, reverse=True)
    term_scale = abs(float(plain["nll_loss"])) + abs(float(plain["nlogdet_loss"]))
    worst = max(abs(float(kern[k]) - float(plain[k])) / term_scale
                for k in ("Loss", "nll_loss", "nlogdet_loss"))
    log(f"  validation NLL of {ne} clips through flow_forward_fused (fp32 pack) "
        f"{float(kern['Loss']):.6g} against the plain flow's {float(plain['Loss']):.6g}: worst "
        f"term over the scale of the two terms {worst:.3e} (bound {KERNEL_NLL_TOL:g}) "
        f"{'ok' if worst <= KERNEL_NLL_TOL else 'FAIL'}")
    if worst > KERNEL_NLL_TOL:
        raise AssertionError("training: the forward kernel's NLL disagrees with the plain flow's")
    check("train: flow_reverse_fused maps the trained flow's nu back to the posterior", back, post,
          INVERSE_TOL)

    run = Path(out["save_path"])
    ckpts = {name: checkpoint.load(str(run / f"{name}.msgpack")) for name in ("cINN_latest", "cINN")}
    for name, payload in ckpts.items():
        fresh = SupervisedTransformer.from_configs(opt, config1.Decoder, ae)
        fresh.load_state_dict(convert.to_state_dict(payload["state_dict"]))
        with torch.no_grad():
            nu_fresh = fresh.to(DEVICE).flow.plain(post, emb)[0]
        if name == "cINN_latest" or payload["epoch"] == ckpts["cINN_latest"]["epoch"]:
            check(f"train: {name}.msgpack (epoch {payload['epoch']}) reloaded gives the same nu",
                  nu_fresh, nu, 0.0)
        elif not bool(torch.isfinite(nu_fresh).all()):
            raise AssertionError(f"training: {name}.msgpack gives a non-finite nu")
        else:
            log(f"  {name}.msgpack (epoch {payload['epoch']}, the best) reloads, nu finite")
    del ckpts

    net10 = copy.deepcopy(network)
    opt10 = optim.adam_torch(list(net10.flow.parameters()), tr["lr"],
                             betas=(tr["beta1"], tr["beta2"]), weight_decay=tr["weight_decay"],
                             amsgrad=bool(tr["amsgrad"]))

    def batch_nll() -> float:
        with torch.no_grad():
            p = stage2.posterior(encoder, seq, eps)
            return float(flow_loss(*net10.flow.plain(p, net10.embed(cond)), noise=ref)[0])

    before = batch_nll()
    for _ in range(10):
        stage2.train_step(net10, opt10, encoder, seq, cond, eps, ref)
    after = batch_nll()
    log(f"  10 steps on one batch of {n}: its NLL {before:.6g} -> {after:.6g} "
        f"{'ok' if after < before else 'FAIL'}")
    if not after < before:
        raise AssertionError("training: 10 steps on one batch did not lower its NLL")

    # -- timings -------------------------------------------------------------------
    enc16 = copy.deepcopy(encoder).to(torch.bfloat16)

    def step(enc):
        s = aug(raw, draws=aug_draws)
        stage2.train_step(net10, opt10, enc, s, stage2.conditioning(s, None), eps, ref)

    step_ms = {}
    for dt, enc in (("float32", encoder), ("bfloat16", enc16)):
        for _ in range(2):
            step(enc)
        torch.cuda.synchronize()
        lat = []
        for _ in range(7):
            t0 = time.perf_counter()
            step(enc)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        step_ms[dt] = statistics.median(lat) * 1e3
        log(f"  [{card}] training step bs={n} compute_dtype={dt} (augment, encoder posterior, "
            f"embedder, flow forward and backward, Adam): {step_ms[dt]:.3f} ms, "
            f"{n / step_ms[dt] * 1e3:.1f} clips/s (median of 7 after 2 warm-ups)")
    emb50 = net10.embed(cond)
    post50 = stage2.posterior(encoder, seq, eps)

    def flow_fwd_bwd():
        gauss, logdet = net10.flow.plain(post50, emb50)
        opt10.zero_grad(set_to_none=True)
        flow_loss(gauss, logdet, noise=ref)[0].backward()

    stages = {
        "augment": cuda_ms(lambda: aug(raw, draws=aug_draws), iters=5, reps=5),
        "encoder posterior fp32": cuda_ms(lambda: stage2.posterior(encoder, seq, eps), 3, 5),
        "encoder posterior bf16": cuda_ms(lambda: stage2.posterior(enc16, seq, eps), 3, 5),
        "embedder": cuda_ms(lambda: net10.embed(cond), iters=3, reps=5),
        "flow forward + backward": cuda_ms(flow_fwd_bwd, iters=3, reps=5),
    }
    flow_fwd_bwd()
    stages["optimizer update"] = cuda_ms(opt10.step, iters=5, reps=5)
    log(f"  [{card}] training stages at bs={n}, each alone (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    t0 = time.perf_counter()  # the trainer's validation pass
    auxs = []
    for i, batch in enumerate(loaders["eval"].epoch_iter(0)):
        s = aug_eval(torch.from_numpy(batch["seq_raw"]).to(DEVICE))
        m = s.shape[0]
        auxs.append(stage2.eval_step(network, encoder, s, stage2.conditioning(s, None),
                                     draws.normal("eval_posterior", 0, i, 0, (m, z)),
                                     draws.normal("eval_reference", 0, i, 0, (m, z))))
    val_loss = np.mean([float(aux["Loss"]) for aux in auxs])
    val_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate_FVD_prior(loaders["eval"], aug_eval, network, decoder, z, opt, 0,
                       weights_root=weights_root,
                       residual=lambda i, shape: draws.prior(0, i, shape),
                       on_dump_error=lambda e: None)  # no imageio on the card's machine
    torch.cuda.synchronize()
    fvd_s = time.perf_counter() - t0
    log(f"  [{card}] validation pass ({n_eval} batches of {tr['bs_eval']}, forward kernel, "
        f"loss {val_loss:.6g}) {val_s * 1e3:.1f} ms; prior FVD ({n_eval} batches: reverse kernel, fp32 decoder, I3D, "
        f"Fréchet) {fvd_s * 1e3:.1f} ms")
    rows = {}
    p = network.flow.packed  # fp32 weights, the training path's mode
    with torch.no_grad():
        rows["flow_forward_fused"] = kernel_row(card, "training", "flow_forward_fused", p, post, emb)
        rows["flow_reverse_fused"] = kernel_row(card, "training", "flow_reverse_fused", p, nu, emb)
    for loader in loaders.values():
        loader.framestore.close()
    def traced_step():  # phase_trace runs its calls under no_grad; a step needs autograd
        with torch.enable_grad():
            step(encoder)

    return launches, device_launches, traced_step, rows


def s1_config(tmp: Path, data_path: str):
    from image2video_synthesis_using_cinns_tpu_torch.config import Config

    return Config(dict(S1_MODELS, Training=dict(S1_TRAINING, save_path=str(tmp / "runs_s1")),
                       Data=dict(S1_DATA, data_path=data_path), Logging={"mode": "disabled"}))


def s1_step(models, tr, seq, draws, epoch: int, device, dtype):
    """One stage-1 step (both phases, both refreshes) on copies of ``models``
    in ``dtype`` on ``device`` with fresh optimizers: the metrics and each
    optimizer's gradients as it applied them (host copies)."""
    import copy

    import torch

    from image2video_synthesis_using_cinns_tpu_torch.train import stage1_step

    m = copy.deepcopy(models)
    for module in (m.decoder, m.encoder, m.disc_t, m.disc_s, m.lpips):
        module.to(device, dtype)
    optimizers = stage1_step.make_optimizers(m, tr["lr"], tr["weight_decay"])
    grads = {}
    for name, o in zip(("AE", "DISC_t", "DISC_s"), optimizers):
        def step(o=o, name=name, apply=o.step):
            grads[name] = [p.grad.detach().cpu() for p in o.param_groups[0]["params"]]
            apply()
        o.step = step
    d = stage1_step.StepDraws(draws.eps.to(dtype), draws.start, draws.patches)
    metrics, _ = stage1_step.Stage1Step(m, optimizers, tr)(seq.to(device, dtype), epoch, d)
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_train_stage1(card: str, tmp: Path, weights_root: str):
    """Stage-1 training at the full BAIR preset: the trainer's ``train`` over
    synthetic splits packed into FrameStores, random full-size networks, LPIPS
    and the posterior FVD's I3D from ``weights_root``, checkpoints in ``tmp``,
    in its own counted window (no flow chain on this path); then its checks,
    its timings, and the step it traces."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.data.registry import augment_params
    from image2video_synthesis_using_cinns_tpu_torch.models import layers
    from image2video_synthesis_using_cinns_tpu_torch.models.stage1.decoder import Generator
    from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Encoder
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1, stage1_step
    from image2video_synthesis_using_cinns_tpu_torch.train.fvd_eval import evaluate_FVD_posterior
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert

    t0 = time.perf_counter()
    root = tmp / "bair_train_s1"
    bair_split(root, S1_CLIPS, "train", first_traj=40)
    bair_split(root, S1_CLIPS, "eval", first_traj=60)
    opt = s1_config(tmp, str(root) + "/")
    tr = opt.Training
    loaders = {}
    for mode, bs, seed in (("train", tr["bs"], 42), ("eval", tr["bs_eval"], 43)):
        ds = get_loader("BAIR")(opt, mode)
        store = FrameStore.build(ds, str(tmp / f"s1_{mode}.fst"), imread=seeded_imread)
        loaders[mode] = Loader(ds, bs, workers=tr["workers"], seed=seed, framestore=store)
    models = stage1.build_models(opt, seed=0, weights_root=weights_root)
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in stage1.networks(models).items()}
    log(f"  set-up {time.perf_counter() - t0:.2f} s: BAIR train and eval splits of {S1_CLIPS} "
        f"clips packed, full-size random networks built (parameters: {n_params}), LPIPS from "
        f"{weights_root}")

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = stage1.train(opt, models, loaders["train"], loaders["eval"], device=DEVICE,
                       weights_root=weights_root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  stage-1 training chain launches: {launches}; device kernels: {device_launches}")
    if any(launches.values()) or any(device_launches.values()):
        raise AssertionError("stage-1 training launched a flow chain; its path has none")
    n_steps = len(loaders["train"])
    log(f"  [{card}] stage1.train bair bs={tr['bs']} bs_eval={tr['bs_eval']}, {S1_EPOCHS} epochs "
        f"of {n_steps} steps (epoch 0 gated) with the ActNorm init, validation, posterior FVD "
        f"and checkpoints: {wall:.3f} s; {out['global_step']} steps; train {out['train_metrics']}, "
        f"eval {out['eval_metrics']}, PFVD {out['PFVD']}")
    values = [*out["train_metrics"].values(), *out["eval_metrics"].values(), out["PFVD"]]
    if out["global_step"] != S1_EPOCHS * n_steps or not all(np.isfinite(v) for v in values):
        raise AssertionError(f"stage-1 training: a step is missing or a value is not finite: "
                             f"{out}")
    log("  every loss, PSNR, SSIM and the posterior FVD finite")

    # -- the batch and draws of the checks -----------------------------------------
    img, z = opt.Data["img_size"], opt.Decoder["z_dim"]
    params_aug, random_crop, _ = augment_params(opt, "train")
    aug = build_augment(img, params_aug, random_crop, True)
    aug_eval = build_augment(img, params_aug, random_crop, False)
    draws = stage1.Draws()
    raw = torch.from_numpy(first_batch(loaders["train"])["seq_raw"]).to(DEVICE)
    n = raw.shape[0]
    seq = aug(raw, draws=draws.augment(0, 0, 0, n, params_aug, random_crop))
    sub_len = int(tr["subsample_length"])
    d = draws.step(0, 0, 0, n, z, seq.shape[1] - 1, sub_len)

    # -- card against CPU: one whole step, gate open -------------------------------
    b = S1_CHECK_BATCH
    db = stage1_step.StepDraws(d.eps[:b], d.start,
                               torch.randint(0, b * (seq.shape[1] - 1), (stage1_step.N_PATCH,),
                                             generator=torch.Generator().manual_seed(5)))
    runs, secs = {}, {}
    for dev in ("card", "cpu"):
        for dt in (torch.float64, torch.float32):
            t1 = time.perf_counter()
            runs[dev, dt] = s1_step(models, tr, seq[:b], db, 1, DEVICE if dev == "card" else "cpu",
                                    dt)
            secs[dev, dt] = time.perf_counter() - t1

    def versus(a, c) -> tuple[float, float]:
        """Metrics over max(|metric|, 1); each network's gradients over its
        largest."""
        (ma, ga), (mc, gc) = a, c
        m_err = max(abs(ma[k] - mc[k]) / max(abs(mc[k]), 1.0) for k in mc)
        g_err = 0.0
        for name in gc:
            scale = max(float(g.abs().max()) for g in gc[name])
            g_err = max(g_err, max(float((x.double() - y.double()).abs().max())
                                   for x, y in zip(ga[name], gc[name])) / scale)
        return m_err, g_err

    m64, g64 = versus(runs["card", torch.float64], runs["cpu", torch.float64])
    m32, g32 = versus(runs["card", torch.float32], runs["cpu", torch.float32])
    ok = m64 <= F64_LOSS_TOL and g64 <= F64_GRAD_TOL
    log(f"  card vs CPU, one whole step at bs={b}, gate open (the same batch and draws; TF32 "
        f"off; CPU {secs['cpu', torch.float64]:.1f} s fp64, {secs['cpu', torch.float32]:.1f} s "
        f"fp32): fp64 metrics {m64:.3e} (bound {F64_LOSS_TOL:g}), the three optimizers' "
        f"gradients {g64:.3e} (bound {F64_GRAD_TOL:g}) {'ok' if ok else 'FAIL'}; fp32 (reported) "
        f"metrics {m32:.3e}, gradients {g32:.3e}")
    if not ok:
        raise AssertionError("stage-1 training: the card's fp64 step disagrees with the CPU's")
    del runs

    # -- the gate --------------------------------------------------------------------
    gm = copy.deepcopy(models)
    gopts = stage1_step.make_optimizers(gm, tr["lr"], tr["weight_decay"])
    gstep = stage1_step.Stage1Step(gm, gopts, tr)
    discs = {"DISC_t": gm.disc_t, "DISC_s": gm.disc_s}

    def snapshot():
        return {k: ([p.detach().clone() for p in m.parameters()],
                    [b.clone() for name, b in m.named_buffers() if name.endswith(".u")])
                for k, m in discs.items()}

    before = snapshot()
    gstep(seq, 0, d)
    after = snapshot()
    for k in discs:
        same = all(torch.equal(p, q) for p, q in zip(before[k][0], after[k][0]))
        u_moved = max(float((p - q).abs().max()) for p, q in zip(before[k][1], after[k][1]))
        ok = same and u_moved > 0 and gopts[1].count == gopts[2].count == 0
        log(f"  gate closed (epoch 0): {k} parameters bitwise unchanged {same}, Adam count "
            f"{gopts[1 if k == 'DISC_t' else 2].count}, spectral u moved by up to {u_moved:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"stage-1 training: the closed gate let {k} change")
    gstep(seq, 1, d)
    opened = snapshot()
    for k in discs:
        moved = max(float((p - q).abs().max()) for p, q in zip(after[k][0], opened[k][0]))
        log(f"  gate open (epoch 1): {k} parameters moved by up to {moved:.3e} "
            f"{'ok' if moved > 0 else 'FAIL'}")
        if not moved > 0:
            raise AssertionError(f"stage-1 training: the open gate left {k} unchanged")
    del gm, gopts, gstep

    # -- the ActNorm init on the first batch's 20 frames, start frames included --------
    ds = copy.deepcopy(models.disc_s)
    outputs = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: outputs.__setitem__(name, o))
             for name, m in ds.named_modules() if isinstance(m, layers.ActNormImage)]
    frames = seq.reshape((-1,) + seq.shape[2:])[:stage1_step.N_PATCH].permute(0, 3, 1, 2)
    layers.init_actnorm(ds, frames)
    for h in hooks:
        h.remove()
    worst = max(max(float(o.mean((0, 2, 3)).abs().max()),
                    float((o.std((0, 2, 3)) - 1).abs().max())) for o in outputs.values())
    log(f"  ActNorm init on {frames.shape[0]} frames: each of the {len(outputs)} ActNorms' output "
        f"per channel, worst |mean| or |std - 1| {worst:.3e} (bound {ACTNORM_TOL:g}) "
        f"{'ok' if worst <= ACTNORM_TOL else 'FAIL'}")
    if not worst <= ACTNORM_TOL or len(outputs) != 3:
        raise AssertionError("stage-1 training: the ActNorm init does not normalise")
    del ds, outputs

    # -- the hand-off to serving and the checkpoints -----------------------------------
    run = Path(out["save_path"])
    eb = first_batch(loaders["eval"])
    eseq = aug_eval(torch.from_numpy(eb["seq_raw"]).to(DEVICE))
    e_eps = draws.normal("eval_posterior", 0, 0, 0, (eseq.shape[0], z))
    _, gen_train = stage1_step.eval_step(models, eseq, e_eps)
    dec_s = convert.load_checkpoint(Generator.from_config(opt.Decoder),
                                    str(run / "latest_checkpoint_GEN.msgpack")).to(DEVICE).eval()
    enc_s = convert.load_checkpoint(Encoder.from_config(opt.Encoder),
                                    str(run / "latest_checkpoint_ENC.msgpack")).to(DEVICE).eval()
    with torch.no_grad():
        video = eseq.permute(0, 4, 1, 2, 3)
        motion = enc_s(video[:, :, 1:], noise=e_eps)[0]
        gen_serve = dec_s(video[:, :, 0], motion).permute(0, 2, 1, 3, 4)
    check_rel("train s1: the run's GEN and ENC in the folded serving modules reconstruct as the "
              "training modules", gen_serve, gen_train, SERVE_TOL)
    del dec_s, enc_s
    networks = stage1.networks(models)
    fresh = {"GEN": lambda: Generator.from_config(opt.Decoder, trainable=True),
             "ENC": lambda: Encoder.from_config(opt.Encoder, trainable=True),
             "DISC_t": lambda: type(models.disc_t).from_config(opt.Discriminator_Temporal),
             "DISC_s": lambda: type(models.disc_s).from_config(opt.Discriminator_Patch)}
    for name, key in ([(f"latest_checkpoint_{k}", k) for k in stage1.NETWORKS]
                      + [(f"best_PFVD_{k}", k) for k in ("GEN", "ENC")]):
        payload = checkpoint.load(str(run / f"{name}.msgpack"))
        module = fresh[key]()
        stage1.load_variables(module, payload["state_dict"])
        mine = networks[key].state_dict()
        if name.startswith("latest"):
            same = all(torch.equal(t, mine[k].cpu()) for k, t in module.state_dict().items())
            log(f"  {name}.msgpack (epoch {payload['epoch']}) reloads into a fresh module, equal "
                f"to the trained one {same} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"stage-1 training: {name} does not reload the run's state")
        else:
            finite = all(bool(torch.isfinite(t).all()) for t in module.state_dict().values())
            log(f"  {name}.msgpack (epoch {payload['epoch']}, the best) reloads, finite {finite}")
            if not finite:
                raise AssertionError(f"stage-1 training: {name} is not finite")
        del payload, module

    # -- learning: 10 steps with the gate closed on one batch, from the run's networks --
    def learn(lr: float) -> tuple[list[float], float]:
        """Each step's L1 of the batch (eval forward, the step's eps), before
        and after; the share of generated pixels beyond |0.99| before."""
        lm = copy.deepcopy(models)
        lstep = stage1_step.Stage1Step(lm, stage1_step.make_optimizers(lm, lr,
                                                                       tr["weight_decay"]), tr)
        metrics, gen = stage1_step.eval_step(lm, seq, d.eps)
        saturated = float((gen.abs() > 0.99).float().mean())
        l1 = [float(metrics["Loss_L1"])]
        for _ in range(10):
            lstep(seq, 0, d)
            l1.append(float(stage1_step.eval_step(lm, seq, d.eps)[0]["Loss_L1"]))
        return l1, saturated

    lr_learn = tr["lr"] * S1_LEARN_LR_SCALE
    for lr in (tr["lr"], lr_learn):
        l1, saturated = learn(lr)
        ok = l1[-1] < l1[0]
        verdict = ("ok" if ok else "FAIL") if lr == lr_learn else "reported"
        log(f"  10 steps with the gate closed at lr {lr:g} on one batch of {n} (the run's "
            f"networks, {saturated:.4f} of their generated pixels beyond |0.99|): its Loss_L1 "
            f"{l1[0]:.6g} -> {l1[-1]:.6g} {verdict}; after each step "
            + " ".join(f"{x:.5f}" for x in l1[1:]))
        if lr == lr_learn and not ok:
            raise AssertionError("stage-1 training: 10 steps on one batch did not lower its L1")

    # -- timings ------------------------------------------------------------------------
    tm = copy.deepcopy(models)
    topts = stage1_step.make_optimizers(tm, tr["lr"], tr["weight_decay"])
    step_ms, peak = {}, {}
    for dt in ("float32", "bfloat16"):
        tstep = stage1_step.Stage1Step(tm, topts, dict(tr, compute_dtype=dt))
        for _ in range(2):
            tstep(seq, 1, d)
        torch.cuda.synchronize()
        lat = []
        for _ in range(7):
            t1 = time.perf_counter()
            tstep(seq, 1, d)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        step_ms[dt] = statistics.median(lat) * 1e3
        uncollected = torch.cuda.memory_allocated() / 2**30
        gc.collect()  # earlier phases can leave cyclic garbage on the card until a collection
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        tstep(seq, 1, d)
        torch.cuda.synchronize()
        peak[dt] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  [{card}] stage-1 training step bs={n}, gate open, compute_dtype={dt} (VAE "
            f"forward, both discriminators with the GP, VAE loss and backward, three Adams, "
            f"spectral refresh): {step_ms[dt]:.3f} ms, {n / step_ms[dt] * 1e3:.1f} clips/s "
            f"(median of 7 after 2 warm-ups); peak memory {peak[dt]:.2f} GiB, of which "
            f"{peak[dt] - resident:.2f} GiB above the {resident:.2f} GiB allocated before the "
            f"step (every phase's live models and optimizer states; {uncollected:.2f} GiB before "
            f"collecting garbage)")
    tstep = stage1_step.Stage1Step(tm, topts, tr)
    with torch.no_grad():
        fwd = tstep.forward_vae(seq, d.eps)
        gen_d, orig = fwd["gen"], fwd["orig"]
    fake_t, real_t = tstep.subsample(gen_d, orig, d.start)
    fake_s, real_s = tstep.patch_frames(gen_d, orig, d.patches)
    dt_params, ds_params = list(tm.disc_t.parameters()), list(tm.disc_s.parameters())
    ae_params = [*tm.decoder.parameters(), *tm.encoder.parameters()]

    def disc_t_gp():
        total, _ = tstep.disc_t_loss(fake_t, real_t, create_graph=True)
        torch.autograd.grad(total, dt_params)

    def disc_s():
        total, _ = tstep.disc_s_loss(fake_s, real_s)
        torch.autograd.grad(total, ds_params)

    def vae_all():
        with torch.enable_grad():
            total, _ = tstep.vae_loss(tstep.forward_vae(seq, d.eps), d, 1.0)
            torch.autograd.grad(total, ae_params)

    def vae_forward_loss():
        with torch.enable_grad():
            tstep.vae_loss(tstep.forward_vae(seq, d.eps), d, 1.0)

    def optimizers():
        for o in topts:
            o.step()

    def refresh():
        for m in (tm.disc_t, tm.disc_s, tm.decoder):
            layers.power_iteration_(m)

    stages = {
        "VAE forward": cuda_ms(lambda: tstep.forward_vae(seq, d.eps), iters=3, reps=5),
        "temporal discriminator with the GP (loss and gradients)": cuda_ms(disc_t_gp, 3, 5),
        "patch discriminator (loss and gradients)": cuda_ms(disc_s, iters=3, reps=5),
        "VAE forward and loss": cuda_ms(vae_forward_loss, iters=3, reps=5),
        "VAE forward, loss and backward": cuda_ms(vae_all, iters=3, reps=5),
        "three optimizers": cuda_ms(optimizers, iters=5, reps=5),
        "spectral refresh": cuda_ms(refresh, iters=5, reps=5),
    }
    stages["VAE backward (the difference)"] = (stages["VAE forward, loss and backward"]
                                               - stages["VAE forward and loss"])
    log(f"  [{card}] stage-1 stages at bs={n}, each alone (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    del fwd, gen_d, orig, fake_t, real_t, fake_s, real_s

    t0 = time.perf_counter()  # the trainer's validation pass
    vals = []
    for i, batch in enumerate(loaders["eval"].epoch_iter(0)):
        s = aug_eval(torch.from_numpy(batch["seq_raw"]).to(DEVICE))
        vals.append(stage1_step.eval_step(models, s, draws.normal(
            "eval_posterior", 0, i, 0, (s.shape[0], z)))[0])
    val_l1 = float(np.mean([float(v["Loss_L1"]) for v in vals]))
    val_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pfvd = evaluate_FVD_posterior(loaders["eval"], aug_eval, models.decoder, models.encoder,
                                  "FVD", weights_root, noise=draws.fvd_posterior)
    torch.cuda.synchronize()
    fvd_s = time.perf_counter() - t0
    log(f"  [{card}] validation pass ({len(vals)} batches of {tr['bs_eval']}: encoder, decoder, "
        f"LPIPS, PSNR, SSIM; Loss_L1 {val_l1:.6g}) {val_s * 1e3:.1f} ms; posterior FVD "
        f"({len(vals)} batches: encoder, fp32 decoder, I3D, Fréchet; {pfvd:.6g}) "
        f"{fvd_s * 1e3:.1f} ms")
    for loader in loaders.values():
        loader.framestore.close()

    trace_step = stage1_step.Stage1Step(tm, topts, tr)

    def traced_step():  # phase_trace runs its calls under no_grad; a step needs autograd
        with torch.enable_grad():
            trace_step(seq, 1, d)

    return launches, device_launches, traced_step


def ae_config(tmp: Path, data_path: str, ae: dict = AE_MODELS["AE"],
              training: dict = AE_TRAINING, data: dict = AE_DATA):
    from image2video_synthesis_using_cinns_tpu_torch.config import Config

    return Config(dict(AE_MODELS, AE=dict(ae),
                       Training=dict(training, save_path=str(tmp / "runs_ae")),
                       Data=dict(data, data_path=data_path), Logging={"mode": "disabled"}))


def ae_step(models, tr, img, epoch: int, device, dtype):
    """One AE step (both updates, the recompute, the refresh) on copies of
    ``models`` in ``dtype`` on ``device`` with fresh optimizers: the metrics
    and each optimizer's gradients as it applied them (host copies)."""
    import copy

    from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae

    m = copy.deepcopy(models)
    for module in (m.network, m.disc, m.lpips):
        module.to(device, dtype)
    m.logvar.data = m.logvar.data.to(device, dtype)
    optimizers = stage2_ae.make_optimizers(m, tr["lr"], tr["weight_decay"])
    grads = {}
    for name, o in zip(("GEN", "DISC"), optimizers):
        def step(o=o, name=name, apply=o.step):
            grads[name] = [p.grad.detach().cpu() for p in o.param_groups[0]["params"]]
            apply()
        o.step = step
    metrics, _ = stage2_ae.AEStep(m, optimizers, tr)(img.to(device, dtype), epoch)
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_train_ae(card: str, tmp: Path):
    """Stage-2 AE training at the full BAIR preset: the trainer's ``train``
    over synthetic splits packed into FrameStores, random full-size
    networks, in its own counted window (no flow chain on this path); then
    its checks, its timings, the landscape step, and the step it traces."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.config import Config
    from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.data.registry import augment_params
    from image2video_synthesis_using_cinns_tpu_torch.models import layers
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.resnet2d import ResnetEncoder
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import configs
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2, stage2_ae
    from image2video_synthesis_using_cinns_tpu_torch.utils import convert

    t0 = time.perf_counter()
    root = tmp / "bair_train_ae"
    bair_split(root, AE_CLIPS, "train", first_traj=80)
    bair_split(root, AE_CLIPS, "eval", first_traj=90)
    opt = ae_config(tmp, str(root) + "/")
    tr = opt.Training
    loaders = {}
    for mode, seed, drop_last in (("train", 42, True), ("eval", 43, False)):
        ds = get_loader("BAIR")(opt, mode)
        store = FrameStore.build(ds, str(tmp / f"ae_{mode}.fst"), imread=seeded_imread)
        loaders[mode] = Loader(ds, tr["bs"], workers=tr["workers"], drop_last=drop_last,
                               seed=seed, framestore=store)
    models = stage2_ae.build_models(opt, seed=0)
    n_params = {"encoder": sum(p.numel() for p in models.network.encoder.parameters()),
                "decoder": sum(p.numel() for p in models.network.decoder_wrap.parameters()),
                "discriminator": sum(p.numel() for p in models.disc.parameters())}
    log(f"  set-up {time.perf_counter() - t0:.2f} s: BAIR train and eval splits of {AE_CLIPS} "
        f"clips packed, full-size random networks built (parameters: {n_params})")

    saved = {}  # the encoder as each Encoder_stage2 write saw it
    write_tree = stage2_ae.encoder_variables

    def recording(m):
        saved["encoder"] = copy.deepcopy(m.network.encoder)
        return write_tree(m)

    stage2_ae.encoder_variables = recording
    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = stage2_ae.train(opt, models, loaders["train"], loaders["eval"], device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stage2_ae.encoder_variables = write_tree
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  stage-2 AE training chain launches: {launches}; device kernels: {device_launches}")
    if any(launches.values()) or any(device_launches.values()):
        raise AssertionError("stage-2 AE training launched a flow chain; its path has none")
    n_steps = len(loaders["train"])
    train_m = dict(zip(stage2_ae.LOG_KEYS, out["train_loss"]))
    eval_m = dict(zip(stage2_ae.LOG_KEYS, out["eval_loss"]))
    log(f"  [{card}] stage2_ae.train bair bs={tr['bs']}, {AE_EPOCHS} epochs of {n_steps} steps "
        f"(epoch 0 gated) with the ActNorm init, validation and Encoder_stage2: {wall:.3f} s; "
        f"{out['global_step']} steps; train {train_m}, eval {eval_m}, best {out['best_val']}")
    if out["global_step"] != AE_EPOCHS * n_steps or not all(
            np.isfinite(v) for v in (*out["train_loss"], *out["eval_loss"])):
        raise AssertionError(f"stage-2 AE training: a step is missing or a value is not "
                             f"finite: {out}")
    log("  every loss, Logvar and Disc_weight finite")

    # -- the batch of the checks ----------------------------------------------------
    size = opt.Data["img_size"]
    params_aug, random_crop, _ = augment_params(opt, "train")
    aug = build_augment(size, params_aug, random_crop, True)
    aug_eval = build_augment(size, params_aug, random_crop, False)
    draws = stage2_ae.Draws()
    raw = torch.from_numpy(first_batch(loaders["train"])["seq_raw"]).to(DEVICE)
    n = raw.shape[0]
    img = aug(raw, draws=draws.augment(0, 0, 0, n, params_aug, random_crop))[:, 0]
    img = img.permute(0, 3, 1, 2).contiguous()

    # -- card against CPU: one whole step, gate open -------------------------------
    # The run's random discriminator has collapsed: its ActNorm scales were set
    # under the init's random spectral vectors (sigma near 0), and the first
    # refresh shrinks its weights, so its logits hardly depend on the image.
    # Then d_weight sits at its clamp 1e4 and multiplies a generator gradient
    # that is nearly all cancellation: that state is reported. The held state
    # refreshes the discriminator's vectors to convergence before its ActNorm
    # init, as a trained checkpoint holds them.
    b = AE_CHECK_BATCH
    conditioned = copy.deepcopy(models)
    for _ in range(AE_SN_ITERS):
        layers.power_iteration_(conditioned.disc)
    layers.init_actnorm(conditioned.disc, img)
    runs, secs = {}, {}
    for state, src, dtypes in (("run", models, (torch.float64,)),
                               ("conditioned", conditioned, (torch.float64, torch.float32))):
        for dev in ("card", "cpu"):
            for dt in dtypes:
                t1 = time.perf_counter()
                runs[state, dev, dt] = ae_step(src, tr, img[:b], 1,
                                               DEVICE if dev == "card" else "cpu", dt)
                secs[state, dev, dt] = time.perf_counter() - t1
    del conditioned

    def versus(state, dt) -> tuple[float, float, float]:
        """The losses over max(|loss|, 1); Disc_weight, a ratio of two
        gradient norms, relative; each optimizer's gradients over its largest."""
        (ma, ga), (mc, gc) = runs[state, "card", dt], runs[state, "cpu", dt]
        if set(ga) != set(gc):
            raise AssertionError(f"stage-2 AE: the card updated {sorted(ga)}, the CPU "
                                 f"{sorted(gc)}")
        m_err = max(abs(ma[k] - mc[k]) / max(abs(mc[k]), 1.0) for k in mc if k != "Disc_weight")
        w_err = abs(ma["Disc_weight"] - mc["Disc_weight"]) / abs(mc["Disc_weight"])
        g_err = 0.0
        for name in gc:
            scale = max(float(g.abs().max()) for g in gc[name])
            g_err = max(g_err, max(float((x.double() - y.double()).abs().max())
                                   for x, y in zip(ga[name], gc[name])) / scale)
        return m_err, w_err, g_err

    def state_of(state) -> str:
        m, g = runs[state, "cpu", torch.float64]
        return (f"Disc_weight {m['Disc_weight']:.6g}, L_disc {m['L_disc']:.6g}, logits real "
                f"{m['Logits_real']:.6g} fake {m['Logits_fake']:.6g}, optimizers that stepped "
                f"{sorted(g)}")

    m64, w64, g64 = versus("conditioned", torch.float64)
    m32, w32, g32 = versus("conditioned", torch.float32)
    r64, rw64, rg64 = versus("run", torch.float64)
    ok = m64 <= F64_LOSS_TOL and w64 <= F64_GRAD_TOL and g64 <= F64_GRAD_TOL
    log(f"  card vs CPU, one whole step at bs={b}, gate open (the same batch; TF32 off; CPU "
        f"{secs['conditioned', 'cpu', torch.float64]:.1f} s fp64, "
        f"{secs['conditioned', 'cpu', torch.float32]:.1f} s fp32), the discriminator refreshed "
        f"{AE_SN_ITERS} times before its ActNorm init ({state_of('conditioned')}): fp64 losses "
        f"{m64:.3e} (bound {F64_LOSS_TOL:g}), Disc_weight {w64:.3e} and both optimizers' "
        f"gradients {g64:.3e} (bound {F64_GRAD_TOL:g}) {'ok' if ok else 'FAIL'}; fp32 (reported) "
        f"losses {m32:.3e}, Disc_weight {w32:.3e}, gradients {g32:.3e}. The run's own state "
        f"({state_of('run')}), reported: fp64 losses {r64:.3e}, Disc_weight {rw64:.3e}, "
        f"gradients {rg64:.3e}")
    if not ok:
        raise AssertionError("stage-2 AE training: the card's fp64 step disagrees with the CPU's")
    del runs

    # -- the gate, and the BatchNorm statistics moving once a train step -----------------
    gm = copy.deepcopy(models)
    gopts = stage2_ae.make_optimizers(gm, tr["lr"], tr["weight_decay"])
    gstep = stage2_ae.AEStep(gm, gopts, tr)
    norms = [m for m in gm.network.modules() if isinstance(m, layers.BatchNorm)]
    moves = dict.fromkeys(norms, 0)

    def count(mod, args, kwargs):
        train = kwargs.get("train", args[1] if len(args) > 1 else False)
        moves[mod] += int(bool(train) and mod.update_stats)

    hooks = [m.register_forward_pre_hook(count, with_kwargs=True) for m in norms]

    def snapshot():
        return ([p.detach().clone() for p in gm.disc.parameters()],
                [b.clone() for name, b in gm.disc.named_buffers() if name.endswith(".u")],
                [torch.cat([m.mean, m.var]) for m in norms])

    before = snapshot()
    gstep(img, 0)
    after = snapshot()
    once = set(moves.values()) == {1}
    stats_moved = all(not torch.equal(x, y) for x, y in zip(before[2], after[2]))
    same = all(torch.equal(p, q) for p, q in zip(before[0], after[0]))
    u_moved = max(float((p - q).abs().max()) for p, q in zip(before[1], after[1]))
    ok = same and u_moved > 0 and gopts[1].count == 0 and once and stats_moved
    log(f"  gate closed (epoch 0): discriminator parameters bitwise unchanged {same}, Adam count "
        f"{gopts[1].count}, spectral u moved by up to {u_moved:.3e}; each of the {len(norms)} "
        f"BatchNorms' running statistics moved, once each {once} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("stage-2 AE training: the closed gate let the discriminator change, "
                             "or the running statistics did not move once")
    moves.update(dict.fromkeys(norms, 0))
    metrics, _ = gstep(img, 1, train=False)
    evaluated = snapshot()
    ok = (set(moves.values()) == {0} and gopts[1].count == 0
          and all(torch.equal(x, y) for x, y in zip(after[2], evaluated[2]))
          and all(torch.equal(p, q) for p, q in zip(after[0], evaluated[0])))
    log(f"  eval step (epoch 1): nothing moved, no running statistics updated "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("stage-2 AE training: the eval step changed the state")
    metrics, _ = gstep(img, 1)
    opened = snapshot()
    for h in hooks:
        h.remove()
    moved = max(float((p - q).abs().max()) for p, q in zip(evaluated[0], opened[0]))
    d_loss = float(metrics["L_disc"])
    ok = (moved > 0 and gopts[1].count == 1) if d_loss > 0 else (moved == 0 and gopts[1].count == 0)
    log(f"  gate open (epoch 1): L_disc {d_loss:.6g}, discriminator parameters moved by up to "
        f"{moved:.3e}, Adam count {gopts[1].count}; running statistics moved once each "
        f"{set(moves.values()) == {1}} {'ok' if ok else 'FAIL'}")
    if not ok or set(moves.values()) != {1}:
        raise AssertionError("stage-2 AE training: the open gate did not update as d_loss says")
    del gm, gopts, gstep

    # -- the ActNorm init on the first augmented batch ----------------------------------
    dcopy = copy.deepcopy(models.disc)
    outputs = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: outputs.__setitem__(name, o))
             for name, m in dcopy.named_modules() if isinstance(m, layers.ActNormImage)]
    layers.init_actnorm(dcopy, img)
    for h in hooks:
        h.remove()
    worst = max(max(float(o.mean((0, 2, 3)).abs().max()),
                    float((o.std((0, 2, 3)) - 1).abs().max())) for o in outputs.values())
    log(f"  ActNorm init on {n} images: each of the {len(outputs)} ActNorms' output per channel, "
        f"worst |mean| or |std - 1| {worst:.3e} (bound {ACTNORM_TOL:g}) "
        f"{'ok' if worst <= ACTNORM_TOL else 'FAIL'}")
    if not worst <= ACTNORM_TOL or len(outputs) != 3:
        raise AssertionError("stage-2 AE training: the ActNorm init does not normalise")
    del dcopy, outputs

    # -- the written Encoder_stage2 in serving -------------------------------------------
    run = Path(out["save_path"])
    ae = opt.AE
    x = aug_eval(torch.from_numpy(first_batch(loaders["eval"])["seq_raw"]).to(DEVICE))[:, 0]
    x = x.permute(0, 3, 1, 2).contiguous()
    trained = saved["encoder"].to(DEVICE)
    serving = convert.load_checkpoint(ResnetEncoder(ae["z_dim"], ae["encoder_type"], ae["norm"]),
                                      str(run / "Encoder_stage2.msgpack")).to(DEVICE).eval()
    with torch.no_grad():
        want = trained(x)
        check_rel("train ae: Encoder_stage2 in the serving ResnetEncoder embeds as the training "
                  "module did", serving(x), want, SERVE_TOL)
    s1_run = next((tmp / "runs_s1").glob("Stage1_*"))  # phase 4e's run: the stage-1 model
    opt2 = configs(PRESET)[0]
    opt2.Conditioning_Model = Config(dict(opt2.Conditioning_Model, checkpoint_name="Encoder_stage2",
                                          model_path=str(run.parent), model_name=run.name))
    opt2.First_stage_model = Config(dict(checkpoint_encoder="best_PFVD_ENC",
                                         checkpoint_decoder="best_PFVD_GEN",
                                         model_path=str(s1_run.parent), model_name=s1_run.name))
    network = stage2.build_models(opt2).network.to(DEVICE).eval()
    with torch.no_grad():
        check_rel("train ae: Encoder_stage2 in a stage-2 build_models embedder (chained to 4e's "
                  "stage-1 run) embeds as the training module did", network.embed([x]),
                  trained.encode(x).mode(), SERVE_TOL)
    del trained, serving, network

    # -- learning: 10 steps with the gate closed on one batch ------------------------------
    def learn(lr: float) -> list[float]:
        lm = copy.deepcopy(models)
        lstep = stage2_ae.AEStep(lm, stage2_ae.make_optimizers(lm, lr, tr["weight_decay"]), tr)
        with torch.no_grad():
            rec = [float(lstep.recon_losses(img, True)["rec"].mean())]
        for _ in range(10):
            rec.append(float(lstep(img, 0)[0]["Loss_recon"]))
        return rec

    lr_learn = tr["lr"] * AE_LEARN_LR_SCALE
    for lr in (tr["lr"], lr_learn):
        rec = learn(lr)
        ok = rec[-1] < rec[0]
        verdict = ("ok" if ok else "FAIL") if lr == lr_learn else "reported"
        log(f"  10 steps with the gate closed at lr {lr:g} on one batch of {n} (the run's "
            f"networks): its Loss_recon {rec[0]:.6g} -> {rec[-1]:.6g} {verdict}; after each step "
            + " ".join(f"{v:.5f}" for v in rec[1:]))
        if lr == lr_learn and not ok:
            raise AssertionError("stage-2 AE training: 10 steps on one batch did not lower its "
                                 "Loss_recon")

    # -- timings -----------------------------------------------------------------------
    tm = copy.deepcopy(models)
    topts = stage2_ae.make_optimizers(tm, tr["lr"], tr["weight_decay"])
    tstep = stage2_ae.AEStep(tm, topts, tr)

    def timed_step(step, image, reps: int = 7, warm: int = 2) -> float:
        for _ in range(warm):
            step(image, 1)
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            t1 = time.perf_counter()
            step(image, 1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        return statistics.median(lat) * 1e3

    def peak_of(step, image) -> tuple[float, float]:
        gc.collect()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        step(image, 1)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**30, resident

    step_ms = timed_step(tstep, img)
    peak, resident = peak_of(tstep, img)
    log(f"  [{card}] stage-2 AE training step bs={n} 64x64 fp32, gate open (forward, both "
        f"colorize gradients, backward, generator Adam, recompute, discriminator and its Adam, "
        f"spectral refresh): {step_ms:.3f} ms, {n / step_ms * 1e3:.1f} images/s (median of 7 "
        f"after 2 warm-ups); peak memory {peak:.2f} GiB, of which {peak - resident:.2f} GiB above "
        f"the {resident:.2f} GiB allocated before the step")
    t0 = time.perf_counter()
    vals = []
    for batch in loaders["eval"].epoch_iter(0):
        e = aug_eval(torch.from_numpy(batch["seq_raw"]).to(DEVICE))[:, 0].permute(0, 3, 1, 2)
        vals.append(float(tstep(e.contiguous(), 0, train=False)[0]["Loss_recon"]))
    torch.cuda.synchronize()
    log(f"  [{card}] validation pass ({len(vals)} batches of {tr['bs']}: the eval step, both "
        f"colorize gradients included; Loss_recon {np.mean(vals):.6g}) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    for loader in loaders.values():
        loader.framestore.close()

    # -- the landscape AE: 128 px, 'bn' encoder, the attention ----------------------------
    lopt = ae_config(tmp, "", AE_LANDSCAPE, AE_LANDSCAPE_TRAINING, AE_LANDSCAPE_DATA)
    ltr = lopt.Training
    lmodels = stage2_ae.build_models(lopt, seed=3).to(DEVICE)
    lstep = stage2_ae.AEStep(lmodels, stage2_ae.make_optimizers(lmodels, ltr["lr"],
                                                                ltr["weight_decay"]), ltr)
    limg = torch.rand((n, 3, 128, 128), generator=torch.Generator().manual_seed(9)) * 2 - 1
    limg = limg.to(DEVICE)
    layers.init_actnorm(lmodels.disc, limg)
    lmetrics, lrecon = lstep(limg, 1)
    finite = all(np.isfinite(float(v)) for v in lmetrics.values()) and bool(
        torch.isfinite(lrecon).all())
    lms = timed_step(lstep, limg, reps=3, warm=1)
    lpeak, lresident = peak_of(lstep, limg)
    log(f"  [{card}] landscape AE step bs={n} 128x128 fp32 (landscape_config.yaml's AE and "
        f"Training, w_kl {ltr['w_kl']:g}: ResNet-50 'bn' encoder on batch "
        f"statistics, z 128, 5 GBlocks and the attention, "
        f"{sum(p.numel() for p in lmodels.network.parameters())} parameters): {lms:.3f} ms "
        f"(median of 3 after 1 warm-up), peak memory {lpeak:.2f} GiB ({lpeak - lresident:.2f} "
        f"GiB above the allocated before); metrics finite {finite} "
        f"{'ok' if finite else 'FAIL'}: " + ", ".join(f"{k} {float(v):.5g}"
                                                     for k, v in lmetrics.items()))
    if not finite:
        raise AssertionError("stage-2 AE training: the landscape step is not finite")
    del lmodels, lstep

    trace_step = stage2_ae.AEStep(tm, topts, tr)

    def traced_step():  # phase_trace runs its calls under no_grad; the step enables autograd
        trace_step(img, 1)

    return launches, device_launches, traced_step


def phase_endpoint(card: str, tmp: Path):
    """``visualize_endpoint``'s body at the full BAIR preset with a random
    control model on a synthetic endpoint test split, in its own counted
    window; then its checks."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.cli import visualize_endpoint
    from image2video_synthesis_using_cinns_tpu_torch.data import get_eval_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import build_model

    t0 = time.perf_counter()
    model = build_model(PRESET, vid_length=EVAL_SEQ, seed=2, control=True, device=DEVICE)
    root = tmp / "bair_endpoint"
    bair_split(root, ENDPOINT_CLIPS, "test", first_traj=100)
    rng = np.random.default_rng(17)
    for clip in sorted((root / "test").glob("traj_*/*")):  # the end effector's track
        start = rng.uniform([0.4264, -0.3, 0.19], [0.4285, 0.2, 0.3])
        track = start + np.linspace(0, 1, BAIR_FRAMES)[:, None] * rng.uniform(-0.1, 0.1, 3)
        np.savetxt(clip / "endeffector_positions.csv", track, delimiter=",")
    dataset = get_eval_loader("bair", EVAL_SEQ + 1, str(root) + "/", model.config, control=True)
    store = FrameStore.build(dataset, str(tmp / "endpoint.fst"), imread=seeded_imread)
    loader = Loader(dataset, BATCH, shuffle=False, drop_last=False, workers=8, framestore=store)
    log(f"  set-up {time.perf_counter() - t0:.2f} s: a random full-size control model, a BAIR "
        f"endpoint test split of {ENDPOINT_CLIPS} clips with end-effector tracks packed")

    n_batches = -(-ENDPOINT_CLIPS // BATCH)
    videos, wall, launches, device_launches = eval_window(
        "endpoint", lambda: visualize_endpoint.generate(model, loader, ENDPOINT_REALIZ,
                                                        ENDPOINT_CLIPS),
        ENDPOINT_REALIZ * n_batches)
    shape = (ENDPOINT_CLIPS, ENDPOINT_REALIZ, EVAL_SEQ, 3, BAIR_PX, BAIR_PX)
    ok = (tuple(videos.shape) == shape and bool(torch.isfinite(videos).all())
          and float(videos.abs().max()) <= 1.0)
    log(f"  [{card}] visualize_endpoint body: {ENDPOINT_CLIPS} clips x {ENDPOINT_REALIZ} "
        f"realisations of {EVAL_SEQ} frames in {wall:.3f} s; videos {tuple(videos.shape)} finite "
        f"in [-1, 1] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("endpoint: a video is not finite in [-1, 1]")

    batch = first_batch(loader)
    seq = build_augment(BAIR_PX, None, False, False)(torch.from_numpy(batch["seq_raw"]).to(DEVICE))
    x0 = seq[:, 0].permute(0, 3, 1, 2).contiguous()
    cond = torch.from_numpy(batch["cond"]).to(DEVICE)
    residual = torch.randn((x0.shape[0], model.z_dim), generator=torch.Generator().manual_seed(4))
    residual = residual.to(DEVICE)
    with torch.no_grad():
        _, z = model.sample(x0, cond=cond, residual=residual)
        z_ref = fk.flow_reverse_fused_ref(model.flow.flow.packed, residual,
                                          model.flow.embed([x0, cond]))
    check("endpoint z_vs_plain", z, z_ref, TOL["bf16"])
    store.close()
    return launches, device_launches


def _timeline_library(lib):
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    fk._type_library(lib)
    lib.flow_chain_timeline.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.flow_chain_barrier_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.flow_chain_timeline, lib.flow_chain_barrier_probe):
        fn.restype = ctypes.c_int
    return lib


def chain_breakdown(card: str, p, x, emb):
    """Where one reverse chain's time goes, from the timeline build: per CTA
    and layer, clock64() at the layer's start, input staged (the wait for the
    net's count, then the load; none in layer 0), weights ready, tile done,
    the layer's count released (layers 0-2), and at a pass's end (s, t)
    arrived and glue done. Medians per layer of the MLP over the CTAs that had
    a tile in it; the wait for (s, t) (from the CTA's last tile of the pass,
    or the last layer's start where it had none) and the glue over all CTAs;
    and the span of a pass, from one glue's end to the next, over all CTAs
    and passes; and a CTA's time from the kernel's entry to its exit, before
    the first layer, and in the first pass. SM clocks are not synchronised,
    so only differences within one CTA are taken, and cycles become time at
    the clock measured by each CTA's entry and exit against the global
    timer, on which the kernel's span, from its first CTA's entry to its
    last one's exit, is read too. Then a probe times grid barriers alone."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import build
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    lib = build.load("flow_chain_timeline", _timeline_library)
    fk.LIBRARY = "flow_chain_timeline"
    try:
        with torch.no_grad():
            fk.flow_reverse_fused(p, x, emb)
            torch.cuda.synchronize()
            tl_ms = cuda_ms(lambda: fk.flow_reverse_fused(p, x, emb))
            fk.flow_reverse_fused(p, x, emb)
            torch.cuda.synchronize()
    finally:
        fk.LIBRARY = "flow_chain"
    dims = (ctypes.c_int * 3)()
    lib.flow_chain_timeline(None, dims)  # the sizes only
    tl = np.zeros(tuple(dims), dtype=np.int64)
    err = lib.flow_chain_timeline(tl.ctypes.data, dims)
    if err != 0:
        raise RuntimeError(f"timeline read failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_passes = 2 * p.n_flows
    edges = tl[:sms, -1, :4].astype(np.float64)  # entry, exit: SM cycles, then global ns
    mhz = float(np.median((edges[:, 1] - edges[:, 0]) / (edges[:, 3] - edges[:, 2]))) * 1e3
    t = tl[:sms, :4 * n_passes].astype(np.float64) / mhz  # microseconds
    t = t.reshape(sms, n_passes, 4, t.shape[-1])  # (CTA, pass, layer of the MLP, point)
    had_tile = t[..., 3] > 0
    layers = []
    for lyr in range(4):
        h = had_tile[:, :, lyr]
        parts = [np.median((t[:, :, lyr, k + 1] - t[:, :, lyr, k])[h])
                 for k in range(3 if lyr == 3 else 4)]
        layers.append(f"layer {lyr} ({int(h.sum())} tiles) input {parts[0]:.3f}, weights "
                      f"{parts[1]:.3f}, math {parts[2]:.3f}"
                      + ("" if lyr == 3 else f", release {parts[3]:.3f}"))
    end = t[:, :, 3]
    own_end = np.where(had_tile[:, :, 3], end[..., 3], end[..., 0])
    span = np.diff(end[..., 5], axis=1)
    entry, leave = edges[:, 0] / mhz, edges[:, 1] / mhz
    log(f"  [{card}] chain breakdown, reverse bf16-weights B={x.shape[0]} (timeline build "
        f"{tl_ms:.4f} ms a call; SM clock {mhz:.0f} MHz, measured against the global timer), "
        "median us: "
        + "; ".join(layers)
        + f"; per pass: wait for (s, t) {np.median(end[..., 4] - own_end):.3f}, glue "
        f"{np.median(end[..., 5] - end[..., 4]):.3f}, span {np.median(span):.3f} "
        f"(x {n_passes} passes = {np.median(span) * n_passes / 1e3:.4f} ms); a CTA from entry "
        f"to exit {np.median(leave - entry):.3f}, of which before the first layer "
        f"{np.median(t[:, 0, 0, 0] - entry):.3f} and the first pass "
        f"{np.median(end[:, 0, 5] - t[:, 0, 0, 0]):.3f}; the kernel, first entry to last exit "
        f"{(edges[:, 3].max() - edges[:, 2].min()) / 1e3:.3f}, entries spread "
        f"{np.ptp(edges[:, 2]) / 1e3:.3f}, exits {np.ptp(edges[:, 3]) / 1e3:.3f}")
    stream = torch.cuda.current_stream().cuda_stream
    for barrier in ("cooperative groups' grid sync", "a grid barrier written by hand"):
        for n in (100, 1000):
            def probe():
                counter = (None if barrier.startswith("cooperative")
                           else torch.zeros(1, dtype=torch.int32, device=DEVICE))
                err = lib.flow_chain_barrier_probe(
                    None if counter is None else counter.data_ptr(), n, stream)
                if err != 0:
                    raise RuntimeError(f"barrier probe: CUDA error {err}")
            ms = cuda_ms(probe, iters=5, reps=5)
            log(f"  [{card}] barrier probe, {barrier} ({sms} CTAs x 256 threads): {n} barriers "
                f"{ms:.4f} ms, {ms * 1e3 / n:.3f} us each")


def kernel_row(card: str, label: str, name: str, p, x, emb) -> dict:
    """One chain's median ms on these inputs, beside its plain version and its
    bound: the larger of the bytes it must move (the unpadded weights, x and
    emb read once, the outputs written once) over the HBM rate and its flops
    (2 per weight and row) over the peak rate of its weight type."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    kern, ref = getattr(fk, name), getattr(fk, name + "_ref")
    mode = "bf16" if p.bf16 else "fp32"
    b = x.shape[0]
    wbytes = p.weight_bytes()
    out_bytes = 4 * (x.numel() + (b if name == "flow_forward_fused" else 0))  # (+ logdet)
    flops = 2 * b * (wbytes // (2 if p.bf16 else 4))
    bound_bytes = (wbytes + 4 * (x.numel() + emb.numel()) + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[mode] * 1e3
    with torch.no_grad():
        ms = cuda_ms(lambda: kern(p, x, emb))
        plain_ms = cuda_ms(lambda: ref(p, x, emb), iters=5, reps=5)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    log(f"  [{card}] {name} {mode}-weights {label} B={b} E={p.E}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {wbytes} "
        f"weight bytes, {flops} flops)")
    return row


def phase_timings(card: str, models, x0, residual):
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    flow = models["float32"].flow
    with torch.no_grad():
        emb = flow.embed([x0])
    flow_mod = flow.flow
    rows = {}
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = fk.PackedFlow(flow_mod.blocks_dict(), flow_mod.shuffle.fwd, flow_mod.shuffle.inv,
                          flow_mod.mask, dtype)
        for name in ("flow_reverse_fused", "flow_forward_fused"):
            rows[(name, mode)] = kernel_row(card, "BAIR", name, p, residual, emb)
        if mode != "bf16":
            continue
        with torch.no_grad():  # the main path's chain: batch sweep and breakdown
            gen = torch.Generator(device="cpu").manual_seed(5)
            for b in SWEEP:
                xb = torch.randn(b, residual.shape[1], generator=gen).to(DEVICE)
                eb = torch.randn(b, emb.shape[1], generator=gen).to(DEVICE)
                ms = cuda_ms(lambda: fk.flow_reverse_fused(p, xb, eb))
                log(f"  [{card}] flow_reverse_fused bf16-weights batch sweep B={b}: {ms:.4f} ms")
            chain_breakdown(card, p, residual, emb)
    for dt, model in models.items():
        model.vid_length = 16
        with torch.no_grad():
            for _ in range(2):
                model.forward(x0, residual=residual)
            torch.cuda.synchronize()
            lat = []
            for _ in range(7):
                t0 = time.perf_counter()
                model.forward(x0, residual=residual)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        med = statistics.median(lat)
        log(f"  [{card}] Model.forward bs=6 T=16 64x64 {dt}: latency {med * 1e3:.3f} ms, "
            f"{6 * 16 / med:.1f} frames/s (median of 7)")
        with torch.no_grad():  # the stages of one forward, each timed alone
            z = model.sample(x0, residual=residual)[1]
            xd, zd = x0.to(model.compute_dtype), z.to(model.compute_dtype)
            emb_ms = cuda_ms(lambda: model.flow.embed([x0]), iters=5, reps=5)
            dec_ms = cuda_ms(lambda: model.decoder(xd, zd), iters=3, reps=5)
        log(f"  [{card}] stages of Model.forward bs=6 {dt} decoder: embedder {emb_ms:.3f} ms, "
            f"flow_reverse_fused {rows[('flow_reverse_fused', 'bf16')]['ms']:.3f} ms, "
            f"decoder (16 frames) {dec_ms:.3f} ms")
    return rows


def phase_transfer_timings(card: str, models, q, x0):
    """``Model.transfer`` latency and frames/s, its stages each timed alone, and
    both chains at the shapes the transfer gives them."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    img = q.shape[-1]
    for dt, model in models.items():
        with torch.no_grad():
            for _ in range(2):
                model.transfer(q, x0)
            torch.cuda.synchronize()
            lat = []
            for _ in range(7):
                t0 = time.perf_counter()
                model.transfer(q, x0)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        med = statistics.median(lat)
        log(f"  [{card}] Model.transfer landscape, one {q.shape[1]}-frame query onto bs={BATCH}, "
            f"T=16 {img}x{img} {dt}: latency {med * 1e3:.3f} ms, {BATCH * 16 / med:.1f} "
            "frames/s (median of 7)")
    model = models["float32"]
    flow, packed = model.flow, model.flow.flow.packed
    clip = q[:, 1:].permute(0, 2, 1, 3, 4)
    with torch.no_grad():  # the stages of one transfer, each timed alone
        _, mu, _ = model.encoder(clip)
        emb_q, emb_x = flow.embed([q[:, 0]]), flow.embed([x0])
        nu = fk.flow_forward_fused(packed, mu, emb_q)[0].repeat(BATCH, 1)
        z = fk.flow_reverse_fused(packed, nu, emb_x)
        enc_ms = cuda_ms(lambda: model.encoder(clip), iters=5, reps=5)
        emb_q_ms = cuda_ms(lambda: flow.embed([q[:, 0]]), iters=5, reps=5)
        emb_ms = cuda_ms(lambda: flow.embed([x0]), iters=5, reps=5)
        fwd_ms = cuda_ms(lambda: fk.flow_forward_fused(packed, mu, emb_q))
        rev_ms = cuda_ms(lambda: fk.flow_reverse_fused(packed, nu, emb_x))
        dec_ms = {dt: cuda_ms(lambda: m.decoder(x0.to(m.compute_dtype), z.to(m.compute_dtype)),
                              iters=3, reps=5)
                  for dt, m in models.items()}
    log(f"  [{card}] stages of Model.transfer landscape: encoder (resnet18 3-D, fp32, "
        f"{clip.shape[2]} frames) {enc_ms:.3f} ms, embedder (ResNet-50 bn, fp32) query "
        f"{emb_q_ms:.3f} ms and bs={BATCH} {emb_ms:.3f} ms, flow_forward_fused B=1 {fwd_ms:.4f} ms, "
        f"flow_reverse_fused B={BATCH} {rev_ms:.4f} ms, decoder (16 frames) fp32 "
        f"{dec_ms['float32']:.3f} ms, bf16 {dec_ms['bfloat16']:.3f} ms")
    rows = {}
    flow_mod = flow.flow
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = fk.PackedFlow(flow_mod.blocks_dict(), flow_mod.shuffle.fwd, flow_mod.shuffle.inv,
                          flow_mod.mask, dtype)
        rows[("flow_forward_fused", mode)] = kernel_row(card, "landscape", "flow_forward_fused",
                                                        p, mu, emb_q)
        rows[("flow_reverse_fused", mode)] = kernel_row(card, "landscape", "flow_reverse_fused",
                                                        p, nu, emb_x)
    return rows


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def phase_trace(card: str, label: str, call, filename: str, before_chain: str,
                spans: tuple[str, ...] = ()):
    """One torch.profiler window over two calls of ``call`` after two warm-up
    calls: the top device kernels, the flow chain's share, the device's idle
    share over the window's device span, and for each call the host time
    from its start to the first flow chain's launch against the device time
    of the kernels launched before it (``before_chain`` names them). With
    ``spans``, the device time of the kernels launched inside each named
    ``record_function`` span, on any thread (autograd's backward runs on its
    own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.no_grad():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                with record_function(f"{label} #{i}"):
                    call()
            torch.cuda.synchronize()
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / filename
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        log(f"  [{card}] trace: the profiler recorded no device activity; not measured")
        return
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    span = max(b for _, b in intervals) - min(a for a, _ in intervals)
    busy = _union_us(intervals)
    by_name: dict[str, list[float]] = {}
    for e in device:
        by_name.setdefault(e["name"], []).append(e["dur"])
    total = sum(sum(v) for v in by_name.values())
    chain = sum(sum(v) for k, v in by_name.items() if "chain_kernel" in k)
    log(f"  [{card}] trace of 2 x {label} ({path.name}): device span "
        f"{span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share {1 - busy / span:.3f}; "
        f"{len(device)} device activities, {total / 1e3:.3f} ms in all; flow chain "
        f"{chain / 1e3:.4f} ms = {chain / total:.4f} of device time")
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        log(f"    {sum(durs) / 1e3:9.4f} ms  {sum(durs) / total:.3f}  x{len(durs):<4d} {name[:110]}")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    if spans:
        windows = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                          if e.get("cat") == "user_annotation" and e.get("name") == name]
                   for name in spans}
        in_span = dict.fromkeys(spans, 0.0)
        for e in device:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            name = next((k for k, ws in windows.items() if ts is not None
                         and any(a <= ts <= b for a, b in ws)), None)
            if name is not None:
                in_span[name] += e["dur"]
        log(f"  [{card}] device time by span: " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / total:.3f})" for k, v in in_span.items())
            + f"; outside them {(total - sum(in_span.values())) / 1e3:.3f} ms")
    for i in range(2):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == f"{label} #{i}"]
        if not window:
            continue
        start, end = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        launched = sorted(((launch_ts[e["args"]["correlation"]], e) for e in device
                           if launch_ts.get(e.get("args", {}).get("correlation"), -1.0) >= start
                           and launch_ts[e["args"]["correlation"]] <= end),
                          key=lambda te: te[0])
        chain_at = next((ts for ts, e in launched if "chain_kernel" in e["name"]), None)
        if chain_at is None:
            continue
        before = [e for ts, e in launched if ts < chain_at]
        dev_busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in before])
        log(f"  [{card}] {label} #{i}: host {(chain_at - start) / 1e3:.3f} ms from its "
            f"start to the flow chain's launch; the {len(before)} device activities launched "
            f"before it ({before_chain}) are busy {dev_busy / 1e3:.3f} ms; host wall "
            f"{(end - start) / 1e3:.3f} ms under the profiler")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import build

    log("== 1. environment")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"  card: {card}")
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("== 2. build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        built = dict(zip(LIBRARIES, pool.map(build.build, LIBRARIES)))
    log(f"  built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{name} ({b['seconds']:.2f} s)" for name, b in built.items()))
    for line in built["flow_chain"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    log("== 3. kernel vs plain (BAIR flow shape)")
    errs = phase_kernel_vs_plain()
    log("== 3b. kernel vs plain (landscape flow shape)")
    errs.update(phase_landscape_flow())

    log("== 4. sampling path (BAIR preset, random weights)")
    models, x0, residual, launches, device_launches = phase_main_path()
    log("== 4b. transfer path (landscape preset, random weights)")
    t_models, q, t_x0, t_launches, t_device_launches = phase_transfer()
    log("== 4c. offline evaluation (BAIR preset, random weights and backbones)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        e_launches, e_device_launches, synthesis_step = phase_eval(card, models, Path(tmp))
        log(f"  phase 4c took {time.perf_counter() - t0:.2f} s")
        log("== 4d. stage-2 training (BAIR preset, random weights and I3D)")
        t0 = time.perf_counter()
        tr_launches, tr_device_launches, train_step, tr_rows = phase_train(
            card, Path(tmp), str(Path(tmp) / "models"))
        log(f"  phase 4d took {time.perf_counter() - t0:.2f} s")
        log("== 4e. stage-1 training (BAIR preset, random weights, LPIPS and I3D)")
        t0 = time.perf_counter()
        s1_launches, s1_device_launches, s1_train_step = phase_train_stage1(
            card, Path(tmp), str(Path(tmp) / "models"))
        log(f"  phase 4e took {time.perf_counter() - t0:.2f} s")
        log("== 4f. stage-2 AE training (BAIR preset, random weights)")
        t0 = time.perf_counter()
        ae_launches, ae_device_launches, ae_train_step = phase_train_ae(card, Path(tmp))
        log(f"  phase 4f took {time.perf_counter() - t0:.2f} s")
        log("== 4g. endpoint control (BAIR preset, random control model)")
        t0 = time.perf_counter()
        ep_launches, ep_device_launches = phase_endpoint(card, Path(tmp))
    log(f"  phase 4g took {time.perf_counter() - t0:.2f} s")

    log("== 5. timings")
    rows = phase_timings(card, models, x0, residual)
    log("== 5b. transfer timings (landscape preset)")
    t_rows = phase_transfer_timings(card, t_models, q, t_x0)

    log("== 6. traces")
    sampler, transfer = models["bfloat16"], t_models["bfloat16"]
    sampler.vid_length = 16
    phase_trace(card, "Model.forward bs=6 T=16 bf16",
                lambda: sampler.forward(x0, residual=residual),
                "trace_model_forward_bf16.json", "embedder, input")
    phase_trace(card, "Model.transfer landscape bs=6 T=16 bf16",
                lambda: transfer.transfer(q, t_x0),
                "trace_model_transfer_bf16.json", "encoder, query embedder, input")
    phase_trace(card, "eval synthesis step bs=6 fp32", synthesis_step,
                "trace_eval_synthesis_step.json", "embedder, input")
    phase_trace(card, "stage-2 train step bs=50 fp32", train_step, "trace_train_step.json",
                "no chain in a step", spans=TRAIN_SPANS)
    phase_trace(card, "stage-1 train step bs=10 fp32", s1_train_step,
                "trace_train_stage1_step.json", "no chain in a step", spans=S1_SPANS)
    phase_trace(card, "stage-2 AE train step bs=30 fp32", ae_train_step,
                "trace_train_ae_step.json", "no chain in a step", spans=AE_SPANS)

    # each kernel at the shape its path gives it, in that path's mode (bf16
    # weights): the reverse at the BAIR sampling path's B=6, E=64, the forward
    # at the transfer's one query, B=1, E=128; launches over all eight windows;
    # beside them each in the training path's fp32-weight mode at B=10, E=64
    kernels = []
    for name, line, r, shape, err_key in (
        ("flow_reverse_fused", 221, rows[("flow_reverse_fused", "bf16")], "B=6 C=64 E=64",
         "blocks=20 control=0 bf16 reverse"),
        ("flow_forward_fused", 215, t_rows[("flow_forward_fused", "bf16")], "B=1 C=64 E=128",
         "landscape E=128 bf16 forward B=1"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS_KERNEL}:{line}",
            "launches": (launches[name] + t_launches[name] + e_launches[name] + tr_launches[name]
                         + s1_launches[name] + ae_launches[name] + ep_launches[name]),
            "device_launches": (device_launches[name] + t_device_launches[name]
                                + e_device_launches[name] + tr_device_launches[name]
                                + s1_device_launches[name] + ae_device_launches[name]
                                + ep_device_launches[name]),
            "shape": f"{shape} hidden 512 20 blocks, bf16 weights",
            "max_abs_err": errs[err_key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "training_fp32": {k: tr_rows[name][k] for k in ("ms", "plain_ms", "bound_ms")},
        })
    print(card)  # as nvidia-smi --query-gpu=name,power.limit gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
