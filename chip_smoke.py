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
   at another batch size (``BATCHING_TOL``); the materialised scorers on the
   card over the same clips with the streams' tail drops (``calculate_FVD``
   kinetics and DT-16, ``compute_fvd_official_protocol``, ``calculate_FID``,
   ``compute_lpips``, the three diversity scorers) against the streams'
   values (``SCORER_TOL``). Then the eval's wall time and clips/s for each
   body and its stages, each timed alone.
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
   flow chain on this path), with deterministic algorithms, so that the
   trained state (its fingerprint printed) repeats from run to run. Checks:
   losses, ``Logvar`` and ``Disc_weight`` finite; one whole step from that
   state on the card against the CPU at bs 2, with the
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
   4h. The reference's checkpoints: a full BAIR-preset model directory in
   the reference framework's ``.pth`` key layout (``testing.
   make_reference_model_dir``: the stage-1 decoder and encoder, ``cINN``, the
   ResNet-50 'in' embedder, from seeded random port modules), converted with
   ``cli/convert_weights.py model_dir`` and served by ``Model`` in its own
   counted window (``Model.sample`` at bs 6, 16 frames, fp32 and bf16
   decoder: 2 reverse chains; ``Model.transfer_sample`` of one 17-frame
   query: 1 forward and 1 reverse chain). Checks: every converted leaf,
   through the bridge, is its source module's tensor bitwise; the videos
   and z equal (``SOURCE_TOL``) those of a ``Model`` given the source
   weights directly (``testing.reference_model``), with the same residual;
   z against the plain chains; full-size I3D (kinetics, DT-16, the TF-hub
   ``.npz``), Inception and LPIPS with VGG16 written in their reference
   layouts, converted by the CLI's kinds and read by the port's loaders,
   give their source modules' activations; the AE trainer with
   ``AE.pretrained: true`` on a synthesized ``biggan_64.pth`` (chn 96) takes
   every decoder weight but ``G_linear`` from it, and one AE step on the
   card gives finite losses. Prints each conversion's wall time and the
   converted model's bf16 ``Model.forward`` latency by ``StepTimer``.
   4i. Stage-2 training from cached posteriors: phase 4d's splits (their
   FrameStores reopened: 100 clips, 1,400 windows) and Training section with
   ``Data.aug: false`` and ``Training.cache_posteriors: true``; the train
   loader reads one frame a clip with its (index, start). Checks: the trainer
   refuses the cache with the augmentation on; ``build_cache`` in fp32 and
   with the bf16 encoder against the encoder's direct forward of every window
   of 6 clips (``CACHE_ROW_TOL``; another clip's windows further apart than
   that, ``CACHE_SEPARATION``); the lean loader's frame and meta against the
   full loader's; one cached step against one uncached step from the same
   flow, batch and draws, in fp32 and bf16 (the loss terms,
   ``CACHED_LOSS_TOL``; the flow's weights within two Adam steps). Then the
   trainer's ``train`` with the cache (2 epochs of 2 steps, validation,
   prior FVD, checkpoints) and ``cINN_latest.msgpack`` served by
   ``Model.from_configs``, in one counted window (one forward chain per
   validation batch, one reverse chain per prior-FVD batch and one serving):
   losses finite, the served flow the trained one bitwise, its video finite
   in [-1, 1] and z against the plain chain. Then the cache build's time and
   windows/s (fp32, bf16), the cached and the uncached step at bs 50 with aug
   off (fp32, bf16; each with its copy from the host), and the bytes each
   copies from the host.
   4j. Data parallelism (``parallel/``) at the full BAIR preset. Serving:
   ``Model(data_parallel=...)`` over every visible card and over two
   replicas on ``cuda:0``, bs 7 (the two-replica split pads a row), fp32 and
   bf16 decoder, and a landscape ``transfer_sample`` on two replicas, each
   against one device (``DP_TOL``, the JAX package's bound), in three counted
   windows: one reverse chain a replica a call, one forward chain for the
   query; the bf16 latency of two replicas beside one. Its training half
   runs as phase 7.
   4k. Tensor parallelism (``parallel/tp.py``) and the width-sharded decoder
   (``parallel/spatial.py``) at the full BAIR preset, in one counted window:
   ``Model(data_parallel=..., spatial_shard=2)`` over two entries of
   ``cuda:0`` (one row of two: bs 1 at 16 frames, the latency case; bs 6
   at 24, the extension) and over four (a 2 x 2 grid, bs 7), fp32 and bf16
   decoder, a landscape ``transfer_sample`` on a 1 x 2 grid, and
   ``testing.dryrun_multichip(["cuda:0"] * 4, "bair")`` (one tensor-parallel
   stage-2 step, the padded eval, the cached loss and step, data-parallel
   sampling from the trained flow gathered, packed and through
   ``flow_reverse_fused``, the width-sharded and data x spatial decodes).
   Checks: fp32 videos and z against one device (``DP_TOL``); bf16 within
   ``SP_BF16_MEAN_TOL`` mean abs of the one-device fp32 video (the largest
   error printed); one reverse chain a data row a call and one forward for
   the query, each one device kernel; one tensor-parallel stage-2 step on a
   2 x 2 grid against the one-device step in fp64 at bs 10 (loss terms,
   gradients against each tensor's largest, weights after the step:
   ``PAR_TOL``). Then each setup's latency beside one device's at the same
   batch, and the fp32 step at bs 50 beside the one-device step.
   4l. The empty-disk pipeline (``cli/pipeline_drive.run_pipeline``) at the
   full BAIR preset with the drive's own defaults (3 steps, 6 clips a split,
   bs 3) and 4c's random full-size backbones, in its own counted window:
   synthetic BAIR data written as PNGs, stage-1 training, AE training, cINN
   training on a config chained to the two directories just written, the
   ``generate_samples`` CLI (a GIF) and the eval CLI (FID, LPIPS, DTFVD) on
   the cINN's directory, and ``Model`` from it. Checks: each file a trainer
   writes where the next consumer looks for it, the GIF; one forward chain
   per validation batch of the cINN's run (2) and one reverse chain per
   batch of the generate CLI (2) and the eval CLI (2) and for the drive's
   ``Model`` (1), each one device kernel, counted beforehand from the
   drive's batches; the scores finite; the flow ``Model`` serves from the
   directory the trained one bitwise, its video finite in [-1, 1], z
   against the plain chain. Prints each stage's wall time.
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
   (sample a batch, all four backbones), of two stage-2 training steps, of two
   cached stage-2 training steps, of two stage-1 training steps and of two
   stage-2 AE training steps (device time by stage span): the top device kernels, the flow
   chain's share, the device's idle share, and the host and device time
   before the first flow chain (the embedder; in transfer, the encoder and
   the query's embedding). The traces are written to ``smoke_out/`` (listed
   in ``.gitignore``).
7. Multi-process training (phase 4j's second half, after this process has
   let its models go): the trainers' ``main``s on configs chained to phases
   4d-4f (their splits and FrameStores, 4e's stage-1 run, 4f's AE, 4c's
   backbones): stage 2 at bs 50 (validation and prior FVD), stage 2 cached
   (its cache built in shards), stage 1 at bs 10 and the AE at bs 30 with
   the discriminators open, at their configs' lr, one epoch (2 steps) each,
   and stage 1 (bs 4) and the AE (bs 6) again in fp64
   (``testing.float64_training``, 2 steps); in two ranks of a gloo group
   that this script spawns (``--par-rank``; ``Training.distributed``
   mappings) on the one card and, at the same time, in this process in a
   one-rank NCCL group; checkpoint writes are recorded, not written.
   Checks: the ranks log the same losses and end with the same weights;
   the fp64 runs of stage 1 and of the AE (logs, every trained weight and
   buffer), one fp64 step of stage 2 (loss terms, averaged gradients, the
   flow after it) and one fp64 step of the AE at lr 0 (metrics, averaged
   gradients, running statistics, ActNorm and spectral state) equal the one
   process's (``PAR_TOL``; gradients against each tensor's largest); the
   sharded cache equals the one-process cache bitwise; rank 0 alone writes;
   both groups all-reduce on the card; the train augment gives a rank's
   rows the bits of the same rows in the whole batch (``augment_rows_check``,
   F12; with an fp32 contrast sum, reported). The fp32 runs' differences and each
   process's step and job times are printed; for fp32 stage 2 and the AE's
   fp64 run, the element with the largest two-rank gap and both runs'
   gradients there at each step, on their own batches. To fit phase 4l's
   time, this phase no longer runs the one process before the ranks, keeps
   the one process's arrays in memory instead of a file, and compares on
   the card; every check it made before stays, and the AE's whole fp64 run,
   reported before, is held.
8. A ``{"kernels": [...]}`` line (launches summed over the fifteen counted
   windows, 4l's the fifteenth), then the last line ``{"ok": true, "device":
   {...}}``.

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
# the materialised scorers against the streams on the same clips (relative), as
# tests/test_torch_port_eval.py holds the streams to the JAX package's
SCORER_TOL = {"frechet": 1e-4, "distance": 1e-5}
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
    stacks = []
    d_add_batch = dstream.add_batch

    def keep_stack(stack):  # the realisations, for the materialised scorers
        stacks.append(stack.clone())
        d_add_batch(stack)

    dstream.add_batch = keep_stack
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
    dstream.add_batch = d_add_batch

    # the materialised scorers over the same clips, with the streams' populations
    from image2video_synthesis_using_cinns_tpu_torch.metrics import diversity

    stack_all = torch.cat(stacks)
    fvd_n = n // 16 * 16
    ff_all, rf_all = fake_all.flatten(0, 1), real_all.flatten(0, 1)
    scorers = {
        "FVD calculate_FVD (kinetics, batches of 16)": (
            lambda: fvd.calculate_FVD(kin, fake_all[:fvd_n], real_all[:fvd_n], 16),
            synth["FVD"], SCORER_TOL["frechet"]),
        "FVD compute_fvd_official_protocol": (
            lambda: fvd.compute_fvd_official_protocol(
                fake_all[:fvd_n].reshape((-1, 16) + fake_all.shape[1:]),
                real_all[:fvd_n].reshape((-1, 16) + real_all.shape[1:]), root, DEVICE),
            synth["FVD"], SCORER_TOL["frechet"]),
        "DTFVD calculate_FVD (dt16, batches of 40)": (
            lambda: fvd.calculate_FVD(i3d["dt16"][0], fake_all, real_all, 40),
            synth["DTFVD"], SCORER_TOL["frechet"]),
        "FID calculate_FID": (
            lambda: fid.calculate_FID(stream.inception, ff_all, rf_all)[0], synth["FID"],
            SCORER_TOL["frechet"]),
        "LPIPS compute_lpips": (
            lambda: lpips_eval.compute_lpips(ff_all, rf_all, 10, root, DEVICE), synth["LPIPS"],
            SCORER_TOL["distance"]),
        "VGG compute_vgg_diversity": (
            lambda: diversity.compute_vgg_diversity(stack_all, device=DEVICE), div["VGG"],
            SCORER_TOL["distance"]),
        "I3D compute_I3D_diversity": (
            lambda: diversity.compute_I3D_diversity(stack_all, N_REALIZ, root, DEVICE),
            div["I3D"], SCORER_TOL["distance"]),
        "DTI3D compute_DTI3D_diversity": (
            lambda: diversity.compute_DTI3D_diversity(stack_all, root, DEVICE), div["DTI3D"],
            SCORER_TOL["distance"]),
    }
    for name, (score, want, tol) in scorers.items():
        t0 = time.perf_counter()
        got = score()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        rel = abs(got - want) / abs(want)
        ok = np.isfinite(got) and rel <= tol
        log(f"  [{card}] materialised {name}: {got:.10g} in {took:.3f} s; the stream's "
            f"{want:.10g}: rel {rel:.3e} (bound {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with the stream")
    del stacks, stack_all

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
    # deterministic algorithms, so that the trained state the card-against-CPU
    # step starts from (and the error it reads) repeats from run to run
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = stage2_ae.train(opt, models, loaders["train"], loaders["eval"], device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stage2_ae.encoder_variables = write_tree
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    fingerprint = sum(float(p.detach().double().sum()) for m in (models.network, models.disc)
                      for p in m.parameters())
    log(f"  the trained state's fingerprint (the sum of its weights, fp64): {fingerprint!r}")
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

    worst = {}  # the loss that sets each comparison's loss error

    def versus(state, dt) -> tuple[float, float, float]:
        """The losses over max(|loss|, 1); Disc_weight, a ratio of two
        gradient norms, relative; each optimizer's gradients over its largest."""
        (ma, ga), (mc, gc) = runs[state, "card", dt], runs[state, "cpu", dt]
        if set(ga) != set(gc):
            raise AssertionError(f"stage-2 AE: the card updated {sorted(ga)}, the CPU "
                                 f"{sorted(gc)}")
        m_err, m_key = max((abs(ma[k] - mc[k]) / max(abs(mc[k]), 1.0), k) for k in mc
                           if k != "Disc_weight")
        worst[state, dt] = f"{m_key}: card {ma[m_key]!r}, CPU {mc[m_key]!r}"
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
        f"{m64:.3e} (bound {F64_LOSS_TOL:g}; {worst['conditioned', torch.float64]}), "
        f"Disc_weight {w64:.3e} and both optimizers' "
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


# phase 4h, the reference's checkpoints: a BAIR-preset model directory in the
# reference's .pth layout from seeded random port modules, converted with the
# port's CLI and served; the converted model's videos and z against a Model
# given the same weights directly (SOURCE_TOL: the same weights and inputs on one
# card), the metric backbones' activations likewise, the AE from a synthesized
# ImageNet BigGAN checkpoint (AE.pretrained)
REF_SEED, REF_BACKBONE_SEED, REF_BIGGAN_SEED = 21, 22, 23
SOURCE_TOL = 1e-6
REF_BACKBONES = {  # convert_weights kind: (source file, its --dst under the weights root)
    "i3d": ("model_rgb.pth", "PI3D/model_rgb.msgpack"),
    "dti3d16": ("I3D_16.pth.tar", "DTI3D/length16/I3D_16.msgpack"),
    "fid": ("pt_inception-2015-12-05-6726825d.pth", "FID/pt_inception.msgpack"),
    "lpips": ("vgg.pth", "lpips/vgg_lpips.msgpack"),
    "i3d_tf": ("tf_i3d.npz", "PI3D_tf/model_rgb.msgpack"),
}
REF_TIMED_RUNS = 7


def phase_reference(card: str, tmp: Path):
    """The reference-checkpoint path at the full BAIR preset: write, convert,
    serve in a counted window, then the checks (see the module docstring)."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch import testing
    from image2video_synthesis_using_cinns_tpu_torch.cli import convert_weights
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid, fvd, lpips_eval
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.biggan import BigAE
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1, stage2_ae
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert
    from image2video_synthesis_using_cinns_tpu_torch.utils.profiling import StepTimer

    p = testing.PRESETS[PRESET]
    t0 = time.perf_counter()
    d = testing.make_reference_model_dir(str(tmp / "reference"), PRESET, seed=REF_SEED)
    log(f"  [{card}] wrote the reference-layout {PRESET} directory (4 .pth files, "
        f"{sum(f.stat().st_size for f in Path(d).parent.rglob('*.pth')) / 2**20:.1f} MiB) in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        convert_weights.main(["model_dir", "--src", d])
    wall = time.perf_counter() - t0
    written = out.getvalue().count("wrote")
    log(f"  [{card}] convert_weights model_dir: {written} files in {wall:.2f} s")
    if written != 4:
        raise AssertionError(f"model_dir converted {written} files, not 4")

    # every converted leaf, through the bridge, is the source module's tensor
    src = testing.reference_sources(PRESET, REF_SEED)
    files = {"decoder": "stage1/best_PFVD_GEN", "encoder": "stage1/best_PFVD_ENC",
             "flow": "stage2/cINN", "embedder": "AE/Encoder_stage2"}
    n_leaves = 0
    for name, rel in files.items():
        path = str(Path(d).parent / rel) + ".msgpack"
        tree = checkpoint.variables(checkpoint.load(path), path)
        if name == "flow":
            tree = {c: t["flow"] for c, t in tree.items()}
        got, want = convert.to_state_dict(tree, fold_spectral=False), src[name].state_dict()
        bad = sorted(set(got) ^ set(want)) + [k for k in want if k in got
                                               and not torch.equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"converted {name} differs from its source: {bad[:5]}")
        n_leaves += len(want)
    log(f"  converted leaves equal to their sources bitwise: {n_leaves} tensors ok")

    models = {dt: Model(d + "/", vid_length=EVAL_SEQ, transfer=dt == "float32",
                        compute_dtype=dt, device=DEVICE) for dt in ("float32", "bfloat16")}
    sources = {dt: testing.reference_model(PRESET, REF_SEED, EVAL_SEQ, transfer=dt == "float32",
                                           compute_dtype=dt, device=DEVICE)
               for dt in ("float32", "bfloat16")}
    img = p["img_size"]
    rng = np.random.default_rng(99)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    residual = torch.from_numpy(
        rng.standard_normal((BATCH, p["z_dim"])).astype(np.float32)).to(DEVICE)
    q = torch.from_numpy(
        rng.uniform(-1, 1, (1, p["seq_length"], 3, img, img)).astype(np.float32)).to(DEVICE)

    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        outs = {dt: m.sample(x0, residual=residual) for dt, m in models.items()}
        transferred = models["float32"].transfer_sample(q, x0)
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  converted-model chain launches: {launches}; device kernels they launched: "
        f"{device_launches}")
    for name in ("flow_forward_fused", "flow_reverse_fused"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched serving the converted model")
    if device_launches != launches:
        raise AssertionError("a chain launched other than one device kernel")

    with torch.no_grad():
        for dt, (vid, z) in outs.items():
            check_video(f"converted sample {dt}", vid, (BATCH, EVAL_SEQ, 3, img, img))
            want_vid, want_z = sources[dt].sample(x0, residual=residual)
            check(f"converted {dt} video_vs_source_weights", vid, want_vid, SOURCE_TOL)
            check(f"converted {dt} z_vs_source_weights", z, want_z, SOURCE_TOL)
        check_video("converted transfer float32", transferred[0], (BATCH, EVAL_SEQ, 3, img, img))
        want_t = sources["float32"].transfer_sample(q, x0)
        check("converted transfer video_vs_source_weights", transferred[0], want_t[0], SOURCE_TOL)
        check("converted transfer z_vs_source_weights", transferred[1], want_t[1], SOURCE_TOL)
        model = models["float32"]
        flow, packed = model.flow, model.flow.flow.packed
        emb = flow.embed([x0])
        check("converted z_vs_plain", outs["float32"][1],
              fk.flow_reverse_fused_ref(packed, residual, emb), TOL["bf16"])
        _, mu, _ = model.encoder(q[:, 1:].permute(0, 2, 1, 3, 4))
        nu_plain, _ = fk.flow_forward_fused_ref(packed, mu, flow.embed([q[:, 0]]))
        check("converted transfer z_vs_plain", transferred[1],
              fk.flow_reverse_fused_ref(packed, nu_plain.repeat(BATCH, 1), emb), TOL["bf16"])

    timer = StepTimer()
    sampler = models["bfloat16"]
    for _ in range(2):
        timer.start()
        timer.stop(sampler.forward(x0, residual=residual))
    times = []
    for _ in range(REF_TIMED_RUNS):
        timer.start()
        times.append(timer.stop(sampler.forward(x0, residual=residual)))
    log(f"  [{card}] converted BAIR Model.forward bs={BATCH} T={EVAL_SEQ} bf16 by StepTimer: "
        f"median {statistics.median(times):.3f} ms over {REF_TIMED_RUNS} runs (EMA "
        f"{timer.ema_ms:.3f} ms), {BATCH * EVAL_SEQ / statistics.median(times) * 1e3:.1f} "
        f"frames/s")
    del models, sources, sampler, model, flow

    # the metric backbones: reference files -> the CLI's kinds -> the port's loaders
    src_dir, root = tmp / "reference_sources", tmp / "reference_models"
    src_dir.mkdir()
    modules = {}
    for kind, (name, _) in REF_BACKBONES.items():
        modules[kind] = testing.write_reference_backbone(
            kind, str(src_dir / name), seed=REF_BACKBONE_SEED,
            vgg_path=str(src_dir / "vgg16-397923af.pth"))
    # synthetic files cannot carry a published checksum: these three are
    # trusted on first use here, recorded in the temporary models/CHECKSUMS.json
    for name in ("fid", "lpips", "vgg16"):
        convert_weights.WEIGHTS[name] = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for kind, (name, dst) in REF_BACKBONES.items():
            argv = [kind, "--src", str(src_dir / name), "--dst", str(root / dst)]
            if kind == "lpips":
                argv += ["--vgg", str(src_dir / "vgg16-397923af.pth")]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                convert_weights.main(argv)
            log(f"  [{card}] convert_weights {kind}: {time.perf_counter() - t0:.2f} s")
    finally:
        os.chdir(cwd)

    clips = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 3, 64, 64)).astype(np.float32))
    frames = torch.from_numpy(rng.uniform(-1, 1, (10, 3, 64, 64)).astype(np.float32))
    pairs = frames.flip(0)
    with torch.no_grad():
        for kind, loader_kind in (("i3d", "kinetics"), ("dti3d16", "dt16")):
            loaded = fvd.load_model(loader_kind, str(root), device=DEVICE)
            direct = fvd.build(loader_kind)
            direct.load_state_dict({k: v for k, v in modules[kind].state_dict().items()
                                    if not k.startswith("conv3d_0c_1x1")
                                    or loader_kind == "kinetics"})
            direct = fvd.I3DModel(direct.to(DEVICE).eval(), loader_kind)
            v = fvd.prep_dt_time(clips, 16) if kind == "dti3d16" else clips
            check(f"{kind} activations_vs_source", torch.from_numpy(
                fvd.get_activations(loaded, v, 2)), torch.from_numpy(
                fvd.get_activations(direct, v, 2)), SOURCE_TOL)
        tf_module = fvd.build("kinetics")
        convert.load_checkpoint(tf_module, str(root / REF_BACKBONES["i3d_tf"][1]))
        tf_direct = fvd.I3DModel(modules["i3d_tf"].to(DEVICE), "kinetics")
        check("i3d_tf activations_vs_source", torch.from_numpy(fvd.get_activations(
            fvd.I3DModel(tf_module.to(DEVICE).eval(), "kinetics"), clips, 2)),
            torch.from_numpy(fvd.get_activations(tf_direct, clips, 2)), SOURCE_TOL)
        inception = fid.load_inception(str(root), device=DEVICE)
        check("fid activations_vs_source", torch.from_numpy(fid.get_activations(inception, frames)),
              torch.from_numpy(fid.get_activations(modules["fid"].to(DEVICE), frames)),
              SOURCE_TOL)
        lp = lpips_eval.load_lpips(str(root), device=DEVICE)
        x, y = frames.to(DEVICE), pairs.to(DEVICE)
        check("lpips distances_vs_source", lp(x, y), modules["lpips"].to(DEVICE)(x, y),
              SOURCE_TOL)
    del modules

    # AE.pretrained: the decoder from a synthesized ImageNet BigGAN checkpoint
    ae = dict(AE_MODELS["AE"], pretrained=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(REF_BIGGAN_SEED)
        file_tree = convert.subtree(stage1.variables(BigAE(ae)), "decoder_wrap",
                                     "decoder")
    weights_root = tmp / "reference_models"
    convert.save_reference(str(weights_root / "biggan" / "biggan_64.pth"),
                           convert.to_reference(convert.convert_biggan_generator, file_tree, 64))
    opt = ae_config(tmp, "", ae)
    t0 = time.perf_counter()
    ae_models = stage2_ae.build_models(opt, seed=0, weights_root=str(weights_root))
    fresh = stage2_ae.build_models(ae_config(tmp, "", AE_MODELS["AE"]), seed=0)
    got = ae_models.network.decoder_wrap.decoder.state_dict()
    init = fresh.network.decoder_wrap.decoder.state_dict()
    want = convert.to_state_dict(file_tree, fold_spectral=False)
    from_file = [k for k in got if not k.startswith("G_linear.") and not k.endswith(".v")]
    bad = [k for k in from_file if not torch.equal(got[k], want[k])]
    bad += [k for k in got if k not in from_file and not torch.equal(got[k], init[k])]
    log(f"  AE.pretrained: {len(from_file)} decoder tensors from biggan_64.pth, "
        f"{len(got) - len(from_file)} (G_linear, BigGAN's v) at the fresh init: "
        f"{'ok' if not bad else 'FAIL ' + str(bad[:5])}")
    if bad:
        raise AssertionError("AE.pretrained: the decoder is not the file's")
    tr = dict(opt.Training)
    ae_models.to(DEVICE)
    step = stage2_ae.AEStep(ae_models, stage2_ae.make_optimizers(ae_models, tr["lr"],
                                                                 tr["weight_decay"]), tr)
    img = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32)).to(DEVICE)
    metrics, _ = step(img, epoch=1)
    metrics = {k: float(v) for k, v in metrics.items()}
    finite = all(np.isfinite(v) for v in metrics.values())
    log(f"  [{card}] AE.pretrained: one AE step at bs 4 on {DEVICE} in "
        f"{time.perf_counter() - t0:.2f} s (with the build): Loss {metrics['Loss']:.6g}, "
        f"Loss_recon {metrics['Loss_recon']:.6g}, finite {'ok' if finite else 'FAIL'}")
    if not finite:
        raise AssertionError("AE.pretrained: a loss is not finite")
    return launches, device_launches


# phase 4i, stage-2 training from the posterior cache at the BAIR preset:
# phase 4d's splits and Training section with Data.aug off and
# Training.cache_posteriors on (100 clips of 30 frames: 1,400 windows of 17)
CACHE_CHECK_CLIPS = 6  # clips whose every window is encoded directly against its cache rows
# a cache row against the same encoder's direct forward of its window, over
# the rows' largest magnitude: cuDNN sums in another order at another batch
# (fp32, TF32 off), and in bf16 a rounding point moved by that order moves
# a layer's output by one bf16 step; CACHE_SEPARATION: the next clip's rows
# must differ from a clip's direct forward by at least this many times the
# bound, so that the check would see rows taken from another video (windows
# of one clip may be equal: the synthetic square stands still in some clips)
CACHE_ROW_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_SEPARATION = 3.0
# one cached step against one uncached step from the same flow, batch and
# draws: each loss term over the scale of the two terms (the NLL and the
# log-determinant; the loss is their difference), and the flow's weights
# after the step within two Adam steps (a first step moves a weight by lr
# times the sign of its gradient, which a rounding difference may flip) plus
# 1e-6 of the largest weight
CACHED_LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CACHED_SPANS = ("stage2/posterior_cache", "stage2/embedder", "stage2/flow", "stage2/optimizer")


def phase_train_cached(card: str, tmp: Path, weights_root: str):
    """Stage-2 training from cached posteriors at the full BAIR preset, over
    phase 4d's splits (its FrameStores reopened): the refusal with the
    augmentation on; the cache in fp32 and bf16 against the encoder's direct
    forward; one cached step against one uncached step; the trainer's
    ``train`` with ``cache_posteriors`` in its own counted window (one
    forward chain per validation batch, one reverse chain per prior-FVD
    batch and one more serving ``cINN_latest``); then the build's and the
    steps' times and the bytes each step copies from the host."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.config import Config
    from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.data.registry import augment_params
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import configs
    from image2video_synthesis_using_cinns_tpu_torch.train import optim, stage2
    from image2video_synthesis_using_cinns_tpu_torch.train.posterior_cache import (
        WindowIndex,
        build_cache,
        make_clip_reader,
    )
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert

    t0 = time.perf_counter()
    opt, config1, ae = configs(PRESET)
    opt.Training = Config(dict(TRAIN_CONFIG, save_path=str(tmp / "runs_cached"),
                               cache_posteriors=True))
    opt.Data = Config(dict(TRAIN_DATA, data_path=str(tmp / "bair_train") + "/", aug=False))
    opt.Logging = Config({"mode": "disabled"})
    tr = opt.Training
    T, img, z = opt.Data["sequence_length"], opt.Data["img_size"], config1.Decoder["z_dim"]
    ds = {mode: get_loader("BAIR")(opt, mode) for mode in ("train", "eval")}
    stores = {mode: FrameStore(str(tmp / f"train_{mode}.fst")) for mode in ds}  # phase 4d's
    lean = Loader(ds["train"], tr["bs"], workers=TRAIN_WORKERS, drop_last=False, seed=42,
                  framestore=stores["train"], frames_per_item=1, with_meta=True)
    full = Loader(ds["train"], tr["bs"], workers=TRAIN_WORKERS, drop_last=False, seed=42,
                  framestore=stores["train"], with_meta=True)
    eval_loader = Loader(ds["eval"], tr["bs_eval"], workers=TRAIN_WORKERS, drop_last=False,
                         seed=43, framestore=stores["eval"])
    models = stage2.build_models_from_configs(opt, config1, ae, seed=0)
    windex = WindowIndex(ds["train"], T)
    n_eval = len(eval_loader)
    log(f"  set-up {time.perf_counter() - t0:.2f} s: phase 4d's splits ({len(ds['train'])} and "
        f"{len(ds['eval'])} clips, {windex.n_windows} train windows of {T}), Data.aug off, "
        "full-size random models built")

    # -- the refusal -----------------------------------------------------------------
    opt_aug = copy.deepcopy(opt)
    opt_aug.Data["aug"] = True
    try:
        stage2.train(opt_aug, models, lean, eval_loader, device=DEVICE)
    except ValueError as e:
        log(f"  cache_posteriors with Data.aug on refused: ValueError({str(e)[:70]}...) ok")
    else:
        raise AssertionError("cached training: cache_posteriors with Data.aug on was not refused")

    # -- the cache against the encoder's direct forward ---------------------------------
    encoder = models.encoder.to(DEVICE).eval().requires_grad_(False)
    encoders = {"float32": encoder, "bfloat16": copy.deepcopy(encoder).to(torch.bfloat16)}
    params_aug, random_crop, _ = augment_params(opt, "train")
    aug = build_augment(img, params_aug, random_crop, False)  # what aug off trains on
    reader = make_clip_reader(ds["train"], stores["train"], TRAIN_WORKERS)
    caches, build_s = {}, {}
    for dt, enc in encoders.items():
        for _ in range(2):  # the first builds cuDNN's plans; the second is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caches[dt] = build_cache(enc, ds["train"], T, aug, reader,
                                     videos_per_dispatch=int(tr.get("cache_videos_per_dispatch",
                                                                    32)))
            torch.cuda.synchronize()
            build_s[dt] = time.perf_counter() - t0
        cache = caches[dt]
        log(f"  [{card}] build_cache {dt} encoder: {windex.n_windows} windows x 2 x {z} fp32 "
            f"({cache.numel() * 4 / 1e6:.3f} MB on the card) in {build_s[dt]:.3f} s, "
            f"{windex.n_windows / build_s[dt]:.1f} windows/s (the second of two builds)")
        errs, gaps, previous = [], [], None
        for v in range(CACHE_CHECK_CLIPS):
            clip = aug(torch.from_numpy(reader([v], BAIR_FRAMES)).to(DEVICE))[0]
            n_w = BAIR_FRAMES - T + 1
            wins = torch.stack([clip[s + 1:s + T] for s in range(n_w)]).permute(0, 4, 1, 2, 3)
            with torch.no_grad():
                direct = torch.stack(enc.moments(wins.to(next(enc.parameters()).dtype)), 1).float()
            rows = cache[windex.offsets[v]:windex.offsets[v + 1]]
            scale = float(direct.abs().max())
            errs.append(float((rows - direct).abs().max()) / scale)
            if previous is not None:  # this clip's rows against the previous clip's forward
                gaps.append(float((rows - previous).abs().flatten(1).amax(1).min()) / scale)
            previous = direct
        err, gap = max(errs), min(gaps)
        ok = err <= CACHE_ROW_TOL[dt] and gap >= CACHE_SEPARATION * CACHE_ROW_TOL[dt]
        log(f"  cache rows vs the {dt} encoder's direct forward, every window of "
            f"{CACHE_CHECK_CLIPS} clips ({n_w} a clip in one batch): worst over the rows' largest "
            f"{err:.3e} (bound {CACHE_ROW_TOL[dt]:g}); each row against the previous clip's "
            f"window at its start at least {gap:.3e} (must exceed {CACHE_SEPARATION:g} x the "
            f"bound) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cached training: the {dt} cache disagrees with the encoder")

    # -- one cached step against one uncached step ----------------------------------------
    fb, lb = first_batch(full), first_batch(lean)
    for key in ("index", "start"):
        if not np.array_equal(fb[key], lb[key]):
            raise AssertionError(f"cached training: the lean loader's {key} is not the full one's")
    if not np.array_equal(fb["seq_raw"][:, :1], lb["seq_raw"]):
        raise AssertionError("cached training: the lean loader's frame is not the window's first")
    n = lb["seq_raw"].shape[0]
    wids_np = windex.ids(ds["train"], lb["index"], lb["start"])
    seq = aug(torch.from_numpy(fb["seq_raw"]).to(DEVICE))
    seq1 = aug(torch.from_numpy(lb["seq_raw"]).to(DEVICE))
    cond = stage2.conditioning(seq1, None)
    wids = torch.from_numpy(wids_np).to(DEVICE)
    draws = stage2.Draws(7)
    eps = draws.normal("posterior", 0, 0, 0, (n, z))
    ref = draws.normal("reference", 0, 0, 0, (n, z))
    base = copy.deepcopy(models.network).to(DEVICE).eval()  # the trainer's run starts afresh
    base.embedder.requires_grad_(False)
    with torch.no_grad():
        base.init_actnorm(stage2.posterior(encoder, seq, draws.normal("actnorm", 0, 0, 0,
                                                                      (n, z))), cond)

    def fresh():
        net = copy.deepcopy(base)
        return net, optim.adam_torch(list(net.flow.parameters()), tr["lr"],
                                     betas=(tr["beta1"], tr["beta2"]),
                                     weight_decay=tr["weight_decay"], amsgrad=bool(tr["amsgrad"]))

    w0 = [p.detach().clone() for p in base.flow.parameters()]
    for dt, enc in encoders.items():
        mp = torch.bfloat16 if dt == "bfloat16" else None
        (net_u, opt_u), (net_c, opt_c) = fresh(), fresh()
        aux_u = stage2.train_step(net_u, opt_u, enc, seq, cond, eps, ref)
        aux_c = stage2.cached_train_step(net_c, opt_c, caches[dt], wids, cond, eps, ref, mp)
        scale = abs(float(aux_u["nll_loss"])) + abs(float(aux_u["nlogdet_loss"]))
        worst = max(abs(float(aux_c[k]) - float(aux_u[k])) / scale
                    for k in ("Loss", "nll_loss", "nlogdet_loss", "reference_nll_loss"))
        pu, pc = list(net_u.flow.parameters()), list(net_c.flow.parameters())
        w_err = max(float((a - b).detach().abs().max()) for a, b in zip(pc, pu))
        w_max = max(float(b.detach().abs().max()) for b in pu)
        w_bound = 2 * tr["lr"] + 1e-6 * w_max
        flipped = sum(int(((a - b).abs() > tr["lr"]).sum()) for a, b in zip(pc, pu))
        moved = sum(int((a != w).sum()) for a, w in zip(pu, w0))
        ok = worst <= CACHED_LOSS_TOL[dt] and w_err <= w_bound
        log(f"  cached step vs uncached step, {dt} encoder, bs={n}, the same flow, batch and "
            f"draws: Loss {float(aux_c['Loss']):.8g} vs {float(aux_u['Loss']):.8g}, worst term "
            f"over the terms' scale {worst:.3e} (bound {CACHED_LOSS_TOL[dt]:g}); the flow's "
            f"weights after the step {w_err:.3e} apart (bound 2 lr + 1e-6 max|w| = "
            f"{w_bound:.3e}; {flipped} of {moved} moved weights a step of opposite sign) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cached training: the {dt} cached step disagrees with the "
                                 "uncached one")
        del net_u, net_c, opt_u, opt_c

    # -- the trainer, in its counted window, and its checkpoint served -------------------------
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = stage2.train(opt, models, lean, eval_loader, device=DEVICE, weights_root=weights_root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    payload = checkpoint.load(str(Path(out["save_path"]) / "cINN_latest.msgpack"))
    serving_cfg = configs(PRESET)[0]
    server = Model.from_configs(serving_cfg, config1, ae, EVAL_SEQ, device=DEVICE, state_dicts={
        "decoder": models.decoder.state_dict(),
        "flow": convert.to_state_dict(payload["state_dict"])})
    x0 = seq1[:BATCH, 0].permute(0, 3, 1, 2).contiguous()
    residual = torch.randn((BATCH, z), generator=torch.Generator().manual_seed(5)).to(DEVICE)
    with torch.no_grad():
        video, z_served = server.sample(x0, residual=residual)
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  cached training and serving chain launches: {launches}; device kernels they "
        f"launched: {device_launches}")
    want = {"flow_reverse_fused": TRAIN_EPOCHS * n_eval + 1,
            "flow_forward_fused": TRAIN_EPOCHS * n_eval}
    if launches != want:
        raise AssertionError(f"cached training: chain launches {launches}, expected {want}")
    if device_launches != launches:
        raise AssertionError("cached training: a chain launched other than one device kernel")
    log(f"  [{card}] stage2.train cache_posteriors bair bs={tr['bs']} bs_eval={tr['bs_eval']}, "
        f"{TRAIN_EPOCHS} epochs of {len(lean)} steps with the cache build, the ActNorm init, "
        f"validation, prior FVD and checkpoints: {wall:.3f} s; {out['global_step']} steps; "
        f"train {out['train_loss']}, eval {out['eval_loss']}, PFVD {out['PFVD']}")
    values = [*out["train_loss"], *out["eval_loss"], out["PFVD"]]
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"cached training: a loss or the prior FVD is not finite: {values}")
    log("  every loss and the prior FVD finite")
    served = dict(server.flow.flow.named_parameters())
    for name, p in models.network.flow.named_parameters():
        if not torch.equal(served[name], p):
            raise AssertionError(f"cached training: the served {name} is not the trained one")
    log(f"  cINN_latest.msgpack (epoch {payload['epoch']}) in Model.from_configs: every flow "
        "weight equal to the trained one")
    check_video(f"cached training: served video bs={BATCH}", video,
                (BATCH, EVAL_SEQ, 3, img, img))
    with torch.no_grad():
        z_ref = fk.flow_reverse_fused_ref(server.flow.flow.packed, residual,
                                          server.flow.embed([x0]))
    check("cached training: served z vs plain", z_served, z_ref, TOL["bf16"])
    del server, payload, video

    # -- timings: the cached and the uncached step, with the batch's copy from the host -------
    # the four steps in turns (the order reversed every round), so that a drift of the
    # host's speed during the phase reaches each alike
    lean_np = np.ascontiguousarray(lb["seq_raw"])
    full_np = np.ascontiguousarray(fb["seq_raw"])
    variants = {}
    for dt, enc in encoders.items():
        mp = torch.bfloat16 if dt == "bfloat16" else None
        net_u, opt_u = fresh()
        net_c, opt_c = fresh()

        def uncached(enc=enc, net=net_u, o=opt_u):
            s = aug(torch.from_numpy(full_np).to(DEVICE))
            stage2.train_step(net, o, enc, s, stage2.conditioning(s, None), eps, ref)

        def cached(mp=mp, net=net_c, o=opt_c, moments=caches[dt]):
            s = aug(torch.from_numpy(lean_np).to(DEVICE))
            w = torch.from_numpy(wids_np).to(DEVICE)
            stage2.cached_train_step(net, o, moments, w, stage2.conditioning(s, None), eps, ref,
                                     mp)

        variants["uncached", dt], variants["cached", dt] = uncached, cached
        if dt == "float32":
            traced_net, traced_opt, traced_cache = net_c, opt_c, caches[dt]
    for fn in variants.values():
        fn()
        fn()
    torch.cuda.synchronize()
    lat = {k: [] for k in variants}
    for r in range(7):
        for k in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
            t0 = time.perf_counter()
            variants[k]()
            torch.cuda.synchronize()
            lat[k].append((time.perf_counter() - t0) * 1e3)
    for dt in encoders:
        u, c = statistics.median(lat["uncached", dt]), statistics.median(lat["cached", dt])
        wins = sum(a < b for a, b in zip(lat["cached", dt], lat["uncached", dt]))
        log(f"  [{card}] step bs={n} {dt} encoder, Data.aug off (copy from the host, augment, "
            f"posterior, embedder, flow forward and backward, Adam; median of 7 after 2 "
            f"warm-ups, the four steps in turns): uncached {u:.3f} ms, cached {c:.3f} ms "
            f"({u / c:.3f}x; the cached one faster in {wins} of 7 rounds); uncached "
            + " ".join(f"{v:.1f}" for v in lat["uncached", dt]) + ", cached "
            + " ".join(f"{v:.1f}" for v in lat["cached", dt]))
    log(f"  host-to-card bytes a step: uncached {full_np.nbytes} (uint8 clips "
        f"{tuple(full_np.shape)}), cached {lean_np.nbytes + wids_np.nbytes} (one frame "
        f"{tuple(lean_np.shape)} and {wids_np.size} int32 window ids): "
        f"{full_np.nbytes / (lean_np.nbytes + wids_np.nbytes):.2f}x fewer")
    for store in stores.values():
        store.close()

    def traced_step():  # phase_trace runs its calls under no_grad; a step needs autograd
        with torch.enable_grad():
            s = aug(torch.from_numpy(lean_np).to(DEVICE))
            stage2.cached_train_step(traced_net, traced_opt, traced_cache,
                                     torch.from_numpy(wids_np).to(DEVICE),
                                     stage2.conditioning(s, None), eps, ref)

    return launches, device_launches, traced_step


# phase 4j, data parallelism at the BAIR preset (parallel/): serving replicas
# in one process, and the trainers' mains in two processes on the one card
DP_BATCH = 7  # two replicas pad it to 8
DP_TOL = dict(rtol=1e-3, atol=1e-4)  # the JAX package's data-parallel bound, tests/test_parallel.py
DP_TIMED_RUNS = 7
PAR_RANKS = 2
PAR_ONE_BACKEND = "nccl"  # the one-process runs' group: NCCL initialises and reduces on the card
PAR_TIMEOUT = 900  # seconds for each spawned process
# two ranks against one process on the card, TF32 off, at the JAX package's
# two-process bound (tests/test_distributed.py): the logged losses, every
# trained weight and buffer (the running statistics and spectral vectors
# included) and, for stage 2, the averaged gradients of one step. In fp32 no
# fixed bound separates a fault from rounding: cuDNN and cuBLAS pick their
# algorithms by batch (25 rows a rank against 50), and Adam's first steps
# turn rounding on a near-zero gradient into a step of about lr either way
# (run at the configs' lr, a stage-1 spectral vector ended 8.7% apart). So
# stage 1 and the AE are held in fp64 (``testing.float64_training``, a whole
# run each), stage 2 by one step in fp64 (``par_step64``: its validation and
# prior FVD run the fp32 chain kernels), and the AE also by one step in fp64
# at lr 0 on a seeded batch (``par_ae_step64``). The AE's whole fp64 run
# took another first step in two ranks while the train augment's contrast
# summed each frame's mean in float: the card orders that sum by how many
# frames the batch holds, so a rank's 3 frames differed in the last bits
# from the same frames in the batch of 6, and the random networks amplify
# that (ROADMAP F12; the mean is now summed exactly, ``data/augment.py``).
# The averaged gradients are held against each tensor's largest, as phases
# 4d-4f hold the card's; the fp32 runs' differences are reported beside them
PAR_TOL = dict(rtol=1e-5, atol=1e-7)
PAR_STEP64_SEED = 4242
AUG_CHECK_BATCHES = 20  # seeded 6-clip batches whose rows are held against 3-clip halves
ADAM_EPS = 1e-8  # every trainer's Adam (train/optim.py)

def dp_close(key: str, got, want) -> None:
    """Log max |got - want|; raise unless allclose at ``DP_TOL``."""
    import torch

    err = max_err(got, want)
    ok = bool(torch.allclose(got.float(), want.float(), **DP_TOL))
    log(f"  {key}: max_abs_err={err:.3e} (rtol {DP_TOL['rtol']}, atol {DP_TOL['atol']}) ok={ok}")
    if not ok:
        raise AssertionError(f"data-parallel output differs from one device: {key}")


def phase_dp_serving(card: str):
    """``Model(data_parallel=...)`` at the full BAIR preset over every visible
    card and over two replicas on ``cuda:0`` (bs 7: the two-replica split pads
    one row), fp32 and bf16 decoder, in a counted window (one reverse chain a
    replica a call). Each replica's rows against one device's on the same
    padded block of rows, and the whole batch against one device's whole
    batch (in bf16 reported: cuDNN rounds the bf16 decoder differently at 4
    rows and at 7); one landscape transfer likewise; then the latency of two
    replicas beside one."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_mesh
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model

    p = PRESETS[PRESET]
    img = p["img_size"]
    rng = np.random.default_rng(777)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (DP_BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    meshes = {"every card": make_mesh(), "2 replicas on cuda:0": ["cuda:0", "cuda:0"]}
    log(f"  serving meshes: {{'every card': {[str(d) for d in meshes['every card']]}, "
        "'2 replicas on cuda:0': ['cuda:0', 'cuda:0']}")
    outs = {}
    for dt in ("float32", "bfloat16"):
        one = build_model(PRESET, vid_length=16, seed=0, compute_dtype=dt, device=DEVICE)
        dps = {name: build_model(PRESET, vid_length=16, seed=0, compute_dtype=dt,
                                 data_parallel=mesh) for name, mesh in meshes.items()}
        torch.cuda.synchronize()
        zero_counts()
        with torch.no_grad():
            got = {name: m.sample(x0) for name, m in dps.items()}  # nu from each model's seed
        torch.cuda.synchronize()
        launches, device_launches = dict(fk.launches), dict(fk.device_launches)
        want_n = sum(len(mesh) for mesh in meshes.values())
        log(f"  DP serving {dt} chain launches: {launches}; device kernels: {device_launches} "
            f"(expected {want_n} reverse: one a replica)")
        if launches != {"flow_reverse_fused": want_n, "flow_forward_fused": 0}:
            raise AssertionError(f"DP serving {dt}: chain launches {launches}")
        if device_launches != launches:
            raise AssertionError("DP serving: a chain launched other than one device kernel")
        outs[dt] = (launches, device_launches)
        with torch.no_grad():
            want = one.sample(x0)
            # one device on each replica's block of the padded batch, the same nu
            nu = one.draw_residual(DP_BATCH)
            blocks = {}
            for name, m in dps.items():
                n = len(m.mesh)
                pad = -DP_BATCH % n
                xp = torch.cat([x0, x0[-1:].expand(pad, -1, -1, -1)])
                nup = torch.cat([nu, nu[-1:].expand(pad, -1)])
                per = xp.shape[0] // n
                parts = [one.sample(xp[i * per:(i + 1) * per], residual=nup[i * per:(i + 1) * per])
                         for i in range(n)]
                blocks[name] = (m.sample(x0, residual=nu),
                                [torch.cat([p[k] for p in parts])[:DP_BATCH] for k in (0, 1)])
        for name, (vid, z) in got.items():
            check_video(f"DP {name} {dt}", vid, (DP_BATCH, 16, 3, img, img))
            (bv, bz), (wv, wz) = blocks[name]
            dp_close(f"DP {name} {dt} video, each replica vs one device on its rows", bv, wv)
            dp_close(f"DP {name} {dt} z, each replica vs one device on its rows", bz, wz)
            if dt == "float32":
                dp_close(f"DP {name} {dt} video vs one device", vid, want[0])
            else:
                log(f"  DP {name} {dt} video vs one device on all {DP_BATCH} rows: max_abs_err="
                    f"{max_err(vid, want[0]):.3e} (reported: bf16 rounds by batch size)")
            dp_close(f"DP {name} {dt} z vs one device", z, want[1])
        if dt == "bfloat16":
            dp2 = dps["2 replicas on cuda:0"]
            for label, model in (("one device", one), ("2 replicas on cuda:0", dp2)):
                ms = []
                with torch.no_grad():
                    for _ in range(DP_TIMED_RUNS + 1):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        model.forward(x0)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                log(f"  [{card}] Model.forward bair bs={DP_BATCH} T=16 bf16, {label}: median "
                    f"{statistics.median(ms[1:]):.3f} ms of {DP_TIMED_RUNS} (host-timed; two "
                    "replicas on one card share it: not a scaling result)")
        del one, dps, got

    # the landscape transfer: the query's pass once, the start frames split
    tp = PRESETS[TRANSFER_PRESET]
    timg = tp["img_size"]
    q = torch.from_numpy(rng.uniform(-1, 1, (1, QUERY_FRAMES, 3, timg, timg))
                         .astype(np.float32)).to(DEVICE)
    tx0 = torch.from_numpy(rng.uniform(-1, 1, (DP_BATCH, 3, timg, timg))
                           .astype(np.float32)).to(DEVICE)
    one = build_model(TRANSFER_PRESET, vid_length=16, seed=0, transfer=True, device=DEVICE)
    dp2 = build_model(TRANSFER_PRESET, vid_length=16, seed=0, transfer=True,
                      data_parallel=["cuda:0", "cuda:0"])
    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        vid, z = dp2.transfer_sample(q, tx0)
    torch.cuda.synchronize()
    t_launches, t_device = dict(fk.launches), dict(fk.device_launches)
    log(f"  DP transfer chain launches: {t_launches}; device kernels: {t_device} (expected 1 "
        "forward for the query, 2 reverse: one a replica)")
    if t_launches != {"flow_reverse_fused": 2, "flow_forward_fused": 1} or t_device != t_launches:
        raise AssertionError(f"DP transfer: chain launches {t_launches}, device {t_device}")
    with torch.no_grad():
        want = one.transfer_sample(q, tx0)
    check_video("DP transfer landscape float32", vid, (DP_BATCH, 16, 3, timg, timg))
    dp_close("DP transfer video vs one device", vid, want[0])
    dp_close("DP transfer z_ref vs one device", z, want[1])
    del one, dp2
    launches = {k: sum(o[0][k] for o in outs.values()) + t_launches[k] for k in t_launches}
    device_launches = {k: sum(o[1][k] for o in outs.values()) + t_device[k] for k in t_device}
    return launches, device_launches


SP_CASES = (("spatial 1x2", 1, 16), ("spatial 1x2", 6, 24), ("data x spatial 2x2", 7, 16))
SP_SETUPS = {"spatial 1x2": dict(data_parallel=["cuda:0"] * 2, spatial_shard=2),
             "data x spatial 2x2": dict(data_parallel=["cuda:0"] * 4, spatial_shard=2)}
SP_ROWS = {"spatial 1x2": 1, "data x spatial 2x2": 2}  # data rows: one reverse chain each
SP_BF16_MEAN_TOL = 2e-2  # test_torch_port_model.py::test_sample_draws_and_bf16_decoder's bound
SP_TIMED_RUNS = 7
TP_GRID = (2, 2)  # dryrun_multichip's grid on four entries: 2 data rows of 2 model devices
TP_F64_BATCH, TP_F32_BATCH, TP_TIMED_STEPS = 10, 50, 5


def _latency_ms(call, runs: int) -> float:
    """The median host time of ``runs`` calls after one warm-up, each ending
    in a synchronisation."""
    import torch

    ms = []
    with torch.no_grad():
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[1:])


def _joined(leaf, grad: bool = False):
    """A flow leaf whole: a tensor-parallel ``Split``'s shards joined."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.parallel import tp

    parts = list(leaf) if isinstance(leaf, tp.Split) else [leaf]
    ts = [(q.grad if grad else q).detach().to(parts[0].device) for q in parts]
    return torch.cat(ts, dim=leaf.dim) if isinstance(leaf, tp.Split) else ts[0]


def _flow_leaves(blocks: dict) -> dict:
    """``{name: leaf}`` of a ``blocks_dict()`` tree, whole or sharded."""
    out = {"loc": blocks["loc"], "scale": blocks["scale"]}
    for net, layers in blocks["coupling"].items():
        for li, (w, b) in enumerate(layers):
            out[f"{net}.l{li}.weight"], out[f"{net}.l{li}.bias"] = w, b
    return out


def phase_tp_spatial(card: str, one: dict, t_one):
    """Phase 4k (``one``: phase 4's fp32 and bf16 one-device models,
    ``t_one``: phase 4b's fp32 landscape transfer model, each left at 16
    frames): the width-sharded decoder and the tensor-parallel flow at
    the full BAIR preset, in one counted window: ``Model(data_parallel=...,
    spatial_shard=2)`` over two entries of ``cuda:0`` (one row of two: bs 1
    at 16 frames, bs 6 at 24) and over a 2 x 2 grid of four entries (bs 7),
    fp32 and bf16 decoder, one landscape transfer on a 1 x 2 grid, and
    ``testing.dryrun_multichip`` over four entries (its data-parallel
    sampling from the trained flow: one reverse chain a row). Checks: fp32
    against one device at ``DP_TOL``, bf16 within ``SP_BF16_MEAN_TOL`` mean abs
    of the one-device fp32 video; one chain a data row a call, each one device
    kernel. Then each setup's latency beside one device's at the same batch,
    one tensor-parallel stage-2 step against the one-device step in fp64 at
    bs 10 (``PAR_TOL``; gradients against each tensor's largest) and the fp32
    step at bs 50 timed beside the one-device step."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Encoder
    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.inn import (
        SupervisedTransformer)
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.parallel import tp
    from image2video_synthesis_using_cinns_tpu_torch.parallel.mesh import make_2d_mesh
    from image2video_synthesis_using_cinns_tpu_torch.testing import (PRESETS, build_model,
                                                                     configs, dryrun_multichip)
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2
    from image2video_synthesis_using_cinns_tpu_torch.train.optim import adam_torch

    p, tp_preset = PRESETS[PRESET], PRESETS[TRANSFER_PRESET]
    img, timg, z_dim = p["img_size"], tp_preset["img_size"], p["z_dim"]
    rng = np.random.default_rng(911)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (DP_BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    nu = torch.from_numpy(rng.standard_normal((DP_BATCH, z_dim)).astype(np.float32)).to(DEVICE)
    q = torch.from_numpy(rng.uniform(-1, 1, (1, QUERY_FRAMES, 3, timg, timg))
                         .astype(np.float32)).to(DEVICE)
    tx0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, timg, timg)).astype(np.float32)).to(DEVICE)
    dts = ("float32", "bfloat16")
    t0 = time.perf_counter()
    sharded = {(name, dt): build_model(PRESET, vid_length=16, seed=0, compute_dtype=dt, **kw)
               for name, kw in SP_SETUPS.items() for dt in dts}
    t_sp = build_model(TRANSFER_PRESET, vid_length=16, seed=0, transfer=True,
                       data_parallel=["cuda:0"] * 2, spatial_shard=2)
    grids = {name: [[str(d) for d in row] for row in sharded[(name, "float32")].spatial]
             for name in SP_SETUPS}
    log(f"  serving grids (rows of model devices): {grids}; models built in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    zero_counts()
    got = {}
    with torch.no_grad():
        for dt in dts:
            for name, b, t in SP_CASES:
                m = sharded[(name, dt)]
                m.vid_length = t
                got[(name, dt, b, t)] = m.sample(x0[:b], residual=nu[:b])
        got_t = t_sp.transfer_sample(q, tx0)
    t_dry = time.perf_counter()
    dry = dryrun_multichip(["cuda:0"] * (TP_GRID[0] * TP_GRID[1]), PRESET)
    torch.cuda.synchronize()
    t_dry = time.perf_counter() - t_dry
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    want_rev = len(dts) * sum(SP_ROWS[name] for name, _, _ in SP_CASES) + 1 + TP_GRID[0]
    log(f"  4k chain launches: {launches}; device kernels: {device_launches} (expected "
        f"{want_rev} reverse: one a data row a call, {TP_GRID[0]} of them dryrun_multichip's "
        "sampling from the tensor-parallel flow; 1 forward, the transfer's query)")
    if launches != {"flow_reverse_fused": want_rev, "flow_forward_fused": 1}:
        raise AssertionError(f"4k: chain launches {launches}")
    if device_launches != launches:
        raise AssertionError("4k: a chain launched other than one device kernel")
    log(f"  dryrun_multichip(['cuda:0'] * 4, {PRESET!r}) in {t_dry:.2f} s: grid {dry['mesh']}, "
        f"step {dry['metrics']}, padded eval {dry['padded_eval_gap']:.3g} and cached loss "
        f"{dry['cached_gap']:.3g} of their bounds, cached step {dry['cached_metrics']}, "
        f"sampled {dry['sample_shape']} finite, width-sharded decode "
        f"{dry['spatial_err']:.3e}, data x spatial {dry['dp_spatial_err']:.3e} (bound 2e-3)")

    with torch.no_grad():
        for name, b, t in SP_CASES:
            one["float32"].vid_length = t
            want = one["float32"].sample(x0[:b], residual=nu[:b])
            for dt in dts:
                vid, z = got[(name, dt, b, t)]
                check_video(f"{name} {dt} bs={b} T={t}", vid, (b, t, 3, img, img))
                if dt == "float32":
                    dp_close(f"{name} fp32 bs={b} T={t} video vs one device", vid, want[0])
                else:
                    mean = float((vid - want[0]).abs().mean())
                    ok = mean <= SP_BF16_MEAN_TOL
                    log(f"  {name} bf16 bs={b} T={t} video vs one device fp32: mean abs "
                        f"{mean:.3e} (bound {SP_BF16_MEAN_TOL}), max abs "
                        f"{max_err(vid, want[0]):.3e} ok={ok}")
                    if not ok:
                        raise AssertionError(f"{name} bf16: mean abs {mean:.3e}")
                dp_close(f"{name} {dt} bs={b} z vs one device", z, want[1])
        one["float32"].vid_length = 16
        want_t = t_one.transfer_sample(q, tx0)
    check_video(f"spatial 1x2 transfer {TRANSFER_PRESET} fp32", got_t[0],
                (BATCH, 16, 3, timg, timg))
    dp_close("spatial 1x2 transfer video vs one device", got_t[0], want_t[0])
    dp_close("spatial 1x2 transfer z_ref vs one device", got_t[1], want_t[1])
    del got, got_t, want, want_t

    for dt in dts:
        for name, b, t in SP_CASES:
            m, o = sharded[(name, dt)], one[dt]
            m.vid_length = o.vid_length = t
            ms = _latency_ms(lambda: m.forward(x0[:b]), SP_TIMED_RUNS)
            ms1 = _latency_ms(lambda: o.forward(x0[:b]), SP_TIMED_RUNS)
            log(f"  [{card}] Model.forward {PRESET} {dt} bs={b} T={t}: {name} median {ms:.3f} ms, "
                f"one device {ms1:.3f} ms ({ms / ms1:.3f}x; of {SP_TIMED_RUNS}, host-timed; the "
                "shards share one card: the split's cost, not a scaling result)")
    ms = _latency_ms(lambda: t_sp.transfer(q, tx0), SP_TIMED_RUNS)
    ms1 = _latency_ms(lambda: t_one.transfer(q, tx0), SP_TIMED_RUNS)
    log(f"  [{card}] Model.transfer {TRANSFER_PRESET} fp32 bs={BATCH} T=16: spatial 1x2 median "
        f"{ms:.3f} ms, one device {ms1:.3f} ms ({ms / ms1:.3f}x)")
    for m in one.values():
        m.vid_length = 16
    del sharded, t_sp
    gc.collect()
    torch.cuda.empty_cache()

    # one tensor-parallel stage-2 step against the one-device step
    s2, s1, ae = configs(PRESET)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(PAR_STEP64_SEED)
        encoder = Encoder.from_config(s1.Encoder)
        network = SupervisedTransformer.from_configs(s2, s1.Decoder, ae)
    grid = make_2d_mesh(*TP_GRID, ["cuda:0"] * (TP_GRID[0] * TP_GRID[1]))
    tr = TRAIN_CONFIG

    def setup(dtype, n: int):
        enc = copy.deepcopy(encoder).to(DEVICE, dtype).eval().requires_grad_(False)
        net = copy.deepcopy(network).to(DEVICE, dtype).eval()
        net.embedder.requires_grad_(False)
        r = np.random.default_rng(PAR_STEP64_SEED)
        seq = torch.from_numpy(r.uniform(-1, 1, (n, p["seq_length"], img, img, 3))
                               ).to(DEVICE, dtype)
        eps0, eps, ref = (torch.from_numpy(r.standard_normal((n, z_dim))).to(DEVICE, dtype)
                          for _ in range(3))
        cond = stage2.conditioning(seq, None)
        with torch.no_grad():
            post0 = enc(seq[:, 1:].permute(0, 4, 1, 2, 3), noise=eps0)[0].reshape(n, -1)
            post = enc(seq[:, 1:].permute(0, 4, 1, 2, 3), noise=eps)[0].reshape(n, -1)
        net.init_actnorm(post0, cond)
        tp_net = copy.deepcopy(net)
        tp_net.flow = tp.TensorParallelFlow(tp_net.flow, grid)
        return net, tp_net, post, cond, ref

    def adam(net):
        return adam_torch(list(net.flow.parameters()), tr["lr"], betas=(tr["beta1"], tr["beta2"]),
                          weight_decay=tr["weight_decay"], amsgrad=bool(tr["amsgrad"]))

    net, tp_net, post, cond, ref = setup(torch.float64, TP_F64_BATCH)
    aux1 = stage2._flow_step(net, adam(net), post, cond, ref)
    aux2 = stage2._flow_step(tp_net, adam(tp_net), post, cond, ref)
    share = {"loss": 0.0, "grad": 0.0, "flow": 0.0}
    worst = {}

    def used(group: str, name: str, a, b, over_largest: bool = False) -> None:
        d = (a.double() - b.double()).abs()
        scale = b.double().abs().max() if over_largest else b.double().abs()
        u = float((d / (PAR_TOL["atol"] + PAR_TOL["rtol"] * scale)).max())
        if u >= share[group]:
            share[group], worst[group] = u, name

    for k in aux1:
        used("loss", k, aux2[k].reshape(1), aux1[k].reshape(1))
    leaves1, leaves2 = _flow_leaves(net.flow.blocks_dict()), _flow_leaves(tp_net.flow.blocks_dict())
    for k, leaf in leaves1.items():
        used("grad", k, _joined(leaves2[k], grad=True), leaf.grad, over_largest=True)
        used("flow", k, _joined(leaves2[k]), leaf.detach())
    ok = max(share.values()) <= 1.0
    log(f"  tensor-parallel stage-2 step on a {TP_GRID[0]} x {TP_GRID[1]} grid vs one device, "
        f"fp64, bs {TP_F64_BATCH}: the largest share of the bound (rtol {PAR_TOL['rtol']}, atol "
        f"{PAR_TOL['atol']}; grad: of its tensor's largest) "
        + ", ".join(f"{g} {share[g]:.3g} ({worst.get(g)})" for g in share) + f" ok={ok}")
    if not ok:
        raise AssertionError(f"4k: the tensor-parallel fp64 step differs from one device: {share}")
    del net, tp_net, post, cond, ref

    net, tp_net, post, cond, ref = setup(torch.float32, TP_F32_BATCH)
    opts = {"one device": (net, adam(net)), f"tensor-parallel {TP_GRID[0]}x{TP_GRID[1]}":
            (tp_net, adam(tp_net))}
    times, first = {}, {}
    for label, (n_, o_) in opts.items():
        ms = []
        for i in range(TP_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = stage2._flow_step(n_, o_, post, cond, ref)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first[label] = {k: float(v) for k, v in aux.items()}
        times[label] = statistics.median(ms[1:])
    (l1, a1), (l2, a2) = first.items()
    log(f"  [{card}] stage-2 flow step fp32 bs {TP_F32_BATCH} (embedder, flow by autograd, "
        f"Adam): {l1} median {times[l1]:.3f} ms, {l2} {times[l2]:.3f} ms "
        f"({times[l2] / times[l1]:.3f}x; of {TP_TIMED_STEPS}, host-timed, four entries of one "
        f"card); first step's loss terms max abs gap "
        f"{max(abs(a1[k] - a2[k]) for k in a1):.3e} (reported)")
    del net, tp_net, opts, encoder, network
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_launches


def phase_pipeline(card: str, tmp: Path, weights_root: str):
    """The empty-disk pipeline drive (``cli/pipeline_drive.run_pipeline``)
    at the full BAIR preset with the drive's own defaults (steps, clips a
    split, batch) and phase 4c's random full-size backbones, in its own
    counted window: stage 1, the AE, the cINN from the directories they
    wrote, the generate and eval CLIs on the cINN's directory, ``Model``.
    Checks: every artifact (the drive asserts each where its consumer looks,
    and the GIF); one forward chain per validation batch of the cINN's run
    and one reverse chain per batch of the generate CLI, per eval batch and
    for the drive's ``Model``, each one device kernel, as counted beforehand
    from the drive's batches; the eval CLI's scores finite; then, outside
    the window, the flow that ``Model`` serves from the directory is the
    trained one bitwise, its video finite in [-1, 1] and z the plain
    chain's. Prints each stage's wall time."""
    import inspect
    import math
    import shutil

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.cli import pipeline_drive
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2

    defaults = {k: v.default for k, v in
                inspect.signature(pipeline_drive.run_pipeline).parameters.items()}
    n, bs, steps = defaults["n_videos"], defaults["bs"], defaults["steps"]
    T = PRESETS[PRESET]["seq_length"] - 1  # the drive's video length
    n_eval = math.ceil(n / bs)
    want = {"flow_reverse_fused": math.ceil(min(pipeline_drive.GT_FRAMES, n) / bs) + n_eval + 1,
            "flow_forward_fused": min(n_eval, 3)}  # validation stops after 3 under max_steps
    root = tmp / "pipeline"
    kept = {}
    build = stage2.build_models

    def keep(*a, **k):
        kept["models"] = build(*a, **k)
        return kept["models"]

    stage2.build_models = keep
    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = pipeline_drive.run_pipeline(str(root), preset=PRESET, device=DEVICE,
                                          weights_root=weights_root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stage2.build_models = build
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  [{card}] run_pipeline {PRESET}, {steps} steps, {n} clips a split, bs {bs}: "
        f"{wall:.2f} s; by stage (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["seconds"].items()))
    log(f"  pipeline chain launches: {launches}; device kernels they launched: "
        f"{device_launches}; expected {want}")
    if launches != want:
        raise AssertionError(f"pipeline: chain launches {launches}, expected {want}")
    if device_launches != launches:
        raise AssertionError("pipeline: a chain launched other than one device kernel")
    log(f"  artifacts: stage 1 {Path(out['stage1']).name}, AE {Path(out['ae']).name}, cINN "
        f"{Path(out['stage2']).name}, GIF {Path(out['gif']).stat().st_size} bytes, video "
        f"{out['video_shape']}")
    scores = out["eval"]
    expected = {"FID", "LPIPS"} | ({"DTFVD"} if T >= 16 else set()) | (
        {"FVD"} if n >= 16 else set())
    if set(scores) != expected or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"pipeline: eval CLI scores {scores}, expected finite {expected}")
    log(f"  eval CLI scores (random backbones; FVD needs 16 clips): {scores}")

    server = out["model"]  # the drive's Model(<the cINN's directory>/)
    served = dict(server.flow.flow.named_parameters())
    for name, p in kept["models"].network.flow.named_parameters():
        if not torch.equal(served[name], p.to(served[name].device)):
            raise AssertionError(f"pipeline: the served {name} is not the trained one")
    log("  Model(<the cINN's directory>/): every flow weight equal to the trained one")
    img, z = server.config_stage1.Data["img_size"], server.flow.flow.packed.C
    gen = torch.Generator().manual_seed(9)
    x0 = (torch.rand((BATCH, 3, img, img), generator=gen) * 2 - 1).to(DEVICE)
    residual = torch.randn((BATCH, z), generator=gen).to(DEVICE)
    with torch.no_grad():
        video, z_served = server.sample(x0, residual=residual)
        z_ref = fk.flow_reverse_fused_ref(server.flow.flow.packed, residual,
                                          server.flow.embed([x0]))
    check_video(f"pipeline: served video bs={BATCH}", video, (BATCH, T, 3, img, img))
    check("pipeline: served z vs plain", z_served, z_ref, TOL["bf16"])
    del server, out, kept, video
    shutil.rmtree(root)  # about 7 GB of checkpoints, most of them stage 1's
    return launches, device_launches


def par_configs(tmp: Path) -> dict:
    """The configs of the multi-process jobs (no ``distributed`` yet): stage 2
    at bs 50 on phase 4d's splits, chained to 4e's stage-1 run and 4f's AE,
    uncached with validation and prior FVD, and cached (its cache built one
    video a dispatch, so a shard's rows are the one-process rows); stage 1 at
    bs 10 on 4e's splits and the AE at bs 30 on 4f's splits, the
    discriminators open, at their configs' lr. One epoch each (2 steps). The
    FrameStores of those phases are linked where ``Data.framestore: auto``
    looks for them."""
    import os

    from image2video_synthesis_using_cinns_tpu_torch.config import Config
    from image2video_synthesis_using_cinns_tpu_torch.data import get_loader
    from image2video_synthesis_using_cinns_tpu_torch.testing import configs

    cls = get_loader("BAIR").__name__  # open_or_build's auto name: <data_path>/.framestore/<cls>_<mode>.fst
    for root, prefix in (("bair_train", "train"), ("bair_train_s1", "s1"),
                         ("bair_train_ae", "ae")):
        (tmp / root / ".framestore").mkdir(exist_ok=True)
        for mode in ("train", "eval"):
            for ext in ("", ".json"):
                link = tmp / root / ".framestore" / f"{cls}_{mode}.fst{ext}"
                if not link.exists():
                    os.symlink(tmp / f"{prefix}_{mode}.fst{ext}", link)
    s1_run = next((tmp / "runs_s1").glob("Stage1_*"))
    ae_run = next((tmp / "runs_ae").glob("Stage2_AE_*"))
    opt = configs(PRESET)[0]
    opt.Conditioning_Model = Config(dict(opt.Conditioning_Model, checkpoint_name="Encoder_stage2",
                                         model_path=str(ae_run.parent), model_name=ae_run.name))
    opt.First_stage_model = Config(dict(checkpoint_encoder="best_PFVD_ENC",
                                        checkpoint_decoder="best_PFVD_GEN",
                                        model_path=str(s1_run.parent), model_name=s1_run.name))
    opt.Training = Config(dict(TRAIN_CONFIG, n_epochs=1))
    opt.Data = Config(dict(TRAIN_DATA, data_path=str(tmp / "bair_train") + "/",
                           framestore="auto"))
    opt.Logging = Config({"mode": "disabled"})
    cached = Config(opt.to_dict())
    cached.Data["aug"] = False
    cached.Training.update(cache_posteriors=True, cache_videos_per_dispatch=1)
    s1 = s1_config(tmp, str(tmp / "bair_train_s1") + "/")
    s1.Training.update(n_epochs=1, pretrain=0)
    s1.Data["framestore"] = "auto"
    ae = ae_config(tmp, str(tmp / "bair_train_ae") + "/")
    ae.Training.update(n_epochs=1, pretrain=0)
    ae.Data["framestore"] = "auto"
    return {"stage2": opt, "stage2_cached": cached, "stage1": s1, "ae": ae}


# the jobs, in the order each process runs them; the fp64 runs (the held
# comparison) at smaller global batches and 2 steps, to keep the phase's time
PAR_JOBS = (dict(tag="stage2", name="stage2", record=True),
            dict(tag="stage2_cached", name="stage2_cached"),
            dict(tag="stage1", name="stage1"),
            dict(tag="stage1_fp64", name="stage1", fp64=True, max_steps=2,
                 training=dict(bs=4, bs_eval=4)),
            dict(tag="ae", name="ae"),
            dict(tag="ae_fp64", name="ae", fp64=True, max_steps=2, training=dict(bs=6),
                 record=True))


def par_step64(models, network, tr: dict, seq_len: int) -> dict:
    """One stage-2 step in fp64 from ``network`` (the run's flow as built) on
    this rank's rows of a seeded global batch of ``tr["bs"]`` clips, as the
    trainer takes its first step: the ActNorm init, the posterior, the flow's
    loss and backward, ``Adam`` (which averages the gradients over the ranks).
    Returns the global batch's loss terms (``loss/``), the gradients as Adam
    applied them (``grad/``) and the flow after the step (``flow64/``)."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2
    from image2video_synthesis_using_cinns_tpu_torch.train.optim import adam_torch

    f64 = torch.float64
    n, z, img = int(tr["bs"]), models.config1.Decoder["z_dim"], TRAIN_DATA["img_size"]
    rng = np.random.default_rng(PAR_STEP64_SEED)
    rows = distributed.host_batch_slice(n)
    seq = torch.from_numpy(rng.uniform(-1, 1, (n, seq_len, img, img, 3)))[rows].to(DEVICE)
    eps0, eps, ref = (torch.from_numpy(rng.standard_normal((n, z)))[rows].to(DEVICE)
                      for _ in range(3))
    net = copy.deepcopy(network).to(DEVICE, f64)
    net.embedder.requires_grad_(False)
    enc = copy.deepcopy(models.encoder).to(DEVICE, f64).eval()
    cond = stage2.conditioning(seq, None)

    def post(e):
        with torch.no_grad():
            return enc(seq[:, 1:].permute(0, 4, 1, 2, 3), noise=e)[0].reshape(seq.shape[0], -1)

    net.init_actnorm(post(eps0), cond)
    params = list(net.flow.named_parameters())
    optimizer = adam_torch([p for _, p in params], tr["lr"], betas=(tr["beta1"], tr["beta2"]),
                           weight_decay=tr["weight_decay"], amsgrad=bool(tr["amsgrad"]))
    aux = distributed.mean_scalars(stage2._flow_step(net, optimizer, post(eps), cond, ref))
    out = {f"loss/{k}": np.float64(v) for k, v in aux.items()}
    out.update({f"grad/{k}": p.grad.cpu().numpy() for k, p in params})
    out.update({f"flow64/{k}": v.cpu().numpy() for k, v in net.flow.state_dict().items()})
    return out


def par_ae_step64(models, tr: dict) -> dict:
    """One AE step in fp64 at lr 0 from ``models`` (the AE as built) on this
    rank's rows of a seeded global batch of ``tr["bs"]`` images, the gate
    open: the discriminator's ActNorm init, the forward, d_weight from the
    averaged colorize gradients, both optimizers (which average the
    gradients over the ranks; at lr 0 every later quantity is taken from the
    same weights in every process), the recompute (the BatchNorms' running
    statistics) and the spectral refresh. Returns the global batch's metrics
    (``loss/``), each optimizer's gradients as it applied them (``grad/``,
    keyed by their tensors' names in the run's weights: ``network/...``,
    ``disc/...``, ``logvar``) and the modules' state after the step
    (``state64/``)."""
    import copy

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models import layers
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed
    from image2video_synthesis_using_cinns_tpu_torch.train import stage2_ae

    n, img = int(tr["bs"]), AE_DATA["img_size"]
    rng = np.random.default_rng(PAR_STEP64_SEED)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3, img, img)))[distributed.host_batch_slice(n)]
    m = copy.deepcopy(models).to(DEVICE).to(torch.float64)
    x = x.to(DEVICE)
    layers.init_actnorm(m.disc, x)
    optimizers = stage2_ae.make_optimizers(m, 0.0, tr["weight_decay"])
    names = {id(p): f"{net_name}/{k}" for net_name, net in (("network", m.network),
                                                            ("disc", m.disc))
             for k, p in net.named_parameters()}
    names[id(m.logvar)] = "logvar"
    out = {}
    for o in optimizers:
        def step(o=o, apply=o.step):
            apply()
            for p in o.param_groups[0]["params"]:
                out[f"grad/{names[id(p)]}"] = p.grad.cpu().numpy()
        o.step = step
    metrics, _ = stage2_ae.AEStep(m, optimizers, tr)(x, 1)
    out.update({f"loss/{k}": np.float64(v)
                for k, v in distributed.mean_scalars(metrics).items()})
    for net_name, net in (("network", m.network), ("disc", m.disc)):
        out.update({f"state64/{net_name}/{k}": v.cpu().numpy()
                    for k, v in net.state_dict().items()})
    return out


def par_job(job: dict, config: str, out: Path, save: str | None, builds: dict) -> dict:
    """One trainer ``main`` on the card as ``job`` says (fp64 through
    ``testing.float64_training``, at most ``max_steps`` steps), its modules
    copied from this process's first build of them (``builds``, by
    trainer), its checkpoint writes recorded, not written: phases 4d-4f
    held the files to the JAX layout, and here only which rank writes
    matters. Returns the trained modules' digest beside the logged losses,
    each step's time, the job's wall time and the files written. Their
    weights and buffers (the posterior cache; for stage 2 also
    ``par_step64``'s) are saved to ``<out>/<tag>.npz`` where ``save`` is
    ``"file"`` (a spawned rank 0) and returned as ``arrays`` where it is
    ``"memory"`` (this process). With ``job["record"]`` and ``save``, every
    ``Adam`` step's gradients as it applied them (averaged over the ranks;
    fp32 copies), keyed ``<tensor>@<step>``, go beside them
    (``<out>/<tag>_grads.npz``, or ``grads``)."""
    import contextlib
    import copy
    import hashlib
    import shutil

    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch import config as cfg
    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed
    from image2video_synthesis_using_cinns_tpu_torch.testing import float64_training
    from image2video_synthesis_using_cinns_tpu_torch.train import stage1, stage1_step, stage2
    from image2video_synthesis_using_cinns_tpu_torch.train import optim, stage2_ae
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint as ckpt_io

    tag, name, fp64 = job["tag"], job["name"], job["fp64"]
    trainer = "stage2" if name.startswith("stage2") else name
    module = {"stage2": stage2, "stage1": stage1, "ae": stage2_ae}[trainer]
    kept, step_s, ckpts, grads = {}, [], [], {}
    t_job = time.perf_counter()

    def nets(m) -> dict:
        return ({"flow": m.network.flow} if name.startswith("stage2") else
                stage1.networks(m) if name == "stage1" else {"network": m.network, "disc": m.disc})

    def recorded(f):
        def step(self, *a, **k):
            r = f(self, *a, **k)
            names = {id(p): f"{n}/{key}" for n, net in nets(kept["models"]).items()
                     for key, p in net.named_parameters()}
            for g in self.param_groups:
                for p in g["params"]:
                    if p.grad is not None and id(p) in names:
                        n = sum(key.startswith(names[id(p)] + "@") for key in grads)
                        grads[f"{names[id(p)]}@{n}"] = p.grad.detach().float().cpu().numpy()
            return r
        return step

    def shared(f):  # under the fp64 cast: each job casts its own copy
        def build(*a, **k):
            if trainer not in builds:
                builds[trainer] = f(*a, **k)
            return copy.deepcopy(builds[trainer])
        return build

    def keep(f):
        def build(*a, **k):
            kept["models"] = f(*a, **k)
            return kept["models"]
        return build

    def timed(f):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = f(*a, **k)
            torch.cuda.synchronize()
            if k.get("train", True):  # the AE's eval step is the same call
                step_s.append(time.perf_counter() - t0)
            return r
        return call

    patches = [(module, "build_models", keep),
               (ckpt_io.AsyncWriter, "save_async",
                lambda f: lambda self, path, payload: ckpts.append(Path(path).name))]
    # the writes are recorded, not written: the payloads (host copies of the
    # weights and of the optimizers' moments, 4 GB an epoch for stage 1) are not built
    patches += {"stage1": [(stage1, "variables", lambda f: lambda module: {}),
                           (stage1, "optimizer_states", lambda f: lambda models, opts: {
                               n: {} for n in stage1.networks(models)})],
                "stage2": [(stage2, "network_variables", lambda f: lambda *a: {}),
                           (stage2, "optax_state", lambda f: lambda *a: {})],
                "ae": [(stage2_ae, "encoder_variables", lambda f: lambda models: {})]}[trainer]
    if name == "stage2_cached":
        for fn in ("build_cache", "assemble_cache_multiprocess"):
            patches.append((stage2, fn, lambda f: lambda *a, **k: kept.__setitem__(
                "cache", f(*a, **k)) or kept["cache"]))
    step_owner = {"stage1": (stage1_step.Stage1Step, "__call__"),
                  "ae": (stage2_ae.AEStep, "__call__")}.get(name)
    patches.append(step_owner + (timed,) if step_owner else
                   (stage2, "cached_train_step" if name == "stage2_cached" else "train_step",
                    timed))
    if job["record"] and save:
        patches.append((optim.Adam, "step", recorded))
    build = module.build_models
    module.build_models = shared(build)
    try:
        with float64_training(module) if fp64 else contextlib.nullcontext():
            saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
            for (obj, attr, wrap), (_, _, f) in zip(patches, saved):
                setattr(obj, attr, wrap(f))
            try:
                opt = cfg.load(config)
                kw = {} if name == "ae" else {"eval_fvd": job["eval_fvd"]}
                res = module.main(opt, max_steps=job["max_steps"], device=DEVICE, **kw)
            finally:
                for obj, attr, f in reversed(saved):
                    setattr(obj, attr, f)
    finally:
        module.build_models = build
    # every rank lists the runs' directory, then rank 0 removes its run
    runs = Path(res["save_path"]).parent
    written = sorted(p.name for p in runs.iterdir())
    distributed.barrier("chip_smoke-listed")
    if distributed.is_primary():
        shutil.rmtree(res["save_path"])
    m = kept["models"]
    arrays = {f"{n}/{k}": v.detach().cpu().numpy() for n, net in nets(m).items()
              for k, v in net.state_dict().items()}
    if name == "ae":
        arrays["logvar"] = m.logvar.detach().cpu().numpy()
    if "cache" in kept:
        arrays["cache"] = kept["cache"].cpu().numpy()
    if name == "stage2":  # from the flow as built
        arrays.update(par_step64(m, builds["stage2"].network, opt.Training,
                                 int(opt.Data["sequence_length"])))
    if name == "ae" and not fp64:  # from the AE as built
        arrays.update(par_ae_step64(builds["ae"], opt.Training))
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode() + np.ascontiguousarray(arrays[k]).tobytes())
    result = {}
    if save == "file":
        np.savez(out / f"{tag}.npz", **arrays)
        if grads:
            np.savez(out / f"{tag}_grads.npz", **grads)
    elif save == "memory":
        result = {"arrays": arrays, "grads": grads}
    del kept, arrays, grads
    keys = ("train_metrics", "eval_metrics") if name == "stage1" else ("train_loss", "eval_loss")
    vals = [list(res[k].values()) if isinstance(res[k], dict) else list(res[k]) for k in keys]
    return {**result, "train": [float(v) for v in vals[0]], "eval": [float(v) for v in vals[1]],
            "save_path": res["save_path"], "written": written, "checkpoints": ckpts,
            "step_s": step_s, "steps": res["global_step"], "digest": digest.hexdigest(),
            "wall_s": time.perf_counter() - t_job}


def par_run(spec: dict, rank: int) -> dict:
    """The spec's jobs back to back in this process as rank ``rank`` (one
    process group for all of them, joined by the first trainer), then one
    all-reduce on the card through the group's backend. Returns each job's
    result."""
    import os

    import torch
    import torch.distributed as dist

    from image2video_synthesis_using_cinns_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, cwd = Path(spec["out"]), os.getcwd()
    os.chdir(spec["tmp"])  # the trainers read their weights under ./models/ (phase 4c's)
    try:
        builds, result = {}, {}
        for job in spec["jobs"]:
            torch.cuda.reset_peak_memory_stats(DEVICE)
            result[job["tag"]] = par_job(job, job["configs"][rank], out,
                                         save=spec["save"] if rank == 0 else None, builds=builds)
            result[job["tag"]]["peak_gib"] = torch.cuda.max_memory_allocated(DEVICE) / 2**30
            # the job's models (often in reference cycles) and their cached blocks go back to
            # the card: three processes share it in phase 7
            gc.collect()
            torch.cuda.empty_cache()
        del builds
        result["world"] = distributed.world()
        result["backend"] = dist.get_backend()
        t = torch.full((4,), float(rank + 1), device=DEVICE)
        dist.all_reduce(t)  # on the card
        result["all_reduce"] = t.tolist()
        result["run_s"] = time.perf_counter() - t0
    finally:
        distributed.destroy()
        os.chdir(cwd)
    return result


def par_worker(spec_path: str, rank: int) -> int:
    """A process that phase 4j spawns: ``par_run``, its result to a file."""
    spec = json.loads(Path(spec_path).read_text())
    result = par_run(spec, rank)
    (Path(spec["out"]) / f"{spec['tag']}_rank{rank}.json").write_text(json.dumps(result))
    return 0


def par_spawn(spec: dict, n: int) -> list[subprocess.Popen]:
    """Start ``par_run`` in ``n`` processes of this script (``--par-rank``),
    each writing its output to ``<out>/<tag>_rank<r>.log`` (a pipe nobody
    reads while this process trains would stall them); ``par_collect``
    waits for them."""
    out = Path(spec["out"])
    path = out / f"{spec['tag']}.json"
    path.write_text(json.dumps(spec))
    procs = []
    for r in range(n):
        with open(out / f"{spec['tag']}_rank{r}.log", "w") as f:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "--par-rank", str(path), str(r)],
                                          stdout=f, stderr=subprocess.STDOUT))
    return procs


def par_collect(spec: dict, procs: list[subprocess.Popen]) -> list[dict]:
    """The results of ``par_spawn``'s processes, each waited for within
    ``PAR_TIMEOUT`` (from now); a failed or hung process fails the phase,
    and every process is ended before this returns or raises."""
    out = Path(spec["out"])
    try:
        for p in procs:
            p.wait(timeout=PAR_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            text = (out / f"{spec['tag']}_rank{r}.log").read_text()
            raise AssertionError(f"phase 7: {spec['tag']} rank {r} failed (exit "
                                 f"{p.returncode}):\n" + text[-6000:])
    return [json.loads((out / f"{spec['tag']}_rank{r}.json").read_text())
            for r in range(len(procs))]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_gap_source(w2: dict, w1: dict, g2: dict, g1: dict) -> str:
    """The weight of a job's arrays (two ranks ``w2``, one process ``w1``)
    with the largest two-rank gap, and at that element each run's gradient
    at each of its steps, on its own batches, as Adam applied it (``g2``,
    ``g1``: the runs' recorded gradients): the two values, their gap as a
    share of the larger, whether their signs agree, and the larger against
    the tensor's largest gradient and Adam's eps. Adam's first steps move a
    weight by about lr in the gradient's sign, so where the two runs'
    gradients are tiny beside their tensor's and of opposite sign, rounding
    can explain a gap of a few lr; where they are large, it cannot."""
    import numpy as np

    keys = [k for k in w1 if k.split("/")[0] not in ("loss", "grad", "flow64", "state64",
                                                     "cache")
            and k.rsplit(".", 1)[-1] not in ("u", "v", "mean", "var")]
    k = max(keys, key=lambda k: float(np.abs(w2[k].astype(np.float64) - w1[k]).max(
        initial=0)))
    d = np.abs(w2[k].astype(np.float64) - w1[k])
    idx = tuple(int(i) for i in np.unravel_index(int(np.argmax(d)), d.shape)) if d.ndim else ()
    steps = sorted(int(s.rsplit("@", 1)[1]) for s in g1 if s.rsplit("@", 1)[0] == k)
    if not steps:
        return f"largest gap {float(d.max()):.3e} in {k}{list(idx)}: no recorded gradient"
    parts = []
    for s in steps:
        a, b = g1[f"{k}@{s}"], g2[f"{k}@{s}"]
        x, y = float(a[idx]), float(b[idx])
        big = max(abs(x), abs(y))
        largest = float(max(np.abs(a).max(), np.abs(b).max()))
        parts.append(f"step {s}: one process {x:.3e}, two ranks {y:.3e} (gap "
                     f"{abs(x - y) / big if big else 0.0:.3e} of the larger, signs "
                     f"{'agree' if x * y > 0 else 'differ'}; the larger {big / largest:.3e} "
                     f"of the tensor's largest {largest:.3e}, {big / ADAM_EPS:.3e} x Adam's "
                     f"eps)")
    return (f"largest gap {float(d.max()):.3e} in {k}{list(idx)}; each run's gradient there "
            "on its own batches, as Adam applied it: " + "; ".join(parts))


def augment_rows_check(card: str) -> None:
    """F12 on the card: a rank's augmented rows are the whole batch's rows.
    For ``AUG_CHECK_BATCHES`` seeded batches of 6 clips (the AE's fp64 job's
    global batch) with the AE config's colour ops, each 3-clip half,
    augmented alone with its rows of the draws, must equal the same rows of
    the whole batch bitwise. Beside it, reported, the same with the contrast
    op's mean summed in fp32 (as before the repair), whose order the card
    picks by the batch's frame count."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.data import augment

    params, img = AE_DATA["Augmentation"], AE_DATA["img_size"]
    exact = augment._frame_mean
    differing = {}
    for label, mean in (("exact", exact),
                        ("fp32 sum", lambda g: g.mean(dim=(-3, -2, -1), keepdim=True))):
        augment._frame_mean = mean
        try:
            bad = 0
            for seed in range(AUG_CHECK_BATCHES):
                gen = torch.Generator().manual_seed(seed)
                raw = torch.randint(0, 256, (6, 1, img, img, 3), generator=gen,
                                    dtype=torch.uint8).to(DEVICE)
                draws = augment.draw_augment(6, params, False, gen)
                whole = augment.apply_augment(raw, img, params, False, draws)
                halves = torch.cat([augment.apply_augment(
                    raw[rows], img, params, False, {k: v[rows] for k, v in draws.items()})
                    for rows in (slice(0, 3), slice(3, 6))])
                bad += int((whole != halves).flatten(1).any(1).sum())
        finally:
            augment._frame_mean = exact
        differing[label] = bad
    n = 6 * AUG_CHECK_BATCHES
    log(f"  [{card}] train augment, rows of a 6-clip batch that differ from the same rows "
        f"augmented in 3-clip halves: {differing['exact']} of {n} with the exact contrast mean; "
        f"{differing['fp32 sum']} of {n} with an fp32 sum (reported: the fault F12 repaired)")
    if differing["exact"]:
        raise AssertionError("the train augment's rows depend on the batch they are in")


def phase_parallel_train(card: str, tmp: Path):
    """The trainers' mains (``PAR_JOBS``): in two spawned ranks of a gloo
    group (``Training.distributed`` mappings that differ in ``process_id``)
    on the one card and, at the same time, each once in this process, in a
    one-rank NCCL group. Checks: the ranks agree exactly; the fp64 runs and
    stage 2's fp64 step equal the one process's (``PAR_TOL``); the sharded
    posterior cache is the one process's bitwise; rank 0 alone wrote; the
    NCCL group reduces on the card. The fp32 runs' differences are reported.
    The three processes share the card, so each one's step times are its
    share of it, not its speed alone."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch import config as cfg

    augment_rows_check(card)
    out = tmp / "par"
    out.mkdir()
    t0 = time.perf_counter()
    opts = par_configs(tmp)

    def spec(tag: str, n: int, backend: str, save: str) -> dict:
        port = _free_port()
        jobs = []
        for job in PAR_JOBS:
            job_tag, name = job["tag"], job["name"]
            paths = []
            for r in range(n):
                o = cfg.Config(opts[name].to_dict())
                o.Training.update(job.get("training", {}))
                o.Training["save_path"] = str(out / f"{job_tag}_{tag}")
                o.Training["distributed"] = {"coordinator_address": f"localhost:{port}",
                                             "num_processes": n, "process_id": r,
                                             "backend": backend}
                paths.append(str(out / f"{job_tag}_{tag}_rank{r}.yaml"))
                cfg.save(o, paths[-1])
            jobs.append({"tag": job_tag, "name": name, "fp64": job.get("fp64", False),
                         "max_steps": job.get("max_steps"), "configs": paths,
                         "record": job.get("record", False),
                         "eval_fvd": name == "stage2"})
        return {"jobs": jobs, "tmp": str(tmp), "out": str(out / tag), "tag": tag,
                "save": save}

    one_spec = spec("one", 1, PAR_ONE_BACKEND, "memory")
    ranks_spec = spec("ranks", PAR_RANKS, "gloo", "file")
    for sp in (one_spec, ranks_spec):
        Path(sp["out"]).mkdir()
    log(f"  set-up {time.perf_counter() - t0:.2f} s; the configs' batch sizes global; jobs "
        f"{PAR_JOBS}")
    t0 = time.perf_counter()
    procs = par_spawn(ranks_spec, PAR_RANKS)
    try:
        one = par_run(one_spec, 0)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    log(f"  one process (this one, a one-rank group, beside the ranks): "
        f"{time.perf_counter() - t0:.2f} s; backend {one['backend']}, world {one['world']}, "
        f"all_reduce on the card {one['all_reduce']}")
    if one["backend"] != PAR_ONE_BACKEND or one["world"] != 1 or one["all_reduce"] != [1.0] * 4:
        raise AssertionError(f"the one-rank NCCL group: {one}")
    ranks = par_collect(ranks_spec, procs)
    log(f"  two ranks (spawned, a gloo group on the one card: NCCL refuses two ranks on one "
        f"GPU): their jobs {ranks[0]['run_s']:.2f} and {ranks[1]['run_s']:.2f} s, all done "
        f"{time.perf_counter() - t0:.2f} s after their start; backend {ranks[0]['backend']}, "
        f"all_reduce on the card {ranks[0]['all_reduce']}")
    if ranks[0]["world"] != PAR_RANKS or ranks[0]["all_reduce"] != [3.0] * 4:
        raise AssertionError(f"the gloo group: {ranks[0]}")

    def gap(a, b, over_largest: bool = False) -> tuple[float, float]:
        """The largest share of its ``PAR_TOL`` bound that an element of ``a``
        takes (with ``over_largest``, the bound of the tensor's largest), and
        the largest absolute gap; in fp64 on the card."""
        a = torch.from_numpy(np.asarray(a)).to(DEVICE, torch.float64)
        b = torch.from_numpy(np.asarray(b)).to(DEVICE, torch.float64)
        if not b.numel():
            return 0.0, 0.0
        d, b = (a - b).abs(), b.abs()
        scale = b.max() if over_largest else b
        return (float((d / (PAR_TOL["atol"] + PAR_TOL["rtol"] * scale)).max()),
                float(d.max()))

    errs = {}
    for job in PAR_JOBS:
        tag, fp64 = job["tag"], job.get("fp64", False)
        r0, r1, o = ranks[0][tag], ranks[1][tag], one[tag]
        log(f"  [{card}] {tag}: step s one process {[round(x, 4) for x in o['step_s']]}, rank "
            f"0 {[round(x, 4) for x in r0['step_s']]}, rank 1 "
            f"{[round(x, 4) for x in r1['step_s']]} (three processes share one card: not a "
            f"scaling result); the job's wall s one process {o['wall_s']:.2f}, ranks "
            f"{r0['wall_s']:.2f}, {r1['wall_s']:.2f}; peak GiB allocated one process "
            f"{o['peak_gib']:.2f}, ranks {r0['peak_gib']:.2f}, {r1['peak_gib']:.2f}")
        if (r0["train"], r0["eval"], r0["digest"]) != (r1["train"], r1["eval"], r1["digest"]):
            raise AssertionError(f"{tag}: the ranks differ (logs or weights)")
        run_dir = Path(r0["save_path"]).name
        if (r0["written"], r1["written"]) != ([run_dir], [run_dir]) or r1["checkpoints"] or (
                r0["checkpoints"] != o["checkpoints"]) or not r0["checkpoints"]:
            raise AssertionError(f"{tag}: files written {r0['written']} {r1['written']}, "
                                 f"checkpoints {r0['checkpoints']} {r1['checkpoints']}, one "
                                 f"process {o['checkpoints']}: expected rank 0's alone")
        if len(r0["train"]) != len(o["train"]) or not r0["train"] or o["steps"] != r0["steps"]:
            raise AssertionError(f"{tag}: logs of different length")
        got = np.asarray(r0["train"] + r0["eval"])
        want = np.asarray(o["train"] + o["eval"])
        if not np.isfinite(got).all():
            raise AssertionError(f"{tag}: a logged value is not finite: {got}")
        w2 = dict(np.load(Path(ranks_spec["out"]) / f"{tag}.npz"))
        w1 = o.pop("arrays")
        held = ["logs"] if fp64 else []
        e, absolute = {}, {}
        e["logs"], absolute["logs"] = gap(got, want)
        e["weights"] = e["state"] = absolute["weights"] = absolute["state"] = 0.0
        for k in w1:
            if k == "cache":
                if not np.array_equal(w2[k], w1[k]):
                    raise AssertionError(f"{tag}: the sharded cache differs from the one-process "
                                         f"cache (max {np.abs(w2[k] - w1[k]).max():.3e})")
                log(f"  {tag}: the sharded cache ({w1[k].shape}) equals the one-process cache "
                    "bitwise")
                continue
            step_group = k.split("/")[0] in ("loss", "grad", "flow64", "state64")
            group = k.split("/")[0] if step_group else (
                "state" if k.rsplit(".", 1)[-1] in ("u", "v", "mean", "var") else "weights")
            share, most = gap(w2[k], w1[k], over_largest=group == "grad")
            e[group] = max(e.get(group, 0.0), share)
            absolute[group] = max(absolute.get(group, 0.0), most)
            if fp64 or step_group:
                held.append(group)
        held = sorted(set(held))
        bad = [g for g in held if e[g] > 1.0]
        log(f"  {tag}: ranks agree exactly, rank 0 alone wrote ({len(r0['checkpoints'])} "
            f"checkpoints); two ranks vs one process, {'fp64' if fp64 else 'fp32'}, max abs "
            f"and the largest share of the bound (rtol {PAR_TOL['rtol']}, atol "
            f"{PAR_TOL['atol']}) an element takes (grad: of its tensor's largest): "
            + ", ".join(f"{g} {absolute[g]:.3e} ({e[g]:.3g})" for g in e)
            + f"; held: {held or 'none'}" + (" (the rest reported)" if held != sorted(e) else "")
            + (" ok" if not bad else " FAIL"))
        if job.get("record"):  # where the two runs' weights are furthest apart, and why
            g2 = dict(np.load(Path(ranks_spec["out"]) / f"{tag}_grads.npz"))
            log(f"  {tag}: " + par_gap_source(w2, w1, g2, o.pop("grads")))
        if bad:
            raise AssertionError(f"{tag}: two ranks differ from one process beyond PAR_TOL in "
                                 f"{bad}")
        errs[tag] = e
        del w1, w2
        for f in (f"{tag}.npz", f"{tag}_grads.npz"):
            (Path(ranks_spec["out"]) / f).unlink(missing_ok=True)
    return errs


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
        log("== 4h. the reference's checkpoints (BAIR preset, converted and served)")
        t0 = time.perf_counter()
        ref_launches, ref_device_launches = phase_reference(card, Path(tmp))
        log(f"  phase 4h took {time.perf_counter() - t0:.2f} s")
        log("== 4i. stage-2 training from cached posteriors (BAIR preset, 4d's splits)")
        t0 = time.perf_counter()
        c_launches, c_device_launches, cached_train_step = phase_train_cached(
            card, Path(tmp), str(Path(tmp) / "models"))
        log(f"  phase 4i took {time.perf_counter() - t0:.2f} s")
        log("== 4j. data parallelism (BAIR preset: serving replicas; the training processes "
            "run in phase 7)")
        t0 = time.perf_counter()
        dp_launches, dp_device_launches = phase_dp_serving(card)
        log(f"  DP serving took {time.perf_counter() - t0:.2f} s")
        log("== 4k. tensor parallelism and the width-sharded decoder (BAIR preset)")
        t0 = time.perf_counter()
        sp_launches, sp_device_launches = phase_tp_spatial(card, models, t_models["float32"])
        log(f"  phase 4k took {time.perf_counter() - t0:.2f} s")
        log("== 4l. the empty-disk pipeline (BAIR preset: stage 1, AE, cINN, CLIs, Model)")
        t0 = time.perf_counter()
        pl_launches, pl_device_launches = phase_pipeline(card, Path(tmp),
                                                         str(Path(tmp) / "models"))
        log(f"  phase 4l took {time.perf_counter() - t0:.2f} s")

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
        phase_trace(card, "stage-2 cached train step bs=50 fp32", cached_train_step,
                    "trace_train_cached_step.json", "no chain in a step", spans=CACHED_SPANS)
        phase_trace(card, "stage-1 train step bs=10 fp32", s1_train_step,
                    "trace_train_stage1_step.json", "no chain in a step", spans=S1_SPANS)
        phase_trace(card, "stage-2 AE train step bs=30 fp32", ae_train_step,
                    "trace_train_ae_step.json", "no chain in a step", spans=AE_SPANS)

        # the card to the training processes: this process's models go first
        del models, t_models, sampler, transfer, synthesis_step, train_step
        del cached_train_step, s1_train_step, ae_train_step
        gc.collect()
        torch.cuda.empty_cache()
        log("== 7. multi-process training (phase 4j's second half: BAIR preset, the trainers' "
            "mains in one process and in two ranks)")
        log(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card")
        t0 = time.perf_counter()
        phase_parallel_train(card, Path(tmp))
        log(f"  multi-process training took {time.perf_counter() - t0:.2f} s")

    # each kernel at the shape its path gives it, in that path's mode (bf16
    # weights): the reverse at the BAIR sampling path's B=6, E=64, the forward
    # at the transfer's one query, B=1, E=128; launches over all fifteen windows;
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
                         + s1_launches[name] + ae_launches[name] + ep_launches[name]
                         + ref_launches[name] + c_launches[name] + dp_launches[name]
                         + sp_launches[name] + pl_launches[name]),
            "device_launches": (device_launches[name] + t_device_launches[name]
                                + e_device_launches[name] + tr_device_launches[name]
                                + s1_device_launches[name] + ae_device_launches[name]
                                + ep_device_launches[name] + ref_device_launches[name]
                                + c_device_launches[name] + dp_device_launches[name]
                                + sp_device_launches[name] + pl_device_launches[name]),
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
    if sys.argv[1:2] == ["--par-rank"]:  # a process that phase 4j spawns
        sys.exit(par_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
