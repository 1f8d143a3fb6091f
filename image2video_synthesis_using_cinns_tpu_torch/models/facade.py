"""User-facing ``Model``: checkpoint directory in, videos out (port of
``models/facade.py``: sampling and motion transfer).

* Configs are chained: ``model_path/config_stage2.yaml`` -> its
  ``First_stage_model`` directory (``config_stage1.yaml``, decoder and, with
  ``transfer=True``, the dynamics encoder) and its ``Conditioning_Model``
  directory (``config_stage2_AE.yaml``, the frozen embedder, whose checkpoint
  is spliced into the cINN's variables).
* ``forward(x0, cond)``: draw nu ~ N(0, I), compute the start-frame
  embedding, run the flow inverse to z, decode, and extend autoregressively
  from the last frame until ``vid_length`` frames, truncated on the time
  axis.
* ``transfer(seq_query, x0)``: encode the query video's motion (the
  posterior mean of its frames after the first), run the flow forward to nu
  under the query's first frame, then the flow inverse under each new start
  frame, and decode as ``forward`` does.
* ``compute_dtype='bfloat16'`` runs the decoder in bf16; the encoder, the
  embedder and the flow stay fp32 (``use_kernel=True`` streams the flow's
  weights in bf16, as the JAX package's Pallas kernel does). Outputs are fp32.

* ``data_parallel``: one replica of the embedder, the packed flow and the
  decoder on each serving device
  (``parallel/mesh.py``: ``True`` is every visible card, a list names the
  devices, e.g. ``["cpu", "cpu"]``). ``sample`` draws nu for the whole batch
  first, so the noise does not depend on the device count, pads the batch to
  a device multiple by repeating its last row, runs each replica on its own
  block of rows (each launches its own chains; nothing in a replica's path
  waits on the host, so replicas on different cards overlap), and gathers
  the rows onto the first device, the pad dropped. ``transfer`` encodes the
  query and runs the forward chain once, on the first device, and splits
  the start frames.

* ``spatial_shard``: the decoder's width split over the ``model`` devices
  of each data row (``parallel/spatial.py``), which lowers the latency of a
  single video. ``True`` puts every visible card on the ``model`` axis, an
  int that many of the devices; beside ``data_parallel`` (then an int) the
  devices form the row-major ``(n_dp, n_sp)`` grid of
  ``parallel/mesh.py::make_2d_mesh`` (``data_parallel=["cpu"] * 2,
  spatial_shard=2`` is one row of two CPU devices).
  Each data row holds one flow replica and one decoder replica on its first
  device, with copies of the decoder on its other model devices; each chunk
  of 16 frames is decoded sharded and gathered on the row's first device
  before the extension takes its last frame. The JAX facade's
  ``ValueError``s hold: ``True`` beside ``data_parallel``, a size
  under 2, a size that does not divide the devices.

The boundary keeps the JAX facade's layout: x0 (B, C, H, W), videos
(B, T, C, H, W), in [-1, 1]. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card and without a device, they raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import config as cfg
from ..parallel import spatial
from ..parallel.mesh import make_2d_mesh, make_mesh, pad_to_multiple, replicate, shard_batch
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from ..utils.profiling import annotate
from .stage1.decoder import Generator
from .stage1.resnet3d import Encoder
from .stage2.inn import SupervisedTransformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _join(*parts: str) -> str:
    return os.path.join(*[p for p in parts if p])


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device asked for, or ``cuda`` when none was; raises rather than
    falling back to the CPU when there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=torch.float32)


@dataclass
class Replica:
    """The serving modules of one data row, on its first device; with
    ``spatial_shard``, ``peers`` are the decoder's copies on the row's model
    devices (the first is ``decoder``)."""

    decoder: Generator
    flow: SupervisedTransformer
    peers: list[Generator] | None = None


class Model:
    def __init__(self, model_path: str, vid_length: int, transfer: bool = False, seed: int = 0,
                 use_kernel: bool = True, allow_random_init: bool = False,
                 compute_dtype: str = "float32", device: str | torch.device | None = None,
                 data_parallel: bool | list = False, spatial_shard: bool | int = False):
        grid = _check_parallel(data_parallel, spatial_shard, device)
        config = cfg.load(_join(model_path, "config_stage2.yaml"))
        fs = config.First_stage_model
        path_stage1 = _join(fs["model_path"], fs["model_name"])
        config_stage1 = cfg.load(_join(path_stage1, "config_stage1.yaml"))
        cond_dic = config.Conditioning_Model
        ae_dir = _join(cond_dic["model_path"], cond_dic["model_name"])
        ae_cfg_path = _join(ae_dir, "config_stage2_AE.yaml")
        ae_cfg = cfg.load(ae_cfg_path).AE if os.path.exists(ae_cfg_path) else None

        dec_ckpt = ckpt_io.find(_join(path_stage1, fs["checkpoint_decoder"]))
        flow_ckpt = ckpt_io.find(_join(model_path, "cINN"))
        enc_ckpt = ckpt_io.find(_join(path_stage1, fs["checkpoint_encoder"])) if transfer else None
        missing = [n for n, c in (("decoder", dec_ckpt), ("cINN", flow_ckpt)) if c is None]
        if transfer and enc_ckpt is None:
            missing.append("encoder")
        if missing and not allow_random_init:
            raise FileNotFoundError(
                f"no checkpoint found for {', '.join(missing)}; pass allow_random_init=True "
                "to run with random weights"
            )

        def load_weights(decoder: Generator, flow: SupervisedTransformer,
                         encoder: Encoder | None) -> None:
            if dec_ckpt is not None:
                decoder.load_state_dict(convert.to_state_dict(_variables(dec_ckpt)))
            if enc_ckpt is not None:
                encoder.load_state_dict(convert.to_state_dict(_variables(enc_ckpt)))
            emb_ckpt = ckpt_io.find(_join(ae_dir, cond_dic.get("checkpoint_name", "")))
            if flow_ckpt is not None:
                flow_vars = _variables(flow_ckpt)
                if emb_ckpt is not None:
                    flow_vars = convert.splice(flow_vars, "embedder", _variables(emb_ckpt))
                flow.load_state_dict(convert.to_state_dict(flow_vars))
            elif emb_ckpt is not None:  # a random flow under the trained embedder, as in JAX
                emb_vars = {c: t.get("embedder", t) for c, t in _variables(emb_ckpt).items()
                            if isinstance(t, dict)}
                flow.embedder.load_state_dict(convert.to_state_dict(emb_vars))

        self._setup(config, config_stage1, ae_cfg, vid_length, transfer, seed, use_kernel,
                    compute_dtype, device, load_weights, grid)

    @classmethod
    def from_configs(cls, config, config_stage1, ae_cfg, vid_length: int, transfer: bool = False,
                     seed: int = 0, use_kernel: bool = True, compute_dtype: str = "float32",
                     device: str | torch.device | None = None,
                     state_dicts: dict | None = None, data_parallel: bool | list = False,
                     spatial_shard: bool | int = False) -> "Model":
        """A model built from configs held in memory (no checkpoint directory,
        no YAML reader needed), with random weights drawn from ``seed``, or
        the serving state dicts in ``state_dicts`` (``decoder``, ``flow``:
        the ``SupervisedTransformer`` with its embedder, ``encoder``)."""
        def load_weights(decoder, flow, encoder) -> None:
            for name, module in (("decoder", decoder), ("flow", flow), ("encoder", encoder)):
                if module is not None and name in state_dicts:
                    module.load_state_dict(state_dicts[name])

        grid = _check_parallel(data_parallel, spatial_shard, device)
        self = cls.__new__(cls)
        self._setup(config, config_stage1, ae_cfg, vid_length, transfer, seed, use_kernel,
                    compute_dtype, device, load_weights if state_dicts else None, grid)
        return self

    def _setup(self, config, config_stage1, ae_cfg, vid_length, transfer, seed, use_kernel,
               compute_dtype, device, load_weights, grid) -> None:
        self.config = config
        self.config_stage1 = config_stage1
        # the data-parallel devices (each row's first) and, with spatial_shard, the grid
        self.mesh = None if grid is None else [row[0] for row in grid]
        self.spatial = grid if grid is not None and len(grid[0]) > 1 else None
        self.device = self.mesh[0] if grid is not None else resolve_device(device)
        self.z_dim = config_stage1.Decoder["z_dim"]
        self.vid_length = vid_length
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute_dtype]

        # modules are built (and randomly initialised from ``seed``) on the CPU
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            decoder = Generator.from_config(config_stage1.Decoder)
            flow = SupervisedTransformer.from_configs(
                config, config_stage1.Decoder, ae_cfg, use_kernel=use_kernel
            )
            encoder = Encoder.from_config(config_stage1.Encoder) if transfer else None
        if load_weights is not None:
            load_weights(decoder, flow, encoder)
        if flow.flow.use_kernel:
            flow.flow.pack_kernel_weights()
        self.decoder = decoder.to(self.device, self.compute_dtype).eval()
        self.flow = flow.to(self.device).eval()
        self.encoder = None if encoder is None else encoder.to(self.device).eval()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        others = (self.mesh or [])[1:]  # the encoder runs once, on the first device
        self.replicas = [Replica(self.decoder, self.flow)] + [
            Replica(d, f) for d, f in zip(replicate(others, self.decoder),
                                          replicate(others, self.flow))]
        for rep, row in zip(self.replicas, self.spatial or []):
            rep.peers = [rep.decoder] + replicate(row[1:], rep.decoder)

    # ------------------------------------------------------------------
    def draw_residual(self, batch_size: int) -> torch.Tensor:
        """The next nu ~ N(0, I) of the model's generator: the stream ``forward``
        draws from when no ``residual`` is given."""
        return torch.randn((batch_size, self.z_dim), generator=self._generator,
                           device=self.device)

    def _render(self, rep: Replica, x0: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Decode z from x0 on ``rep`` (width-sharded over its peers, each
        chunk gathered) and extend autoregressively from the last frame to
        ``vid_length`` frames, truncated on the time axis: (B, T, C, H, W)."""
        dt = self.compute_dtype
        decoder = rep.decoder

        def decode(img):
            with annotate("model/decode"):
                return spatial.gather(decoder(img.to(dt), z.to(dt), rep.peers)).float()

        seq = decode(x0)  # (B, 3, T, H, W)
        n_repeats = max(0, -(-self.vid_length // decoder.base_frames) - 1)
        chunks = [seq]
        for _ in range(n_repeats):
            chunks.append(decode(chunks[-1][:, :, -1]))
        seq = torch.cat(chunks, dim=2)[:, :, : self.vid_length]
        return seq.permute(0, 2, 1, 3, 4).contiguous()

    def _on_replicas(self, run, *rows: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
        """``run(replica, *its rows)`` on each replica over its block of the
        batch ``rows`` (padded to the device multiple), every replica's work
        issued before any is gathered; the outputs' rows concatenated on the
        first device, the pad dropped."""
        if len(self.replicas) == 1:
            return run(self.replicas[0], *rows)
        b = rows[0].shape[0]
        padded, _ = pad_to_multiple(list(rows), len(self.mesh))
        outs = [run(rep, *shard) for rep, shard in zip(self.replicas,
                                                       shard_batch(self.mesh, padded))]
        return tuple(torch.cat([o[k].to(self.device) for o in outs])[:b]
                     for k in range(len(outs[0])))

    @torch.inference_mode()
    def sample(self, x_0, cond=None, residual=None) -> tuple[torch.Tensor, torch.Tensor]:
        """x_0: (B, C, H, W) in [-1, 1] -> (video (B, T, C, H, W), z (B, z_dim)).

        ``residual`` injects a recorded nu (fixed-seed parity tests); by
        default nu is drawn from the model's generator."""
        with annotate("model/sample"):
            x0 = _as_tensor(x_0, self.device)
            if residual is None:
                # the whole batch's, on the first device
                residual = self.draw_residual(x0.shape[0])
            residual = _as_tensor(residual, self.device)
            cond = None if cond is None else _as_tensor(cond, self.device)

            def run(rep: Replica, x0, residual, cond):
                conds = [x0] if cond is None else [x0, cond]
                z = rep.flow.reverse(residual, conds).reshape(x0.shape[0], -1)
                return self._render(rep, x0, z), z

            return self._on_replicas(run, x0, residual, cond)

    def forward(self, x_0, cond=None, residual=None) -> torch.Tensor:
        """x_0: (B, C, H, W) in [-1, 1] -> video (B, T, C, H, W) in [-1, 1]."""
        return self.sample(x_0, cond, residual)[0]

    def __call__(self, x_0, cond=None, residual=None) -> torch.Tensor:
        return self.forward(x_0, cond, residual)

    @torch.inference_mode()
    def transfer_sample(self, seq_query, x_0) -> tuple[torch.Tensor, torch.Tensor]:
        """seq_query: ONE query video (1, T, C, H, W); x_0: (N, C, H, W), both in
        [-1, 1] -> (video (N, T', C, H, W), z_ref (N, z_dim)).

        The query's motion is the encoder's posterior mean of its frames after
        the first, as in the JAX facade (its eps draw does not reach the
        video); the flow maps it to one nu under the query's first frame, and
        that nu is sampled under every start frame."""
        if self.encoder is None:
            raise RuntimeError("construct the Model with transfer=True")
        with annotate("model/transfer"):
            q = _as_tensor(seq_query, self.device)
            if q.dim() != 5 or q.shape[0] != 1:
                raise ValueError(
                    f"expected one query video (1, T, C, H, W), got {tuple(q.shape)}")
            x0 = _as_tensor(x_0, self.device)
            with annotate("model/encode"):
                _, mu, _ = self.encoder(q[:, 1:].permute(0, 2, 1, 3, 4), self._generator)
            nu, _ = self.flow(mu, [q[:, 0]])
            nu = nu.reshape(1, -1).repeat(x0.shape[0], 1)

            def run(rep: Replica, x0, nu):
                z_ref = rep.flow.reverse(nu, [x0]).reshape(x0.shape[0], -1)
                return self._render(rep, x0, z_ref), z_ref

            return self._on_replicas(run, x0, nu)

    def transfer(self, seq_query, x_0) -> torch.Tensor:
        """seq_query (1, T, C, H, W), x_0 (N, C, H, W) -> video (N, T', C, H, W)."""
        return self.transfer_sample(seq_query, x_0)[0]


def _check_parallel(data_parallel, spatial_shard, device) -> list[list[torch.device]] | None:
    """The serving grid that ``data_parallel`` and ``spatial_shard`` ask for,
    one row of ``model`` devices per data-parallel replica (None when both
    are off), with the JAX facade's checks (``facade.py:150-188``).
    ``data_parallel``: ``True`` every visible card, a list those devices.
    ``spatial_shard``: ``True`` every visible card on the ``model`` axis, an
    int that many of the devices. ``device``, when given, must name the
    grid's first device (``cuda`` names ``cuda:0``)."""
    if spatial_shard:
        if spatial_shard is True:
            if data_parallel:
                raise ValueError(
                    "composing data_parallel with spatial_shard needs an explicit spatial axis "
                    "size: pass spatial_shard=<int> (devices are split into a 2-D (data, model) "
                    "mesh)")
            devs = make_mesh()
            n_sp = len(devs)
        else:
            devs = (make_mesh(devices=list(data_parallel))
                    if isinstance(data_parallel, (list, tuple)) else make_mesh())
            n_sp = int(spatial_shard)
        if n_sp < 2 or len(devs) % n_sp:
            raise ValueError(f"spatial_shard={n_sp} must be >=2 and divide the device count "
                             f"({len(devs)})")
        grid = make_2d_mesh(len(devs) // n_sp if data_parallel else 1, n_sp, devs)
    elif not data_parallel:
        return None
    else:
        grid = [[d] for d in (make_mesh() if data_parallel is True
                              else make_mesh(devices=list(data_parallel)))]
    first = grid[0][0]
    if device is not None and torch.device(device) not in (first, torch.device(first.type)):
        raise ValueError(f"device {device} is not the first serving device {first} "
                         "(data_parallel=['cpu', 'cpu'] serves two replicas on the CPU)")
    return grid


def _variables(path: str) -> dict:
    return ckpt_io.variables(ckpt_io.load(path), path)
