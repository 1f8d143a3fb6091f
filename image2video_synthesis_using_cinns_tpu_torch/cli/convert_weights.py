"""Convert the reference framework's torch checkpoints into ``.msgpack``
checkpoints with the port alone (the kinds, flags, destinations and printed
lines of ``scripts/convert_weights.py``)::

    # a whole pretrained model directory: follows config_stage2.yaml and
    # converts the stage-1 decoder and encoder, the cINN and the AE embedder
    # in place, beside the .pth files
    python -m image2video_synthesis_using_cinns_tpu_torch.cli.convert_weights \
        model_dir --src ./torch_models/bair/stage2

    # metric backbones (docs/WEIGHTS.md)
    ... i3d     --src ./models/PI3D/model_rgb.pth
    ... dti3d16 --src ./models/DTI3D/length16/I3D_16.pth.tar
    ... dti3d32 --src ./models/DTI3D/length32/I3D_32.pth.tar
    ... fid     --src ./pt_inception-2015-12-05-6726825d.pth
    ... lpips   --src ./vgg.pth --vgg ./vgg16-397923af.pth
    ... i3d_tf  --src ./tf_i3d.npz     # the TF-hub I3D's variables

A backbone's source is integrity-checked first: against its published md5
or sha256 prefix, else against the md5 recorded in ``models/CHECKSUMS.json``
on first use (the record is written then). The written files are byte for
byte those of the JAX package's converter.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

from .. import config as cfg
from ..utils import checkpoint as ckpt_io
from ..utils import convert as C

CHECKSUMS = os.path.join("models", "CHECKSUMS.json")

# the published checksums of the sources this CLI checks (an md5, or the
# sha256 prefix in the file's name); the rest are trusted on first use
WEIGHTS = {
    "lpips": {"md5": "d507d7349b931f0638a25a48a722f98a"},
    "vgg16": {"sha256_prefix": "397923af"},
    "pi3d": {},
    "dti3d16": {},
    "dti3d32": {},
    "fid": {"sha256_prefix": "6726825d"},
    "i3d_tf_hub": {},
}
REGISTRY_NAME = {"i3d": "pi3d", "dti3d16": "dti3d16", "dti3d32": "dti3d32",
                 "fid": "fid", "lpips": "lpips", "i3d_tf": "i3d_tf_hub"}
DEFAULT_DST = {
    "i3d": "models/PI3D/model_rgb.msgpack",
    "dti3d16": "models/DTI3D/length16/I3D_16.msgpack",
    "dti3d32": "models/DTI3D/length32/I3D_32.msgpack",
    "fid": "models/FID/pt_inception.msgpack",
    "lpips": "models/lpips/vgg_lpips.msgpack",
}
KINDS = ["model_dir", "i3d", "i3d_tf", "dti3d16", "dti3d32", "fid", "lpips",
         "generator", "encoder", "disc_t", "disc_s", "cinn", "ae_encoder", "bigae"]


def _digest(path: str, algorithm: str) -> str:
    h = hashlib.new(algorithm)
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _recorded(root: str) -> dict:
    p = os.path.join(root, CHECKSUMS)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def verify(name: str, path: str, root: str = ".") -> str:
    """Check ``path`` against the registry entry ``name`` (and the md5 recorded
    on first use); returns the md5, raises ValueError on a mismatch."""
    spec = WEIGHTS[name]
    if spec.get("sha256_prefix"):
        digest = _digest(path, "sha256")
        if not digest.startswith(spec["sha256_prefix"]):
            raise ValueError(f"{name}: sha256 {digest[:8]}… does not match expected "
                             f"prefix {spec['sha256_prefix']} for {path}")
    digest = _digest(path, "md5")
    if spec.get("md5"):
        if digest != spec["md5"]:
            raise ValueError(f"{name}: md5 {digest} != expected {spec['md5']} for {path}")
    else:
        record = _recorded(root)
        if name not in record:
            record[name] = digest
            os.makedirs(os.path.dirname(os.path.join(root, CHECKSUMS)), exist_ok=True)
            with open(os.path.join(root, CHECKSUMS), "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
            print(f"{name}: no published checksum; recorded md5 {digest} "
                  f"(trust-on-first-use → {CHECKSUMS})")
        elif record[name] != digest:
            raise ValueError(
                f"{name}: md5 {digest} != previously recorded {record[name]} for {path}")
    print(f"{name}: integrity OK ({path})")
    return digest


def _join(*parts: str) -> str:
    return os.path.join(*[p for p in parts if p])


def convert_checkpoint_dir(stage2_dir: str) -> dict:
    """Convert every torch checkpoint that ``config_stage2.yaml`` reaches (the
    stage-1 decoder and encoder, ``cINN``, the AE embedder) into a
    ``.msgpack`` beside it; a stem that has one already is skipped. Returns
    ``{"written": [paths], "found": {stem: source}}``."""
    opt = cfg.load(_join(stage2_dir, "config_stage2.yaml"))
    fs, cond = opt.First_stage_model, opt.Conditioning_Model
    s1_dir = _join(fs["model_path"], fs["model_name"])
    cfg1 = cfg.load(_join(s1_dir, "config_stage1.yaml"))
    ae_dir = _join(cond["model_path"], cond["model_name"])
    written, found = [], {}

    def convert(base: str, fn) -> None:
        src = next((base + ext for ext in (".pth", ".pth.tar") if os.path.exists(base + ext)),
                   None)
        if src is None:
            return
        found[os.path.basename(base)] = src
        dst = base + ".msgpack"
        if not os.path.exists(dst):
            ckpt_io.save(dst, {"state_dict": fn(C.load_torch_state_dict(src))})
            written.append(dst)

    convert(_join(s1_dir, fs["checkpoint_decoder"]), C.convert_stage1_generator)
    if fs.get("checkpoint_encoder"):
        res_type = cfg1.Encoder.get("res_type_encoder", "resnet18")
        convert(_join(s1_dir, fs["checkpoint_encoder"]),
                lambda sd: C.convert_stage1_encoder(sd, res_type))
    control = bool(opt.Training.get("control", False))

    def cinn(sd: dict) -> dict:
        flow = C.convert_conditional_flow(
            sd, n_flows=opt.Flow["n_flows"], hidden_depth=opt.Flow["flow_hidden_depth"],
            in_channels=cfg1.Decoder["z_dim"],
            embedding_dim=cond["z_dim"] + (30 if control else 0), control=control)
        return {"params": {"flow": flow["params"]}, "buffers": {"flow": flow["buffers"]}}

    convert(_join(stage2_dir, "cINN"), cinn)
    ae_cfg = _join(ae_dir, "config_stage2_AE.yaml")
    if os.path.exists(ae_cfg):
        ae = cfg.load(ae_cfg).AE
        convert(_join(ae_dir, cond.get("checkpoint_name", "Encoder_stage2")),
                lambda sd: C.convert_resnet_encoder(sd, ae.get("encoder_type", "resnet50"),
                                                    ae.get("norm", "in")))
    return {"written": written, "found": found}


def _save(dst: str, variables: dict) -> None:
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    ckpt_io.save(dst, {"state_dict": variables})
    print("wrote", dst)


def _convert(args, sd: dict) -> dict:
    kind = args.kind
    if kind == "i3d":
        return C.convert_i3d_kinetics(sd)
    if kind in ("dti3d16", "dti3d32"):
        return C.convert_i3d_dt(sd)
    if kind == "fid":
        return C.convert_inception_fid(sd)
    if kind == "lpips":
        return C.convert_lpips(sd, C.load_torch_state_dict(args.vgg) if args.vgg else {})
    if kind == "generator":
        return C.convert_stage1_generator(sd)
    if kind == "encoder":
        return C.convert_stage1_encoder(sd)
    if kind == "disc_t":
        return C.convert_stage1_discriminator(sd)
    if kind == "disc_s":
        return C.convert_patch_discriminator(sd)
    if kind == "cinn":  # nested as the facade loads it; the embedder is spliced apart
        flow = C.convert_conditional_flow(sd, n_flows=args.n_flows, in_channels=args.z_dim,
                                          embedding_dim=args.embedding_dim, control=args.control)
        return {"params": {"flow": flow["params"]}, "buffers": {"flow": flow["buffers"]}}
    if kind == "ae_encoder":
        ae = (cfg.load(args.config).AE if args.config
              else {"encoder_type": "resnet50", "norm": "in"})
        return C.convert_resnet_encoder(sd, ae["encoder_type"], ae["norm"])
    return C.convert_bigae(sd, dict(cfg.load(args.config).AE))  # bigae


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=KINDS)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", default=None)
    p.add_argument("--vgg", default=None, help="torchvision vgg16 .pth (for lpips)")
    p.add_argument("--config", default=None, help="model config yaml when needed")
    p.add_argument("--n_flows", type=int, default=20)
    p.add_argument("--z_dim", type=int, default=64)
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    if args.kind == "model_dir":
        out = convert_checkpoint_dir(args.src)
        for w in out["written"]:
            print("wrote", w)
        if not out["written"]:
            print("nothing to convert (already converted or no .pth found)")
        return

    if args.kind in REGISTRY_NAME:
        verify(REGISTRY_NAME[args.kind], args.src)
    if args.kind == "lpips" and args.vgg:
        verify("vgg16", args.vgg)
    if args.kind == "i3d_tf":
        with np.load(args.src) as z:
            var_dict = {k: z[k] for k in z.files}
        _save(args.dst or "models/PI3D/model_rgb.msgpack", C.convert_i3d_tf_hub(var_dict))
        return
    sd = C.load_torch_state_dict(args.src)
    dst = args.dst or DEFAULT_DST.get(args.kind) or (os.path.splitext(args.src)[0] + ".msgpack")
    _save(dst, _convert(args, sd))


if __name__ == "__main__":
    main()
