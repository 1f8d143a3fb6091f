"""Dataset registry (port of ``data/registry.py``): the dispatch surface of the
reference's ``data/get_dataloder.py`` (``get_loader`` / ``get_eval_loader``)."""

from __future__ import annotations

from . import datasets as D


def get_loader(name: str, control: bool = False):
    """The dataset *class* for a dataset name; each takes ``(opt, mode)``."""
    if name in ("BAIR", "bair"):
        return D.BairEndpointDataset if control else D.BairDataset
    if name in ("iper", "iPER"):
        return D.IperDataset
    if name in ("landscape", "Landscape"):
        return D.LandscapeDataset
    if name in ("DTDB", "dtdb"):
        return D.DTDBDataset
    raise NotImplementedError(
        f"Corresponding dataloader to dataset {name} not implemented"
    )


def augment_params(opt, mode: str):
    """(params dict, random_crop flag, train flag) for ``build_augment``; the
    train flag is ``mode == "train" and Data.aug``, as the reference gates
    its train-time augmentation."""
    ds = opt.Data["dataset"]
    random_crop = ds in ("landscape", "Landscape", "DTDB", "dtdb")
    train = mode == "train" and bool(opt.Data.get("aug", True))
    params = dict(opt.Data.get("Augmentation", {}) or {})
    return params, random_crop, train


def get_eval_loader(name: str, length: int, path: str, config, control: bool = False):
    """Build the test-mode dataset, mutating the config like the reference:
    ``sequence_length`` and ``data_path`` are overwritten in place."""
    config.Data["sequence_length"] = length
    config.Data["data_path"] = path

    if name in ("BAIR", "bair"):
        cls = D.BairEndpointDataset if control else D.BairDataset
        return cls(config, mode="test")
    if name in ("iper", "iPER"):
        return D.IperEvaluation(
            seq_length=length, img_size=config.Data["img_size"], path=path
        )
    if name in ("landscape", "Landscape"):
        return D.LandscapeDataset(config, mode="test")
    if name in ("DTDB", "dtdb"):
        return D.DTDBDataset(config, mode="test")
    raise NotImplementedError(
        f"Corresponding dataloader to dataset {name} not implemented"
    )
