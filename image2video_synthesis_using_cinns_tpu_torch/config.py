"""YAML config mapping with attribute access (port of ``config.py``).

Stages are chained through saved config files: ``config_stage2.yaml`` names
the stage-1 directory (``config_stage1.yaml``) and the conditioning AE
directory (``config_stage2_AE.yaml``). ``Config`` is a dict with recursive
attribute access. ``yaml`` is imported only by ``load``/``loads``, so a
machine without pyyaml can still build configs in memory.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Mapping


class Config(dict):
    """A dict with attribute access, recursively applied: ``cfg.Data['img_size']``
    and ``cfg.Data.img_size`` both work."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def load(path: str | os.PathLike | io.IOBase) -> Config:
    """Read a YAML config file (or open text stream)."""
    import yaml

    if hasattr(path, "read"):
        return Config(yaml.safe_load(path.read()) or {})
    with open(path, "r") as f:
        return Config(yaml.safe_load(f) or {})


def loads(text: str) -> Config:
    import yaml

    return Config(yaml.safe_load(text) or {})
