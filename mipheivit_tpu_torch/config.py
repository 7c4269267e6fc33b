"""Run configs: the saved ``config.yaml`` of a checkpoint dir as a dict tree.

The port's own copy of the part of ``mipheivit_tpu/config.py`` that its
drivers read: ``Config`` (a dict with attribute access and dotted
``select``) and ``load_yaml``. ``yaml`` is imported only when a file
is loaded, so the chip path never needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union


class Config(dict):
    """A dict with attribute access, like a tiny OmegaConf."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def create(cls, data: Optional[Dict[str, Any]] = None) -> "Config":
        return cls._wrap(dict(data or {}))

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def load_yaml(path: Union[str, Path]) -> Config:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return Config.create(data)
