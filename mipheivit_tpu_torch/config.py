"""Run configs: a Hydra-compatible config tree without Hydra.

The port's own copy of ``mipheivit_tpu/config.py`` and of its YAML tree
(``configs/``: the composition root ``config.yaml`` with the groups
``data``/``train``/``model``, ``# @package _global_`` presets under
``default_configs/`` and ``experiments/``). ``compose`` resolves a run
config from ``+group=name`` / ``group=name`` / ``key.path=value`` /
``++key.path=value`` overrides, ``compose_multirun`` expands ``-m`` sweeps,
and ``save_config`` writes the resolved tree as the ``config.yaml`` beside
a run's checkpoints, which ``load_yaml`` reads back
(reference: run.py:16-42, src/train.py:175-176, run_inference.py:26).

``yaml`` is imported only where YAML is read (``load_yaml``, ``compose``),
so building a ``Config`` from a dict and writing it needs no PyYAML: the
tree holds only dicts, lists, str, int, float, bool and None, and
``to_yaml`` emits those itself.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

_CONFIG_ROOT = Path(__file__).parent / "configs"


class Config(dict):
    """A dict with attribute access and dotted get/set, like a tiny OmegaConf."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

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

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Dict[str, Any] = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = Config._wrap(value)

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def to_yaml(self) -> str:
        return "".join(line + "\n" for line in _yaml_lines(self.to_dict(), 0))


# --- a YAML emitter for the config tree (block mappings, flow in lists) ---

_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_\-]*\Z")
# words YAML 1.1 reads as booleans or null: never emitted as plain keys
_RESERVED = {"y", "n", "yes", "no", "on", "off", "true", "false", "null", "~"}


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text:      # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = text.split("e")
            mant = mant if "." in mant else mant + ".0"
            text = f"{mant}e{exp if exp[0] in '+-' else '+' + exp}"
        return text
    if isinstance(value, str):
        return json.dumps(value)     # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"config values are dicts, lists, str, int, float, bool or None; "
                    f"got {type(value).__name__}")


def _yaml_key(key: Any) -> str:
    if isinstance(key, str) and _PLAIN_KEY.match(key) and key.lower() not in _RESERVED:
        return key
    return _yaml_scalar(key)


def _yaml_flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_yaml_key(k)}: {_yaml_flow(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, list):
        return "[" + ", ".join(_yaml_flow(v) for v in value) + "]"
    return _yaml_scalar(value)


def _yaml_lines(tree: Dict[str, Any], indent: int) -> Iterable[str]:
    pad = " " * indent
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            yield f"{pad}{_yaml_key(key)}:"
            yield from _yaml_lines(value, indent + 2)
        elif isinstance(value, list) and value:
            yield f"{pad}{_yaml_key(key)}:"
            yield from (f"{pad}- {_yaml_flow(v)}" for v in value)
        else:
            yield f"{pad}{_yaml_key(key)}: {_yaml_flow(value)}"


# --- reading and composing ---


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = Config._wrap(copy.deepcopy(value))
    return dst


def _safe_load(text: str) -> Any:
    import yaml

    return yaml.safe_load(text)


def load_yaml(path: Union[str, Path]) -> Config:
    with open(path, "r") as f:
        data = _safe_load(f.read()) or {}
    return Config.create(data)


def save_config(cfg: Config, path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_yaml())


def _apply_group_file(cfg: Config, group_dir: Path, name: str, config_root: Path) -> None:
    """Merge one group config file.

    Files may carry a Hydra ``defaults`` list with ``override /group: name``
    entries (reference: configs/default_configs/miphei-vit.yaml:2-4); those
    are resolved first, then the body is merged. ``# @package _global_``
    files (``default_configs``/``experiments``) merge at the root; plain
    group files merge under their group key.
    """
    path = group_dir / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"No config '{name}' in group '{group_dir.name}' ({path})")
    text = path.read_text()
    body = Config.create(_safe_load(text) or {})
    at_global = "@package _global_" in text or group_dir.name in (
        "default_configs", "experiments") or group_dir.parent.name == "experiments"

    for entry in body.pop("defaults", None) or ():
        if isinstance(entry, dict):
            for key, val in entry.items():
                key = str(key)
                if key.startswith("override "):
                    key = key[len("override "):]
                key = key.strip().lstrip("/")
                if key == "_self_" or val is None:
                    continue
                _apply_group_file(cfg, config_root / key, str(val), config_root)
        # bare "_self_" strings are ordering hints; the body merges below anyway

    if at_global:
        _deep_merge(cfg, body)
    else:
        _deep_merge(cfg.setdefault(group_dir.name, Config()), body)


def _parse_value(text: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def compose(overrides: Iterable[str] = (), config_root: Union[str, Path, None] = None,
            config_name: str = "config") -> Config:
    """Compose the config like ``hydra.main`` would.

    Override forms (reference README.md:180-197):
      * ``+default_configs=miphei-vit``  -- merge a preset/experiment group file
      * ``+experiments/gan=full_gan``    -- nested groups
      * ``data=hemit``                   -- swap a defaults group
      * ``train.epochs=100`` / ``++train.epochs=100`` -- dotted value overrides
    """
    config_root = Path(config_root) if config_root else _CONFIG_ROOT
    raw = _safe_load((config_root / f"{config_name}.yaml").read_text()) or {}
    defaults = raw.pop("defaults", [])
    cfg = Config.create({})

    group_overrides: Dict[str, str] = {}
    file_merges: List[tuple] = []
    value_overrides: List[tuple] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        plus = ov.startswith("+") and not ov.startswith("++")
        force = ov.startswith("++")
        body_txt = ov.lstrip("+")
        if "=" not in body_txt:
            raise ValueError(f"Malformed override: {ov!r}")
        key, val = body_txt.split("=", 1)
        if plus and (config_root / key).is_dir():
            file_merges.append((key, val))
        elif not plus and not force and (config_root / key).is_dir() and "." not in key:
            group_overrides[key] = val
        else:
            value_overrides.append((key, val))

    for entry in defaults:
        if entry == "_self_":
            _deep_merge(cfg, Config.create(raw))
            continue
        if isinstance(entry, dict):
            for group, name in entry.items():
                if name is None:
                    continue
                name = group_overrides.pop(str(group), str(name))
                _apply_group_file(cfg, config_root / str(group), name, config_root)
    if "_self_" not in defaults:
        _deep_merge(cfg, Config.create(raw))
    for group, name in group_overrides.items():
        _apply_group_file(cfg, config_root / group, name, config_root)
    for group, name in file_merges:
        _apply_group_file(cfg, config_root / group, name, config_root)
    for key, val in value_overrides:
        cfg.set_dotted(key, _parse_value(val))
    return cfg


def _expand_sweep(val: str, group_dir: Optional[Path]) -> Optional[List[str]]:
    """Sweep variants for one override value, or None if it is not a sweep:
    ``glob(*)`` / ``glob(uni*)`` on a config-group override (every yaml of
    the group whose stem matches), or a comma list ``a,b,c``."""
    m = re.fullmatch(r"glob\((.*)\)", val.strip())
    if m:
        if group_dir is None:
            raise ValueError(f"glob() sweep requires a config-group override, got {val!r}")
        pat = m.group(1).strip() or "*"
        names = sorted(p.stem for p in group_dir.glob(pat + ".yaml"))
        if not names:
            raise FileNotFoundError(f"glob sweep {val!r} matched nothing in {group_dir}")
        return names
    if "," in val and not val.lstrip().startswith("["):
        return [v.strip() for v in val.split(",") if v.strip()]
    return None


def compose_multirun(overrides: Iterable[str] = (), config_root: Union[str, Path, None] = None,
                     config_name: str = "config") -> List[tuple]:
    """Expand ``-m`` sweep overrides into ``[(job_name, cfg), ...]``: the
    cartesian product over every sweep override, in order, as Hydra's basic
    sweeper runs it (reference: README.md:193-197). An invocation without a
    sweep is one job named "0"."""
    root = Path(config_root) if config_root else _CONFIG_ROOT
    slots: List[Union[str, List[tuple]]] = []
    has_sweep = False
    for ov in overrides:
        s = ov.strip()
        if not s:
            continue
        body = s.lstrip("+")
        prefix = s[: len(s) - len(body)]
        if "=" in body:
            key, val = body.split("=", 1)
            gd = root / key
            variants = _expand_sweep(val, gd if gd.is_dir() else None)
            if variants:
                has_sweep = True
                slots.append([(f"{prefix}{key}={v}", v) for v in variants])
                continue
        slots.append(s)
    if not has_sweep:
        return [("0", compose(list(overrides), config_root, config_name))]
    jobs = []
    for combo in itertools.product(*(slot for slot in slots if isinstance(slot, list))):
        it = iter(combo)
        ovs, names = [], []
        for slot in slots:
            if isinstance(slot, list):
                ov, name = next(it)
                ovs.append(ov)
                names.append(str(name))
            else:
                ovs.append(slot)
        jobs.append(("_".join(names), compose(ovs, config_root, config_name)))
    return jobs
