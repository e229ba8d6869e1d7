"""YAML config system with Hydra-group composition semantics.

The port's own copy of ``stil_tta_tpu/config/loader.py``: a top-level
algorithm config with a ``defaults`` list (``_self_`` + group entries
like ``models: resnet50``, ``dataset: dvm_...``), group files flattened
into the global namespace, and ``key=value`` dotted CLI overrides
(``dataset=X`` re-selects the group file). The YAMLs it composes are
copies under ``stil_tta_torch/config/configs``; tests hold the composed
result equal to the JAX package's.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Iterable, List, Optional

import yaml

DEFAULT_CONFIG_DIR = Path(__file__).parent / "configs"
GROUPS = ("models", "dataset")


class Config(dict):
    """dict with attribute access and deep-merge; missing keys -> None."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        return self.get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def merge(self, other: dict) -> "Config":
        for k, v in other.items():
            if (isinstance(v, dict) and isinstance(self.get(k), dict)):
                self[k] = Config._wrap(self[k]).merge(v)
            else:
                self[k] = Config._wrap(v)
        return self

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            if not isinstance(node.get(p), dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = Config._wrap(value)

    def copy(self) -> "Config":
        return Config._wrap(copy.deepcopy(dict(self)))

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self)


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _group_file(config_dir: Path, group: str, name: str) -> Path:
    # the dataset group also resolves the shifted-distribution subfolder
    for cand in (config_dir / group / f"{name}.yaml",
                 config_dir / group / "shifted_configs" / f"{name}.yaml"):
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"Config group '{group}' has no entry '{name}' under {config_dir}")


def parse_overrides(overrides: Iterable[str]) -> List[tuple]:
    parsed = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must look like key=value")
        key, raw = ov.split("=", 1)
        key = key.lstrip("+")
        value = yaml.safe_load(raw) if raw != "" else None
        parsed.append((key, value))
    return parsed


def load_config(config_name: str,
                overrides: Optional[Iterable[str]] = None,
                config_dir: Optional[os.PathLike] = None) -> Config:
    config_dir = Path(config_dir) if config_dir else DEFAULT_CONFIG_DIR
    name = config_name[:-5] if config_name.endswith(".yaml") else config_name
    raw = _load_yaml(config_dir / f"{name}.yaml")
    defaults = raw.pop("defaults", ["_self_"])
    parsed = parse_overrides(overrides or [])
    group_overrides = {k: v for k, v in parsed if k in GROUPS}

    cfg = Config()
    self_seen = False
    chosen_groups = {}
    for entry in defaults:
        if entry == "_self_":
            cfg.merge(raw)
            self_seen = True
            continue
        if not isinstance(entry, dict):
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
        (group, gname), = entry.items()
        gname = group_overrides.get(group, gname)
        chosen_groups[group] = gname
        cfg.merge(_load_yaml(_group_file(config_dir, group, str(gname))))
    if not self_seen:
        cfg.merge(raw)
    for group, gname in group_overrides.items():
        if group not in chosen_groups:
            cfg.merge(_load_yaml(_group_file(config_dir, group, str(gname))))
            chosen_groups[group] = gname
    for key, value in parsed:
        if key in GROUPS:
            continue
        cfg.set_dotted(key, value)
    cfg["config_name"] = name
    return cfg
