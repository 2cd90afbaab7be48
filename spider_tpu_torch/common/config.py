"""Python-dict config system.

A copy of spider_tpu/common/config.py, which is framework-free. Configs are
plain Python files with three sections ``model / datasets / run`` in the
mmengine ``Config.fromfile`` style: a config file is a Python module whose
module-level names become config entries; dicts gain attribute access via
:class:`ConfigDict`.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
from typing import Any, Dict, Iterator, Mapping


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for key, value in list(self.items()):
            super().__setitem__(key, _wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "ConfigDict":
        return ConfigDict(self)

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return {k: unwrap(v) for k, v in self.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_wrap(v) for v in value)
    return value


class Config(ConfigDict):
    """Top-level config with ``fromfile`` mirroring mmengine's entry point."""

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(os.path.expanduser(path))
        if path.endswith(".json"):
            with open(path) as f:
                return cls(json.load(f))
        if not path.endswith(".py"):
            raise ValueError(f"Config file must be .py or .json, got {path}")
        spec = importlib.util.spec_from_file_location("_spider_tpu_config", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)  # type: ignore[union-attr]
        cfg = {
            k: v
            for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v) and not _is_module(v)
        }
        return cls(cfg)

    @classmethod
    def fromdict(cls, d: Mapping[str, Any]) -> "Config":
        return cls(dict(d))

    def merge(self, other: Mapping[str, Any]) -> "Config":
        merged = _deep_merge(self.to_dict(), dict(other))
        return Config(merged)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _is_module(v: Any) -> bool:
    import types

    return isinstance(v, types.ModuleType)


def _deep_merge(base: Dict, override: Mapping) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(dict(out[k]), v)
        else:
            out[k] = v
    return out


def parse_args(argv=None) -> argparse.Namespace:
    """CLI entry: a config path plus dotted overrides."""
    parser = argparse.ArgumentParser(description="spider-tpu training")
    parser.add_argument("cfg_path", help="path to configuration file")
    parser.add_argument("--options", nargs="*", default=[],
                        help="dotted key=value overrides, e.g. run.max_epoch=2")
    return parser.parse_args(argv)


def apply_overrides(cfg: Config, options) -> Config:
    """Apply ``a.b.c=value`` overrides (values parsed as Python literals)."""
    import ast

    for opt in options:
        key, _, raw = opt.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value
    return cfg
