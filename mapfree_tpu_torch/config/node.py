"""Minimal yacs-compatible config system.

The reference framework (map-free-reloc) builds its whole config surface on
``yacs.config.CfgNode`` (reference: config/default.py:1-116, config/utils.py:1-11).
This module re-implements the small subset of yacs semantics the reference relies
on, so the *exact same YAML files* load unmodified:

- attribute-style access (``cfg.DATASET.HEIGHT``)
- layered ``merge_from_file`` where later files override earlier values and
  unknown keys raise (acts as schema validation)
- ``merge_from_list`` for CLI overrides
- yacs value decoding: string values from YAML are passed through
  ``ast.literal_eval`` when possible, so ``SCENES: None`` in a YAML file becomes
  the Python ``None`` (plain YAML would keep it as the string ``"None"``)
- type coercion rules: a value may replace a default if the types match, if the
  default is ``None``, or for the (int, float) / (list, tuple) pairs.

No external dependency: only pyyaml, which is in the base image.
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-style merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        init_dict = {} if init_dict is None else init_dict
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            self[k] = v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- cloning ------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_file(self, cfg_filename) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        other = _decode_tree(loaded)
        _merge_a_into_b(other, self, key_path=[])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self, key_path=[])

    def merge_from_list(self, cfg_list: list) -> None:
        assert len(cfg_list) % 2 == 0, "override list must be key value pairs"
        for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            node = self
            parts = key.split(".")
            for sub in parts[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent key: {key}")
                node = node[sub]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent key: {key}")
            value = _decode_value(value)
            node[leaf] = _coerce_value(value, node[leaf], key)

    # -- dump ---------------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict())

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"


def _decode_tree(d: Any) -> Any:
    if isinstance(d, dict):
        return CfgNode({k: _decode_tree(v) for k, v in d.items()})
    return _decode_value(d)


def _decode_value(value: Any) -> Any:
    """yacs-style: try to literal_eval string values ('None' -> None etc.)."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce_value(replacement: Any, original: Any, full_key: str) -> Any:
    if original is None or replacement is None:
        return replacement
    if type(original) is type(replacement):
        return replacement
    # allowed casts, mirroring yacs _check_and_coerce_cfg_value_type
    casts = [(tuple, list), (list, tuple), (int, float), (float, int)]
    for src, dst in casts:
        if isinstance(replacement, src) and isinstance(original, dst):
            return dst(replacement)
    if isinstance(original, bool) and isinstance(replacement, int):
        return bool(replacement)
    raise ValueError(
        f"Type mismatch ({type(original).__name__} vs "
        f"{type(replacement).__name__}) for config key: {full_key}"
    )


def _merge_a_into_b(a: Any, b: CfgNode, key_path: list) -> None:
    for k, v_a in a.items():
        full_key = ".".join(key_path + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v_b = b[k]
        if isinstance(v_b, CfgNode) and isinstance(v_a, dict):
            _merge_a_into_b(v_a, v_b, key_path + [k])
        elif isinstance(v_b, CfgNode):
            raise ValueError(f"Cannot replace config node {full_key} with a leaf value")
        else:
            b[k] = _coerce_value(v_a, v_b, full_key)


def config_merge_from_file(cfg: CfgNode, path_to_config) -> CfgNode:
    """Merge one or several YAML files into cfg (later files override earlier).

    Mirrors reference config/utils.py:1-11.
    """
    if isinstance(path_to_config, (list, tuple)):
        for p in path_to_config:
            cfg.merge_from_file(p)
    else:
        cfg.merge_from_file(path_to_config)
    return cfg
