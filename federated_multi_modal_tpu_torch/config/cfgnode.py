"""A small yacs-compatible configuration node.

The reference stack configures everything through yacs ``CfgNode`` trees
(Dassl ``get_cfg_default`` + ``train.py:83-160`` in the reference).  yacs is
not available in this environment, so this module provides a compatible
implementation covering the surface the framework uses: attribute access,
``clone``, ``freeze``/``defrost``, ``merge_from_file`` (YAML),
``merge_from_list`` and ``dump``.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List

import yaml

_IMMUTABLE = "__cfg_immutable__"


class CfgNode(dict):
    """Nested dict with attribute access and immutability toggles."""

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, _IMMUTABLE, False)
        init_dict = init_dict or {}
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        dict.__setitem__(self, name, value)

    # -- immutability --------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _IMMUTABLE)

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, _IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- cloning / merging ----------------------------------------------------
    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def _merge_dict(self, d: dict, prefix: str = "") -> None:
        for k, v in d.items():
            full = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                if k not in self:
                    self[k] = CfgNode()
                node = self[k]
                if not isinstance(node, CfgNode):
                    raise TypeError(f"Cannot merge dict into non-dict key {full}")
                node._merge_dict(v, full)
            else:
                self[k] = _coerce(v, self.get(k), full)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            node[leaf] = _coerce(value, node[leaf], key)

    # -- serialization ----------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def __str__(self) -> str:
        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.extend("  " + ln for ln in str(v).split("\n"))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        # Make CfgNode picklable despite the object-level immutability slot.
        return (_rebuild_cfgnode, (self.to_dict(), self.is_frozen()))


def _rebuild_cfgnode(d, frozen):
    node = CfgNode(d)
    if frozen:
        node.freeze()
    return node


def _decode_value(value: str) -> Any:
    """Parse a CLI-provided string into a Python literal when possible."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Loosely type-check a replacement value against the existing one."""
    if old is None or new is None:
        return new
    if isinstance(old, type(new)):
        return new
    # yacs-style casts
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, str) and isinstance(new, tuple):
        # e.g. "INPUT.SIZE: (224, 224)" parsed from YAML string default
        return new
    if isinstance(old, tuple) and isinstance(new, str):
        parsed = _decode_value(new)
        if isinstance(parsed, (tuple, list)):
            return tuple(parsed)
    if isinstance(old, (int, float)) and isinstance(new, str):
        # YAML 1.1 parses "1e-4" as a string; accept numeric-looking strings
        try:
            return type(old)(float(new))
        except ValueError:
            pass
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    raise ValueError(
        f"Type mismatch for key {key}: cannot replace {type(old).__name__} "
        f"with {type(new).__name__} ({new!r})"
    )
