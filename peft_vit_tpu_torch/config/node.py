"""A minimal yacs-style config node (a copy of
``peft_vit_tpu/config/node.py``, so that a config means the same thing in
both packages).

Re-implements the configuration surface the reference uses
(``yacs.config.CfgNode``; see reference ``few_shot/vision_benchmark/config/
default.py:228-263``): attribute access, recursive YAML ``BASE`` inheritance,
``merge_from_list`` for CLI ``opts`` remainders, and freeze/defrost
discipline.  Written from scratch so the framework has no dependency on yacs.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml

_FROZEN = "__cfg_frozen__"
_NEW_ALLOWED = "__cfg_new_allowed__"


class CfgNode(dict):
    """Dict with attribute access, freezing, and YAML merging."""

    def __init__(self, init: Dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        object.__setattr__(self, _NEW_ALLOWED, new_allowed)
        if init:
            for k, v in init.items():
                self[k] = self._to_node(v, new_allowed)

    @classmethod
    def _to_node(cls, value: Any, new_allowed: bool = False) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value, new_allowed=new_allowed)
        return value

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        # yacs semantics: direct assignment may create keys; only *merging*
        # enforces new_allowed (checked in _merge).
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"CfgNode is frozen; cannot set {name!r} (call defrost())"
            )
        super().__setitem__(name, self._to_node(value))

    # -- freeze / defrost ---------------------------------------------------
    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, _FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode" | Dict) -> None:
        self._merge(dict(other))

    def _merge(self, other: Dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k]._merge(v)
            else:
                if k not in self and not object.__getattribute__(
                    self, _NEW_ALLOWED
                ):
                    raise KeyError(f"Non-existent config key: {k}")
                super().__setitem__(k, self._to_node(v))

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML file, honoring recursive ``BASE`` inheritance
        (reference few_shot config/default.py:228-241 semantics)."""
        with open(cfg_file) as f:
            loaded = yaml.safe_load(f) or {}
        _normalize_reference_layout(loaded)
        self._merge_with_base(loaded, cfg_file)

    def _merge_with_base(self, loaded: Dict, cfg_file: str) -> None:
        import os.path as op

        if "BASE" in loaded:
            bases = loaded["BASE"]
            if isinstance(bases, str):
                bases = [bases]
            for base in bases:
                if base:
                    self.merge_from_file(op.join(op.dirname(cfg_file), base))
            loaded = {k: v for k, v in loaded.items() if k != "BASE"}
        self._merge(loaded)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge ``[KEY, value, KEY, value, ...]`` CLI remainders."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf, None)
            node[leaf] = _coerce(value, old)

    # -- misc ----------------------------------------------------------------
    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_frozen(False)
        try:
            out = copy.deepcopy(self)
        finally:
            self._set_frozen(frozen)
        out._set_frozen(False)
        return out

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), sort_keys=True)


def _to_plain(node: Any) -> Any:
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    return node


def _coerce(value: Any, old: Any) -> Any:
    """Parse a CLI string to the type of the existing value."""
    if not isinstance(value, str):
        return value
    try:
        parsed = yaml.safe_load(value)
    except yaml.YAMLError:
        parsed = value
    if old is not None and isinstance(old, (tuple, list)) and isinstance(
        parsed, (tuple, list)
    ):
        return type(old)(parsed)
    return parsed


def _normalize_reference_layout(loaded) -> None:
    """Accept the reference's pre-refactor experiment-yaml layout.

    11 shipped full_shot experiment yamls (the hrnet_v3/v4 and two
    imagenet100/resnet families) nest the augmentation keys under
    ``INPUT.AUG`` while the reference's shipped config defines a
    top-level ``AUG`` (full_shot lib/config/default.py:85) and a strict
    ``INPUT`` with only MEAN/STD (:80-82) — those yamls cannot merge on
    the reference as released either (they predate its config refactor).
    Their intent is unambiguous, so fold ``INPUT.AUG`` into ``AUG``
    (explicit top-level AUG keys win) instead of failing."""
    if not isinstance(loaded, dict):
        return
    inp = loaded.get("INPUT")
    if isinstance(inp, dict) and isinstance(inp.get("AUG"), dict):
        aug = loaded.setdefault("AUG", {})
        for k, v in inp.pop("AUG").items():
            aug.setdefault(k, v)
        if not inp:
            loaded.pop("INPUT")
