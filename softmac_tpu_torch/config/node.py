"""Minimal yacs-compatible configuration node.

The reference framework configures every scene through yacs ``CfgNode`` trees
(see reference ``softmac/config/default_config.py`` and ``softmac/config/utils.py``).
yacs is not available in this environment, so this module provides a small,
first-party implementation of the subset of the yacs API the framework uses:

- attribute and item access (``cfg.SIMULATOR.dt``)
- ``clone`` / ``freeze`` / ``defrost``
- ``merge_from_other_cfg`` / ``merge_from_file`` / ``merge_from_list``
- python-file configs that export a module-level ``cfg`` object

Config files are plain Python files exporting ``cfg`` (a ``ConfigNode``), the
same convention the reference uses for its demo configs.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Any

_VALID_SCALARS = (int, float, bool, str, type(None))


class ConfigNode(dict):
    """A dict with attribute access, freezing, and recursive merge."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    # -- conversion -------------------------------------------------------
    @classmethod
    def _convert(cls, value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, list):
            return [cls._convert(v) for v in value]
        if isinstance(value, tuple):
            return tuple(cls._convert(v) for v in value)
        return value

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name!r}")
        self[name] = self._convert(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {key!r}")
        super().__setitem__(key, self._convert(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- freeze / clone ------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, ConfigNode):
                        item.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, ConfigNode):
                        item.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.clone()
            elif isinstance(v, list):
                out[k] = [i.clone() if isinstance(i, ConfigNode) else i for i in v]
            elif isinstance(v, tuple):
                out[k] = tuple(i.clone() if isinstance(i, ConfigNode) else i for i in v)
            else:
                out[k] = v
        return out

    # -- merging ---------------------------------------------------------
    def merge_from_other_cfg(self, other: "ConfigNode" | dict) -> None:
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and isinstance(v, dict):
                self[k].merge_from_other_cfg(v)
            else:
                self[k] = self._convert(v)

    def merge_from_file(self, path: str | Path) -> None:
        other = _load_py_config(Path(path))
        self.merge_from_other_cfg(other)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, "merge_from_list expects key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] in node and isinstance(value, str):
                value = _coerce(value, node[parts[-1]])
            node[parts[-1]] = value

    # -- variant selection -----------------------------------------------
    def select_variant(self) -> "ConfigNode":
        """Recursively drop sibling sub-nodes not chosen by a ``TYPE`` key
        (the reference configs declare alternative blocks side by side and
        pick one by name). Returns self for chaining."""
        chosen = self.get("TYPE", None)
        for k in [k for k, v in self.items()
                  if isinstance(v, ConfigNode) and chosen is not None
                  and k != chosen]:
            del self[k]
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.select_variant()
        return self

    # -- pretty print ---------------------------------------------------------
    def __str__(self) -> str:
        return self._dump(0)

    __repr__ = __str__

    def _dump(self, indent: int) -> str:
        lines = []
        pad = "  " * indent
        for k, v in sorted(self.items()):
            if isinstance(v, ConfigNode):
                lines.append(f"{pad}{k}:")
                lines.append(v._dump(indent + 1))
            else:
                lines.append(f"{pad}{k}: {v!r}")
        return "\n".join(lines)


CN = ConfigNode


def _coerce(value: str, old: Any) -> Any:
    """Coerce a string literal from merge_from_list to the old value's type."""
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return value


_CONFIG_MODULE_COUNTER = 0


def _load_py_config(path: Path) -> ConfigNode:
    """Load a Python config file exporting a module-level ``cfg``."""
    global _CONFIG_MODULE_COUNTER
    _CONFIG_MODULE_COUNTER += 1
    name = f"_softmac_tpu_torch_cfg_{_CONFIG_MODULE_COUNTER}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(name, None)
    cfg = getattr(module, "cfg", None)
    if cfg is None:
        raise ValueError(f"config file {path} does not export `cfg`")
    if not isinstance(cfg, ConfigNode):
        cfg = ConfigNode(dict(cfg))
    return cfg


def load(path=None, opts=None) -> ConfigNode:
    """Build the runtime config: package defaults, overlaid with a python
    config file and dotted-key CLI opts, variant-selected, frozen."""
    from softmac_tpu_torch.config.default_config import get_cfg_defaults

    cfg = get_cfg_defaults()
    if path is not None:
        cfg.merge_from_file(path)
    if opts is not None:
        cfg.merge_from_list(opts)
    return cfg.select_variant().freeze()


def make_cls_config(owner, cfg=None, **kwargs) -> ConfigNode:
    """Instantiate ``owner.default_config()`` overlaid with an optional
    file/node and keyword overrides (the reference's per-class config
    idiom, softmac/config/utils.py)."""
    out = owner.default_config()
    if isinstance(cfg, (str, Path)):
        out.merge_from_file(cfg)
    elif cfg is not None:
        out.merge_from_other_cfg(cfg)
    if kwargs:
        out.merge_from_list([x for kv in kwargs.items() for x in kv])
    return out
