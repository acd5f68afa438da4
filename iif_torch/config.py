"""Config system: python-file configs with ``_base_`` inheritance and
deep-merge CLI overrides.

The port's own copy of ``iif_tpu/config.py`` (the port imports nothing of
the JAX package), so ``init_detector`` reads the shared ``configs/`` tree.
A config file is a plain python module whose top-level non-dunder names
become the config dict; ``_base_`` is a path or list of paths merged
bottom-up; ``_delete_=True`` in a dict replaces rather than merges (the
mmcv convention of the reference's configs).
"""
from __future__ import annotations

import ast
import copy
import importlib.util
import os
import types
from typing import Any, Dict, List, Optional

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class ConfigDict(dict):
    """A dict with attribute access (``cfg.model.backbone.depth``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _to_configdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        t = type(obj) if type(obj) in (list, tuple) else list
        return t(_to_configdict(v) for v in obj)
    return obj


def _load_py_module(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    modname = "_iif_cfg_" + os.path.splitext(os.path.basename(filename))[0]
    spec = importlib.util.spec_from_file_location(modname, filename)
    mod = importlib.util.module_from_spec(spec)
    # Keep module out of sys.modules to avoid name collisions between configs.
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    cfg = {
        k: v
        for k, v in vars(mod).items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v) or k == BASE_KEY
    }
    # callables defined in config files are allowed through if explicitly named
    cfg = {k: v for k, v in cfg.items()
           if not isinstance(v, types.ModuleType) and not k.startswith("__")}
    return cfg


def merge_dict(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins).

    A dict carrying ``_delete_: True`` replaces the base value wholesale
    (mmcv convention used throughout the reference's configs).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.pop(DELETE_KEY, False):
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """Loaded config with attribute access, ``_base_`` composition and
    ``merge_from_options`` (the `--cfg-options` path)."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        self._cfg = _to_configdict(cfg_dict or {})
        self._filename = filename

    # ------------------------------------------------------------------ load
    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        cfg_dict = _load_py_module(filename)
        base = cfg_dict.pop(BASE_KEY, None)
        if base is not None:
            if isinstance(base, str):
                base = [base]
            merged: Dict[str, Any] = {}
            cfg_dir = os.path.dirname(os.path.abspath(filename))
            for b in base:
                parent = cls.fromfile(os.path.join(cfg_dir, b))
                merged = merge_dict(merged, parent.to_dict())
            cfg_dict = merge_dict(merged, cfg_dict)
        return cls(cfg_dict, filename=filename)

    @classmethod
    def fromdict(cls, d: Dict[str, Any]) -> "Config":
        return cls(d)

    # ------------------------------------------------------------- accessors
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg))

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name: str) -> Any:
        return self._cfg[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg[name] = _to_configdict(value)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._cfg[name] = _to_configdict(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg.get(name, default)

    def setdefault(self, name: str, default: Any = None) -> Any:
        return self._cfg.setdefault(name, _to_configdict(default))

    def keys(self):
        return self._cfg.keys()

    # ------------------------------------------------------------- overrides
    def merge_from_options(self, options: Dict[str, Any]) -> None:
        """Deep-set dotted keys: ``{'model.backbone.depth': 101}``.

        Mirrors the reference's ``--cfg-options`` behaviour
        (``tools/train.py:56-65``): values are parsed as python literals
        when possible, ``a,b,c`` becomes a list.
        """
        for full_key, v in options.items():
            if isinstance(v, str):
                v = _parse_option_value(v)
            d = self._cfg
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, ConfigDict())
            d[keys[-1]] = _to_configdict(v)

    def dump(self, path: str) -> None:
        """Dump the resolved config as a python file (reference dumps the
        full config per run, ``tools/train.py:173``)."""
        with open(path, "w") as f:
            for k, v in self._cfg.items():
                f.write(f"{k} = {v!r}\n")

    def pretty_text(self) -> str:
        return "\n".join(f"{k} = {v!r}" for k, v in self._cfg.items())


def _parse_option_value(v: str) -> Any:
    # Bracketed python literals first, so nested values with commas
    # ("[(256,192)]", "dict(a=1,b=2)"-style tuples) survive intact;
    # bare "a,b,c" keeps the mmdet list convention.
    if v.lstrip().startswith(("[", "(", "{")):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    if "," in v:
        return [_parse_option_value(x) for x in v.split(",") if x != ""]
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        lowered = v.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return v


def parse_cfg_options(pairs: List[str]) -> Dict[str, Any]:
    """Parse ``KEY=VALUE`` strings from the CLI into an options dict."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError(f"--cfg-options entries must be KEY=VALUE, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k] = v
    return out
