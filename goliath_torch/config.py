"""Config system: YAML + interpolation + dotted overrides + class registry
(port of the JAX package's config.py, which needs neither numpy nor JAX:
copied as is apart from the class-name remap).

Configs are plain YAML with `${...}` interpolation (absolute `${a.b}`,
top-level `${name}`, and relative `${.sibling}`), merged with
`dotted.path=value` CLI overrides, and objects are instantiated from a
`class_name` key via importlib.

Class paths of the repo's other `goliath_*` package (the JAX reference)
and of the original code base (`ca_code.models.rgca.AutoEncoder`,
`torch.optim.Adam`) are remapped to their goliath_torch equivalents, so the
repo's config files work unmodified.
"""

from __future__ import annotations

import importlib
import re
from typing import Any, Callable, Dict, List, Mapping, Optional

import yaml


class Config(dict):
    """dict with attribute access, nested-path get/set, and deep merge."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def __delattr__(self, k: str) -> None:
        del self[k]

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping) and not isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Mapping):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def merge(self, other: Mapping) -> "Config":
        for k, v in other.items():
            if k in self and isinstance(self[k], Mapping) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = Config.wrap(v)
        return self

    def to_dict(self) -> Dict[str, Any]:
        def un(o: Any) -> Any:
            if isinstance(o, Mapping):
                return {k: un(v) for k, v in o.items()}
            if isinstance(o, list):
                return [un(v) for v in o]
            return o

        return un(self)


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _parse_scalar(s: str) -> Any:
    """YAML-parse a scalar string ('1e-4' -> float, 'true' -> bool, ...)."""
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if isinstance(v, str):
        try:  # YAML 1.1 misses '1e-4'-style floats (no dot in mantissa)
            return float(v)
        except ValueError:
            return v
    return v


def resolve_interpolations(cfg: Config) -> Config:
    """Resolve `${...}` references in-place (iterate until fixpoint)."""

    def resolve_str(s: str, parent_path: List[str]) -> Any:
        def lookup(expr: str) -> Any:
            if expr.startswith("."):
                # relative to the containing mapping
                node = cfg.get_path(".".join(parent_path)) if parent_path else cfg
                val = node.get_path(expr[1:]) if isinstance(node, Config) else None
                if val is not None:
                    return val
            return cfg.get_path(expr)

        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the referenced type
            return lookup(m.group(1))

        def sub(mm: "re.Match[str]") -> str:
            v = lookup(mm.group(1))
            return s if v is None else str(v)

        return _INTERP_RE.sub(sub, s)

    def walk(node: Any, path: List[str]) -> Any:
        if isinstance(node, Config):
            for k in list(node.keys()):
                node[k] = walk(node[k], path + [k])
            return node
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if isinstance(node, str) and "${" in node:
            new = resolve_str(node, path[:-1])
            return new if new is not None else node
        return node

    for _ in range(8):  # chained interpolations
        before = repr(cfg)
        walk(cfg, [])
        if repr(cfg) == before:
            break
    return cfg


_FLOAT_EXP_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _fix_yaml11_floats(node: Any) -> Any:
    """YAML 1.1 parses '1e1' as a string; convert exponent-style floats.

    Only strings with an explicit exponent are converted, so quoted ids like
    "400870" stay strings.
    """
    if isinstance(node, Mapping):
        return Config({k: _fix_yaml11_floats(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_fix_yaml11_floats(v) for v in node]
    if isinstance(node, str) and _FLOAT_EXP_RE.match(node):
        return float(node)
    return node


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML config, apply `a.b=value` overrides, resolve `${...}`."""
    with open(path, "r") as f:
        cfg = _fix_yaml11_floats(Config.wrap(yaml.safe_load(f) or {}))
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be dotted.path=value, got {ov!r}")
        key, val = ov.split("=", 1)
        cfg.set_path(key.strip(), Config.wrap(_parse_scalar(val)))
    return resolve_interpolations(cfg)


# ---------------------------------------------------------------------------
# class registry / object instantiation (module_loader.py equivalent)
# ---------------------------------------------------------------------------

# config compatibility: ca_code paths, and every other goliath_* package
# (the JAX reference beside this one), map onto goliath_torch
_CLASS_ALIASES = {
    "ca_code.models": "goliath_torch.models",
    "ca_code.loss": "goliath_torch.losses",
    "ca_code.nn": "goliath_torch.nn",
    "ca_code.utils": "goliath_torch.utils",
    "torch.optim.Adam": "goliath_torch.optim.Adam",
    "torch.optim.AdamW": "goliath_torch.optim.AdamW",
}


def _remap(class_name: str) -> str:
    for old, new in _CLASS_ALIASES.items():
        if class_name == old or class_name.startswith(old + "."):
            return new + class_name[len(old):]
    pkg, dot, rest = class_name.partition(".")
    if pkg.startswith("goliath_") and dot:
        return "goliath_torch." + rest
    return class_name


def load_class(class_name: str) -> Any:
    """Import `pkg.module.ClassName` and return the class object."""
    class_name = _remap(class_name)
    module_name, cname = class_name.rsplit(".", 1)
    module = importlib.import_module(module_name)
    return getattr(module, cname)


def load_from_config(cfg: Mapping, **kwargs: Any) -> Any:
    """Instantiate cfg.class_name with the remaining keys as kwargs."""
    assert "class_name" in cfg, f"config needs `class_name`: {cfg}"
    cfg = dict(cfg)
    cls = load_class(cfg.pop("class_name"))
    return cls(**{**cfg, **kwargs})


def make_partial(cfg: Mapping) -> Callable[..., Any]:
    cfg = dict(cfg)
    cls = load_class(cfg.pop("class_name"))

    def ctor(**kw: Any) -> Any:
        return cls(**{**cfg, **kw})

    return ctor
