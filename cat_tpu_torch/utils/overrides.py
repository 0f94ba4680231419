"""Dotted-path config overrides, the hydra-CLI equivalent (the port's copy
of cat_tpu/utils/overrides.py).

The configuration is a tree of frozen dataclasses (with some NamedTuple
leaves), so an override is a functional update:

    cfg = apply_overrides(cfg, ["events.push_enabled=False",
                                "commands.lin_vel_x=(-0.5, 1.0)"])

Values parse with ast.literal_eval (never eval); a value that is not a
literal stays a plain string. An unknown field raises and names the valid
ones; a value of the wrong type raises, except where the field's type
takes it unambiguously (an int for a float, a list for a tuple).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Sequence


def _parse(value: str) -> Any:
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value  # bare string


def _fields_of(obj) -> Sequence[str]:
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    if hasattr(obj, "_fields"):  # NamedTuple
        return list(obj._fields)
    return []


def _replace(obj, name: str, value):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{name: value})
    if hasattr(obj, "_replace"):
        return obj._replace(**{name: value})
    raise TypeError(f"cannot override field of {type(obj).__name__}")


def _coerce(old, new):
    """Match the existing field's type where unambiguous (int stays int,
    float accepts int literals, tuple accepts list literals)."""
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        raise ValueError(f"expected a bool, got {new!r}")
    if isinstance(old, int) and isinstance(new, int):
        return new
    if isinstance(old, float) and isinstance(new, (int, float)):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return tuple(new)
    if old is None or isinstance(new, type(old)):
        return new
    raise ValueError(
        f"expected {type(old).__name__}, got {type(new).__name__} ({new!r})")


def set_path(cfg, path: str, value):
    """Functionally set ``a.b.c`` on a tree of frozen dataclasses and
    NamedTuples."""
    head, _, rest = path.partition(".")
    names = _fields_of(cfg)
    if head not in names:
        raise KeyError(f"no field {head!r} on {type(cfg).__name__}; "
                       f"valid fields: {sorted(names)}")
    old = getattr(cfg, head)
    if rest:
        return _replace(cfg, head, set_path(old, rest, value))
    return _replace(cfg, head, _coerce(old, value))


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key.path=value`` strings to a frozen config tree."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form key=value")
        k, _, v = ov.partition("=")
        cfg = set_path(cfg, k.strip(), _parse(v.strip()))
    return cfg
