"""One typed config tree with YAML/JSON overlays and explicit precedence.

Counterpart of speech_inpainting_tpu/utils/config.py, the port's own copy
(pure Python, no JAX): every experiment config is a frozen dataclass;
`load_config` builds it from (defaults ← each file or mapping ←
overrides), later sources winning and unknown keys refused with a
KeyError; nested dataclasses merge field by field, lists become tuples,
ints and strings become floats (and strings ints) where the field says
so. YAML files are read through `yaml`, imported only when one is
loaded. `save_config` writes the resolved tree as JSON beside the
checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _load_file(path) -> Dict[str, Any]:
    text = Path(path).read_text()
    if str(path).endswith((".yaml", ".yml")):
        import yaml
        return yaml.safe_load(text) or {}
    return json.loads(text)


def _is_dataclass_type(t) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _coerce(field_type, value):
    origin = get_origin(field_type)
    if _is_dataclass_type(field_type) and isinstance(value, Mapping):
        return build(field_type, value)
    if field_type is tuple and isinstance(value, (list, tuple)):
        return tuple(value)
    if origin is tuple and isinstance(value, (list, tuple)):
        args = get_args(field_type)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(args[0], v) for v in value)
        if args:
            return tuple(_coerce(a, v) for a, v in zip(args, value))
        return tuple(value)
    if field_type in (float,) and isinstance(value, (int, str)):
        return float(value)
    if field_type in (int,) and isinstance(value, str):
        return int(value)
    return value


def _field_types(cls) -> Dict[str, Any]:
    """Resolved annotations (handles `from __future__ import annotations`)."""
    import typing
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def build(cls: Type[T], data: Mapping[str, Any]) -> T:
    """Construct dataclass `cls` from a mapping; unknown keys error."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: "
                       f"{sorted(unknown)}")
    types = _field_types(cls)
    return cls(**{name: _coerce(types.get(name), value)
                  for name, value in data.items()})


def merge(cls: Type[T], base: T, data: Mapping[str, Any]) -> T:
    """Overlay `data` onto dataclass instance `base` (recursive)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: "
                       f"{sorted(unknown)}")
    types = _field_types(cls)
    updates = {}
    for name, value in data.items():
        cur = getattr(base, name)
        if dataclasses.is_dataclass(cur) and isinstance(value, Mapping):
            updates[name] = merge(type(cur), cur, value)
        else:
            updates[name] = _coerce(types.get(name), value)
    return dataclasses.replace(base, **updates)


def load_config(cls: Type[T], *sources, overrides: Mapping[str, Any]
                = None) -> T:
    """defaults ← each file/mapping in order ← overrides (later wins)."""
    cfg = cls()
    for src in sources:
        data = _load_file(src) if isinstance(src, (str, Path)) else src
        cfg = merge(cls, cfg, data)
    if overrides:
        cfg = merge(cls, cfg, overrides)
    return cfg


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg, path):
    """Persist the resolved config next to checkpoints (the reference's
    build_env config.json copy, I_ea/hifi_gan/env.py:14-24)."""
    d = to_dict(cfg)
    Path(path).write_text(json.dumps(d, indent=2, default=str) + "\n")
