"""Dataclass configs with `--set key=value` overrides.

The port's copy of speaker_diarization_tpu/utils/config.py
(`apply_overrides`, `from_dict`) without YAML: override values are parsed as
JSON literals where they are one (true, 3, 1.5, "x", [1, 2]) and kept as
text otherwise, then coerced to the field's type, so `learning_rate=1e-3`,
`bf16=true` and `encoder_blocks=12,24,16` read as the JAX CLI reads them.
Config files are JSON (field → value).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Type, TypeVar, get_type_hints

T = TypeVar("T")


def _coerce(value: Any, typ: Any) -> Any:
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str, bool):
        return typ(value)
    if typ is tuple or getattr(typ, "__origin__", None) is tuple:
        return tuple(value)
    return value


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a dataclass from a dict; unknown keys raise."""
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data or {}) - names
    if unknown:
        raise KeyError(f"unknown config keys {sorted(unknown)} for {cls.__name__}; valid: {sorted(names)}")
    return cls(**{k: _coerce(v, hints.get(k, Any)) for k, v in (data or {}).items()})


def load_json(cls: Type[T], path: str) -> T:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def _parse(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def apply_overrides(obj: T, overrides: List[str]) -> T:
    """Apply 'key=value' overrides to a (frozen or mutable) dataclass."""
    data = dataclasses.asdict(obj)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        if key not in data:
            raise KeyError(f"unknown config key '{key}' for {type(obj).__name__}")
        data[key] = val if isinstance(data[key], str) else _parse(val)
    return from_dict(type(obj), data)
