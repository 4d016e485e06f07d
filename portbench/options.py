"""The program's configuration as data: a configuration file's
``pipeline`` dict, with a traffic file's options merged over it, built into
the program's config classes."""

from __future__ import annotations

import dataclasses

__all__ = ["merge", "build_config"]


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def build_config(cls, data: dict):
    """``cls`` (a config dataclass) from a dict of its fields; nested
    dataclasses from nested dicts, tuples from lists. Unknown keys raise."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    values = {}
    for name, value in data.items():
        default = fields[name].default
        if dataclasses.is_dataclass(default):
            value = build_config(type(default), value)
        elif isinstance(value, list):
            value = tuple(value)
        values[name] = value
    return cls(**values)
