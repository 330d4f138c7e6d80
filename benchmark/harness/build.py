"""Build the port's filter chain from a configuration file, through the
port's public classes: each filter's settings come from the file in full
(nested groups and all), so the file is the configuration as it is run."""

from __future__ import annotations

import dataclasses
import typing
from typing import Any


def _settings(cls: type, values: dict) -> Any:
    """A settings dataclass from a dict holding every one of its fields:
    nested groups become their dataclasses and lists become tuples."""
    proto = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    if set(values) != names:
        raise ValueError(f"{cls.__name__}: the file gives {sorted(values)}, the class has {sorted(names)}")
    kwargs = {}
    for name, value in values.items():
        default = getattr(proto, name)
        if dataclasses.is_dataclass(default):
            value = _settings(type(default), value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def build_filter(config: dict):
    """The configuration's filter: one filter, or a CompositeFilter of the
    chain.  Each entry names the port's filter class (`class`, exported by
    the package); its `settings` are that class's `settings` field, whose
    type the class's annotation gives."""
    import livevisionkit_tpu_torch as lvk

    chain = []
    for entry in config["filters"]:
        filt_cls = getattr(lvk, entry["class"])
        settings_cls = typing.get_type_hints(filt_cls)["settings"]
        chain.append(filt_cls(settings=_settings(settings_cls, entry["settings"])))
    return chain[0] if len(chain) == 1 else lvk.CompositeFilter(filters=tuple(chain))


def pixel_format(config: dict):
    import livevisionkit_tpu_torch as lvk

    return lvk.PixelFormat[config["format"]]
