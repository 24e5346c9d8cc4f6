"""Typed configuration system (port of ``clonos_tpu/config/options.py``).

Equivalent capability to the reference's ``ConfigOption``/``Configuration``
(flink-core .../configuration/ConfigOptions.java) and per-job
``ExecutionConfig`` (flink-core .../api/common/ExecutionConfig.java), but a
small idiomatic-Python design: frozen option descriptors with typed defaults,
and a ``Configuration`` mapping that validates on read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generic, Iterator, Mapping, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed, documented configuration key with a default."""

    key: str
    default: T
    type: type = object
    description: str = ""
    validator: Optional[Callable[[T], bool]] = None

    def __post_init__(self):
        if self.type is object and self.default is not None:
            object.__setattr__(self, "type", builtin_type(self.default))
        self.check(self.default)

    def check(self, value: T) -> T:
        if value is not None and self.type is not object:
            if self.type is float and isinstance(value, int) and not isinstance(value, bool):
                value = float(value)  # type: ignore[assignment]
            if self.type is int and isinstance(value, bool):
                raise TypeError(
                    f"config key {self.key!r} expects int, got bool: {value!r}")
            if not isinstance(value, self.type):
                raise TypeError(
                    f"config key {self.key!r} expects {self.type.__name__}, "
                    f"got {type(value).__name__}: {value!r}"
                )
        if self.validator is not None and value is not None and not self.validator(value):
            raise ValueError(f"invalid value for config key {self.key!r}: {value!r}")
        return value


def builtin_type(v: Any) -> type:
    # bool is a subclass of int; keep it distinct so int options reject bools.
    return bool if isinstance(v, bool) else type(v)


class Configuration:
    """String-keyed config map with typed reads via :class:`ConfigOption`."""

    def __init__(self, values: Optional[Mapping[str, Any]] = None):
        self._values: Dict[str, Any] = dict(values or {})

    def get(self, option: ConfigOption[T]) -> T:
        if option.key in self._values:
            return option.check(self._values[option.key])
        return option.default

    def set(self, option: ConfigOption[T], value: T) -> "Configuration":
        self._values[option.key] = option.check(value)
        return self

    def set_raw(self, key: str, value: Any) -> "Configuration":
        self._values[key] = value
        return self

    def contains(self, option: ConfigOption) -> bool:
        return option.key in self._values

    def merged_with(self, other: "Configuration") -> "Configuration":
        out = Configuration(self._values)
        out._values.update(other._values)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __repr__(self) -> str:
        return f"Configuration({self._values!r})"
