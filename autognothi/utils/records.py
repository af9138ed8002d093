"""Plain dataclass records and their JSON-dict form.

The experiment configuration tree (`.hparams.json`), the model configs and
the measurement reports are stdlib dataclasses deriving from `Record`.
`Record.from_dict` builds one from parsed JSON: it checks every field's type
and `Literal` values, resolves a union of records by its `kind` field, reads
aliased keys (`$schema`), and remembers which fields the input set, so that
`to_dict(exclude_unset=True)` writes back exactly the keys that were read.
"""

from __future__ import annotations

import dataclasses
import functools
import types
import typing
from typing import Any, ClassVar, Dict, Literal, Union

__all__ = ["Record", "project"]


class Record:
    """Base of every record class; subclasses are `@dataclasses.dataclass`.

    `_aliases` maps a field name to the key it has in JSON."""

    _aliases: ClassVar[Dict[str, str]] = {}

    def __setattr__(self, name: str, value: Any) -> None:
        object.__setattr__(self, name, value)
        self.__dict__.setdefault("_fields_set", set()).add(name)

    @classmethod
    def from_dict(cls, data: Any):
        return _validate(cls, data, cls.__name__)

    def to_dict(self, exclude_unset: bool = False) -> dict:
        return _dump(self, exclude_unset)


def project(record: Record, cls):
    """The `cls` record holding `record`'s values for `cls`'s fields (a
    variant config viewed as the vanilla config it extends)."""
    return cls(**{f.name: getattr(record, f.name)
                  for f in dataclasses.fields(cls)})


@functools.lru_cache(maxsize=None)
def _hints(cls) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


def _kind_of(tp) -> Any:
    """The `Literal` value of a record class's `kind` field, else None."""
    if not (isinstance(tp, type) and dataclasses.is_dataclass(tp)):
        return None
    hint = _hints(tp).get("kind")
    if typing.get_origin(hint) is Literal and len(typing.get_args(hint)) == 1:
        return typing.get_args(hint)[0]
    return None


def _fail(path: str, msg: str):
    raise ValueError(f"{path}: {msg}")


def _validate(tp, value, path: str):
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is Any:
        return value
    if origin in (Union, types.UnionType):
        if value is None:
            if type(None) in args:
                return None
            _fail(path, "must not be null")
        members = [a for a in args if a is not type(None)]
        if len(members) == 1:
            return _validate(members[0], value, path)
        kinds = {_kind_of(m): m for m in members}
        if None not in kinds:
            if not isinstance(value, dict) or "kind" not in value:
                _fail(path, f"needs a 'kind' among {sorted(kinds)}")
            if value["kind"] not in kinds:
                _fail(path, f"unknown kind {value['kind']!r}; "
                      f"expected one of {sorted(kinds)}")
            return _validate(kinds[value["kind"]], value, path)
        _fail(path, f"unsupported union {tp}")
    if origin is Literal:
        if value not in args:
            _fail(path, f"{value!r} is not one of {list(args)}")
        return value
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            _fail(path, f"expected a list, got {type(value).__name__}")
        if origin is tuple and not (len(args) == 2 and args[1] is Ellipsis):
            if len(value) != len(args):
                _fail(path, f"expected {len(args)} items, got {len(value)}")
            return tuple(_validate(a, v, f"{path}[{i}]")
                         for i, (a, v) in enumerate(zip(args, value)))
        item = args[0] if args else Any
        out = [_validate(item, v, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(out) if origin is tuple else out
    if origin is dict:
        if not isinstance(value, dict):
            _fail(path, f"expected an object, got {type(value).__name__}")
        k_tp, v_tp = args if args else (Any, Any)
        return {_validate_key(k_tp, k, path): _validate(v_tp, v, f"{path}.{k}")
                for k, v in value.items()}
    if typing.is_typeddict(tp):
        if not isinstance(value, dict):
            _fail(path, f"expected an object, got {type(value).__name__}")
        hints = typing.get_type_hints(tp)
        for key in tp.__required_keys__:
            if key not in value:
                _fail(path, f"missing field {key!r}")
        return {k: _validate(hints[k], v, f"{path}.{k}") if k in hints else v
                for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, Record):
        return _validate_record(tp, value, path)
    if tp is bool:
        if not isinstance(value, bool):
            _fail(path, f"expected a bool, got {value!r}")
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            _fail(path, f"expected an int, got {value!r}")
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            _fail(path, f"expected a number, got {value!r}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            _fail(path, f"expected a string, got {value!r}")
        return value
    _fail(path, f"unsupported field type {tp}")


def _validate_key(tp, key, path: str):
    if tp is int and isinstance(key, str):
        try:
            return int(key)
        except ValueError:
            _fail(path, f"key {key!r} is not an int")
    return _validate(tp, key, f"{path}<key>")


def _validate_record(cls, value, path: str):
    if isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        _fail(path, f"expected an object, got {type(value).__name__}")
    hints = _hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = cls._aliases.get(f.name, f.name)
        if key in value:
            kwargs[f.name] = _validate(hints[f.name], value[key],
                                       f"{path}.{key}")
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            _fail(path, f"missing field {key!r}")
    record = cls(**kwargs)
    object.__setattr__(record, "_fields_set", set(kwargs))
    return record


def _dump(value, exclude_unset: bool):
    if isinstance(value, Record):
        fields_set = value.__dict__.get("_fields_set", set())
        return {
            type(value)._aliases.get(f.name, f.name):
                _dump(getattr(value, f.name), exclude_unset)
            for f in dataclasses.fields(value)
            if not exclude_unset or f.name in fields_set
        }
    if isinstance(value, dict):
        return {k: _dump(v, exclude_unset) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_dump(v, exclude_unset) for v in value]
    return value
