"""Stream-coupled JSON with declare-fields-then-read ergonomics.

Reference parity: ``include/dmlc/json.h :: JSONReader, JSONWriter,
JSONObjectReadHelper`` (SURVEY.md §2a).  The reference hand-rolled a JSON
parser to stay dependency-free in C++; Python's :mod:`json` is the right
engine here, so this module keeps only the *API shape* consumers relied
on: Stream in/out, helper-declared typed fields with error reporting, and
round-trip of registered "any" types (the reference's ``AnyJSONManager``).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Type

from dmlc_core_tpu_torch.base.logging import Error, log_fatal
from dmlc_core_tpu_torch.io.stream import Stream

__all__ = ["JSONWriter", "JSONReader", "JSONObjectReadHelper", "AnyJSONManager"]


class JSONWriter:
    """Write a JSON document to a Stream."""

    def __init__(self, stream: Stream, indent: int | None = 2):
        self._stream = stream
        self._indent = indent

    def write(self, obj: Any) -> None:
        self._stream.write(json.dumps(obj, indent=self._indent).encode("utf-8"))


class JSONReader:
    """Read a JSON document from a Stream, with position-annotated errors."""

    def __init__(self, stream: Stream):
        self._stream = stream

    def read(self) -> Any:
        text = self._stream.read_all().decode("utf-8")
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            # line/col error reporting, like the reference's parser
            raise Error(f"JSON parse error at line {e.lineno} col {e.colno}: {e.msg}") from e


class JSONObjectReadHelper:
    """Declare expected fields, then read+validate an object.

    Reference parity: ``dmlc::JSONObjectReadHelper`` —
    ``DeclareField/DeclareOptionalField/ReadAllFields``.
    """

    def __init__(self) -> None:
        self._fields: Dict[str, tuple[Optional[type], bool, Optional[Callable[[Any], None]]]] = {}

    def declare_field(self, name: str, ty: Optional[type] = None,
                      setter: Optional[Callable[[Any], None]] = None) -> "JSONObjectReadHelper":
        self._fields[name] = (ty, True, setter)
        return self

    def declare_optional_field(self, name: str, ty: Optional[type] = None,
                               setter: Optional[Callable[[Any], None]] = None,
                               ) -> "JSONObjectReadHelper":
        self._fields[name] = (ty, False, setter)
        return self

    def read_all_fields(self, obj: Dict[str, Any], allow_unknown: bool = False) -> Dict[str, Any]:
        """Validate ``obj`` against declarations; run setters; return values."""
        out: Dict[str, Any] = {}
        for key, value in obj.items():
            if key not in self._fields:
                if allow_unknown:
                    continue
                log_fatal(f"JSON: unknown field {key!r}; declared: {sorted(self._fields)}")
            ty, _, setter = self._fields[key]
            if ty is not None and not isinstance(value, ty):
                log_fatal(
                    f"JSON: field {key!r} expected {ty.__name__}, got {type(value).__name__}"
                )
            out[key] = value
            if setter is not None:
                setter(value)
        missing = [k for k, (_, required, _) in self._fields.items() if required and k not in obj]
        if missing:
            log_fatal(f"JSON: missing required fields {missing}")
        return out


class AnyJSONManager:
    """Round-trip registered Python types through tagged JSON.

    Reference parity: ``dmlc::json::AnyJSONManager`` — serialize values whose
    concrete type is chosen at runtime, by registered type name.
    """

    _types: Dict[str, Type[Any]] = {}

    @classmethod
    def enable(cls, name: str, ty: Type[Any]) -> None:
        cls._types[name] = ty

    @classmethod
    def save(cls, value: Any) -> Dict[str, Any]:
        for name, ty in cls._types.items():
            if type(value) is ty:
                payload = value.to_json() if hasattr(value, "to_json") else value
                return {"__type__": name, "value": payload}
        log_fatal(f"AnyJSONManager: type {type(value).__name__} not enabled")

    @classmethod
    def load(cls, obj: Dict[str, Any]) -> Any:
        name = obj.get("__type__")
        if name not in cls._types:
            log_fatal(f"AnyJSONManager: unknown type tag {name!r}")
        ty = cls._types[name]
        if hasattr(ty, "from_json"):
            return ty.from_json(obj["value"])
        return ty(obj["value"])
