"""Typed, validated, self-documenting parameter structs.

Reference parity: ``include/dmlc/parameter.h :: Parameter<PType>`` CRTP —
``Init(kwargs)``, ``InitAllowUnknown``, ``UpdateDict``, ``__DICT__()``,
``__FIELDS__()``, ``Save/Load(JSON)``, ``DMLC_DECLARE_FIELD(f).set_default()
.set_range().set_lower_bound().add_enum().describe()``, ``FieldEntry<T>``
specializations, ``ParamInitOption`` and ``dmlc::GetEnv<T>`` (SURVEY.md
§2a).

Fields are declared with :func:`field` descriptors on a :class:`Parameter`
subclass; a metaclass collects them in declaration order.  Values are
parsed from strings exactly like the reference, range/enum-validated, and
round-trip through JSON.

This package's own copy of ``dmlc_core_tpu.base.parameter``: ``to_dict()``
(and hence a saved model's param payload), :meth:`Parameter.save_json`'s
text and :meth:`Parameter.__hash__` are the JAX package's, so a parameter
file written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Type,
    TypeVar,
    Union,
)

from dmlc_core_tpu_torch.base.logging import Error

__all__ = ["Parameter", "field", "FieldEntry", "ParamInitOption", "get_env"]

T = TypeVar("T")

_MISSING = object()


class ParamInitOption:
    """Reference parity: ``dmlc::parameter::ParamInitOption``."""

    kAllowUnknown = "allow_unknown"
    kAllMatch = "all_match"
    kAllowHidden = "allow_hidden"  # unknown keys starting with '__' pass


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"cannot parse bool from {s!r}")


def _str2type(value: Any, ty: type) -> Any:
    """Parse ``value`` (usually a string) into ``ty``.

    Reference parity: ``include/dmlc/strtonum.h :: Str2Type`` /
    ``FieldEntry<T>::Set``.  Host-side config parsing is not a hot path, so
    Python parsing is the right engine here.
    """
    if ty is Any or ty is None:
        return value
    origin = getattr(ty, "__origin__", None)
    if origin is Union:  # Optional[T]
        args = [a for a in ty.__args__ if a is not type(None)]
        if value is None or (isinstance(value, str) and value.strip() in ("None", "none", "")):
            return None
        return _str2type(value, args[0])
    if isinstance(value, ty) and not (ty is int and isinstance(value, bool)):
        return value
    if ty is bool:
        if isinstance(value, (int, float)):
            return bool(value)
        return _parse_bool(str(value))
    if ty in (int, float, str):
        try:
            return ty(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"cannot parse {ty.__name__} from {value!r}") from e
    if ty in (list, tuple):
        if isinstance(value, str):
            items = [v.strip() for v in
                     value.replace("(", "").replace(")", "").split(",")
                     if v.strip()]
            return ty(items)
        return ty(value)
    return value


class FieldEntry:
    """One declared field: type, default, bounds, enum, docs.

    Reference parity: ``dmlc::parameter::FieldEntry<T>`` and the
    ``DMLC_DECLARE_FIELD`` fluent API, collapsed into keyword arguments of
    :func:`field`.
    """

    def __init__(
        self,
        type: type = str,
        default: Any = _MISSING,
        description: str = "",
        lower_bound: Optional[Any] = None,
        upper_bound: Optional[Any] = None,
        enum: Optional[Sequence[Any]] = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ):
        self.type = type
        self.default = default
        self.description = description
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.enum = list(enum) if enum is not None else None
        self.validator = validator
        self.name: str = "?"  # filled by the metaclass

    # fluent API kept for source-level familiarity with the reference
    def set_default(self, v: Any) -> "FieldEntry":
        self.default = v
        return self

    def set_range(self, lo: Any, hi: Any) -> "FieldEntry":
        self.lower_bound, self.upper_bound = lo, hi
        return self

    def set_lower_bound(self, lo: Any) -> "FieldEntry":
        self.lower_bound = lo
        return self

    def set_upper_bound(self, hi: Any) -> "FieldEntry":
        self.upper_bound = hi
        return self

    def add_enum(self, v: Any) -> "FieldEntry":
        self.enum = (self.enum or []) + [v]
        return self

    def describe(self, text: str) -> "FieldEntry":
        self.description = text
        return self

    @property
    def has_default(self) -> bool:
        return self.default is not _MISSING

    def check(self, value: Any) -> Any:
        """Parse + validate a candidate value; raise dmlc Error on violation."""
        try:
            value = _str2type(value, self.type)
        except ValueError as e:
            raise Error(f"parameter {self.name!r}: {e}") from e
        if self.lower_bound is not None and value is not None and value < self.lower_bound:
            raise Error(
                f"parameter {self.name!r}: value {value!r} below lower bound {self.lower_bound!r}"
            )
        if self.upper_bound is not None and value is not None and value > self.upper_bound:
            raise Error(
                f"parameter {self.name!r}: value {value!r} above upper bound {self.upper_bound!r}"
            )
        if self.enum is not None and value not in self.enum:
            raise Error(
                f"parameter {self.name!r}: value {value!r} not in allowed set {self.enum!r}"
            )
        if self.validator is not None and not self.validator(value):
            raise Error(f"parameter {self.name!r}: value {value!r} rejected by validator")
        return value


def field(
    type: type = str,
    default: Any = _MISSING,
    description: str = "",
    lower_bound: Optional[Any] = None,
    upper_bound: Optional[Any] = None,
    enum: Optional[Sequence[Any]] = None,
    validator: Optional[Callable[[Any], bool]] = None,
) -> FieldEntry:
    """Declare a parameter field — the ``DMLC_DECLARE_FIELD`` equivalent."""
    return FieldEntry(type, default, description, lower_bound, upper_bound, enum, validator)


class _ParameterMeta(type):
    def __new__(mcls, name, bases, ns):
        fields: Dict[str, FieldEntry] = {}
        for base in bases:
            fields.update(getattr(base, "__param_fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, FieldEntry):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["__param_fields__"] = fields
        return super().__new__(mcls, name, bases, ns)


class Parameter(metaclass=_ParameterMeta):
    """Base class for typed parameter structs.

    Usage::

        class TreeParam(Parameter):
            max_depth = field(int, default=6, lower_bound=1,
                              description="maximum tree depth")
            eta = field(float, default=0.3, lower_bound=0.0, upper_bound=1.0)
            tree_method = field(str, default="hist", enum=["hist", "exact"])

        p = TreeParam()
        unknown = p.init({"max_depth": "8"}, allow_unknown=True)

    Reference parity: ``Parameter<PType>::Init / InitAllowUnknown /
    UpdateDict / __DICT__ / __FIELDS__ / Save / Load``.
    """

    __param_fields__: Dict[str, FieldEntry] = {}

    def __init__(self, **kwargs: Any):
        for name, entry in self.__param_fields__.items():
            if entry.has_default:
                object.__setattr__(self, name, entry.check(entry.default))
        if kwargs:
            self.init(kwargs)

    # -- init / update ---------------------------------------------------
    def init(
        self,
        kwargs: Union[Mapping[str, Any], Iterable[Tuple[str, Any]]],
        allow_unknown: bool = False,
        option: Optional[str] = None,
    ) -> List[Tuple[str, Any]]:
        """Set fields from (string-keyed) kwargs with validation.

        Returns the list of unknown ``(key, value)`` pairs if
        ``allow_unknown`` (reference: ``InitAllowUnknown``); raises
        :class:`Error` on unknown keys otherwise, and always on missing
        required fields or validation failure.

        ``option`` overrides the mode explicitly (reference:
        ``ParamInitOption``): ``kAllMatch`` raises on every unknown key,
        ``kAllowHidden`` (the default strict mode) tolerates only hidden
        ``__key__`` entries, ``kAllowUnknown`` collects all unknowns.
        """
        if option is None:
            option = (
                ParamInitOption.kAllowUnknown if allow_unknown else ParamInitOption.kAllowHidden
            )
        items = list(kwargs.items()) if isinstance(kwargs, Mapping) else list(kwargs)
        unknown: List[Tuple[str, Any]] = []
        for key, value in items:
            entry = self.__param_fields__.get(key)
            if entry is None:
                hidden = key.startswith("__") and key.endswith("__")
                if option == ParamInitOption.kAllowUnknown or (
                    option == ParamInitOption.kAllowHidden and hidden
                ):
                    unknown.append((key, value))
                    continue
                raise Error(
                    f"{type(self).__name__}: unknown parameter {key!r}. "
                    f"Candidates: {sorted(self.__param_fields__)}"
                )
            object.__setattr__(self, key, entry.check(value))
        missing = [
            n
            for n, e in self.__param_fields__.items()
            if not e.has_default and not hasattr(self, n)
        ]
        if missing:
            raise Error(
                f"{type(self).__name__}: required parameters not set: {missing}"
            )
        return unknown

    def update_dict(self, kwargs: Dict[str, Any]) -> None:
        """Init from dict, then write the struct's values back into it.

        Reference parity: ``Parameter::UpdateDict`` — keeps an external
        string-dict (e.g. an XGBoost-style config) in sync with the struct.
        """
        self.init(kwargs, allow_unknown=True)
        kwargs.update({k: getattr(self, k) for k in self.__param_fields__})

    def __setattr__(self, name: str, value: Any) -> None:
        entry = self.__param_fields__.get(name)
        if entry is not None:
            value = entry.check(value)
        object.__setattr__(self, name, value)

    # -- introspection ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Reference parity: ``__DICT__()``."""
        return {k: getattr(self, k) for k in self.__param_fields__ if hasattr(self, k)}

    @classmethod
    def fields(cls) -> Dict[str, "FieldEntry"]:
        """Reference parity: ``__FIELDS__()``."""
        return dict(cls.__param_fields__)

    @classmethod
    def doc_string(cls) -> str:
        """Generated docs for all fields (the reference's __DOC__ output)."""
        lines = []
        for name, e in cls.__param_fields__.items():
            constraints = []
            if e.has_default:
                constraints.append(f"default={e.default!r}")
            if e.lower_bound is not None:
                constraints.append(f">={e.lower_bound!r}")
            if e.upper_bound is not None:
                constraints.append(f"<={e.upper_bound!r}")
            if e.enum is not None:
                constraints.append(f"one of {e.enum!r}")
            suffix = f" ({', '.join(constraints)})" if constraints else ""
            lines.append(f"{name} : {e.type.__name__}{suffix}\n    {e.description}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({body})"

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and other.to_dict() == self.to_dict()

    def __hash__(self) -> int:
        # equal parameters hash alike, list fields included (the JAX
        # package's hash: a static jit argument there, a cache key here)
        items = sorted(self.to_dict().items(), key=lambda kv: kv[0])
        return hash((type(self).__name__,
                     tuple((k, _freeze(v)) for k, v in items)))

    # -- JSON round trip -------------------------------------------------
    def save(self, stream) -> None:
        """Write JSON to a dmlc Stream.  Reference: ``Parameter::Save(JSONWriter)``."""
        stream.write(self.save_json().encode("utf-8"))

    def load(self, stream) -> None:
        """Read JSON from a dmlc Stream.  Reference: ``Parameter::Load(JSONReader)``."""
        data = stream.read_all() if hasattr(stream, "read_all") else stream.read(-1)
        self.load_json(bytes(data).decode("utf-8"))

    def save_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def load_json(self, text: str) -> None:
        self.init(json.loads(text))


def _freeze(v: Any) -> Any:
    """``v`` with lists, tuples and dicts made hashable tuples."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def get_env(name: str, default: T, type: Optional[Type[T]] = None) -> T:
    """Typed environment-variable read.

    Reference parity: ``dmlc::GetEnv<T>(name, default)`` (parameter.h).
    The type is inferred from ``default`` unless given explicitly.
    """
    raw = os.environ.get(name)
    if raw is None:
        return default
    ty = type if type is not None else (default.__class__ if default is not None else str)
    try:
        return _str2type(raw, ty)  # type: ignore[return-value]
    except ValueError as e:
        raise Error(f"environment variable {name}: {e}") from e
