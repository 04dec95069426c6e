"""Typed, validated, self-documenting parameter structs.

Reference parity: ``include/dmlc/parameter.h :: Parameter<PType>`` CRTP —
``Init(kwargs)``, ``InitAllowUnknown``, ``__DICT__()``,
``DMLC_DECLARE_FIELD`` (default, range, enum, description),
``FieldEntry<T>`` specializations and ``ParamInitOption`` (SURVEY.md §2a).

Fields are declared with :func:`field` descriptors on a :class:`Parameter`
subclass; a metaclass collects them in declaration order.  Values are
parsed from strings exactly like the reference and range/enum-validated.

This package's own copy of the part of ``dmlc_core_tpu.base.parameter``
it uses, so ``to_dict()`` (and hence a saved model's param payload) is
the same dict in both packages.
"""

from __future__ import annotations

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

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({body})"

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and other.to_dict() == self.to_dict()


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
