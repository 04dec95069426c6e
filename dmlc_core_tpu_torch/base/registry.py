"""Global factory registries.

Reference parity: ``include/dmlc/registry.h :: Registry<EntryType>::Get()
->Register(name)/Find(name)/ListAllNames(), FunctionRegEntryBase,
DMLC_REGISTRY_ENABLE/REGISTER`` (SURVEY.md §2a).

This package's own copy of ``dmlc_core_tpu.base.registry``: the GBT
objectives, parsers, input splits and filesystems self-register here by
name.  Import of the defining module is the registration event.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

from dmlc_core_tpu_torch.base.logging import log_fatal

__all__ = ["Registry", "FunctionRegEntry"]

E = TypeVar("E")


class FunctionRegEntry:
    """A registry entry carrying a factory plus self-documentation.

    Reference parity: ``dmlc::FunctionRegEntryBase`` — ``set_body``,
    ``describe``, ``add_argument``, ``set_return_type``.
    """

    def __init__(self, name: str):
        self.name = name
        self.body: Optional[Callable[..., Any]] = None
        self.description: str = ""
        self.arguments: List[Dict[str, str]] = []
        self.return_type: str = ""

    def set_body(self, fn: Callable[..., Any]) -> "FunctionRegEntry":
        self.body = fn
        return self

    def describe(self, text: str) -> "FunctionRegEntry":
        self.description = text
        return self

    def add_argument(self, name: str, type_str: str,
                     description: str) -> "FunctionRegEntry":
        self.arguments.append({"name": name, "type": type_str,
                               "description": description})
        return self

    def set_return_type(self, type_str: str) -> "FunctionRegEntry":
        self.return_type = type_str
        return self

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self.body is None:
            log_fatal(f"Registry entry {self.name!r} has no body")
        return self.body(*args, **kwargs)


class Registry(Generic[E]):
    """A named global registry of factories/entries.

    Usage (mirrors ``DMLC_REGISTRY_ENABLE`` + ``DMLC_REGISTRY_REGISTER``)::

        objectives = Registry("gbt_objective")

        @objectives.register("binary:logistic")
        class _Logistic: ...

        objectives.find("binary:logistic")   # -> entry (None if absent)
        objectives["binary:logistic"]        # -> entry (fatal if absent)
        objectives.list_all_names()
    """

    _instances: Dict[str, "Registry[Any]"] = {}

    def __new__(cls, kind: str) -> "Registry[E]":
        # Per-kind singleton: Registry("x") and Registry.get("x") are the
        # same object, matching the C++ Registry<Entry>::Get() contract.
        inst = cls._instances.get(kind)
        if inst is None:
            inst = super().__new__(cls)
            inst.kind = kind
            inst._entries = {}
            cls._instances[kind] = inst
        return inst  # type: ignore[return-value]

    def __init__(self, kind: str):
        pass  # state set once in __new__; re-construction returns the singleton

    # -- the Registry<Entry>::Get() singleton pattern --------------------
    @classmethod
    def get(cls, kind: str) -> "Registry[Any]":
        """Return (creating if needed) the global registry named ``kind``."""
        return cls(kind)

    # -- registration ----------------------------------------------------
    def register(self, name: str, entry: Optional[E] = None, override: bool = False):
        """Register ``entry`` under ``name``.

        With no ``entry``, returns a decorator: plain functions are wrapped
        in a :class:`FunctionRegEntry` (carrying ``__doc__`` as the
        description); classes and existing FunctionRegEntry objects are
        registered as themselves (a class's docs live on the class).
        """
        if entry is not None:
            self._register(name, entry, override)
            return entry

        def deco(obj: Any) -> Any:
            if isinstance(obj, (FunctionRegEntry, type)):
                self._register(name, obj, override)
            else:
                e = FunctionRegEntry(name).set_body(obj)
                if getattr(obj, "__doc__", None):
                    e.describe(obj.__doc__)
                self._register(name, e, override)
            return obj

        return deco

    def _register(self, name: str, entry: Any, override: bool) -> None:
        if name in self._entries and not override:
            log_fatal(f"{self.kind} registry: name {name!r} already registered")
        self._entries[name] = entry

    # -- lookup ----------------------------------------------------------
    def find(self, name: str) -> Optional[E]:
        """Return the entry or None.  Reference: ``Registry::Find``."""
        return self._entries.get(name)

    def __getitem__(self, name: str) -> E:
        entry = self.find(name)
        if entry is None:
            log_fatal(
                f"{self.kind} registry: unknown entry {name!r}. "
                f"Known: {sorted(self._entries)}"
            )
        return entry  # type: ignore[return-value]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def list_all_names(self) -> List[str]:
        """Reference: ``Registry::ListAllNames``."""
        return sorted(self._entries)

    def remove(self, name: str) -> None:
        """Unregister (mostly for tests)."""
        self._entries.pop(name, None)
