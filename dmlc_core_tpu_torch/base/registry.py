"""Global factory registries.

Reference parity: ``include/dmlc/registry.h :: Registry<EntryType>::Get()
->Register(name)/Find(name)/ListAllNames(), DMLC_REGISTRY_ENABLE/REGISTER``
(SURVEY.md §2a).

This package's own copy of the part of ``dmlc_core_tpu.base.registry`` it
uses: the GBT objectives self-register here by name.  Import of the
defining module is the registration event.
"""

from __future__ import annotations

from typing import Any, Dict, Generic, List, Optional, TypeVar

from dmlc_core_tpu_torch.base.logging import log_fatal

__all__ = ["Registry"]

E = TypeVar("E")


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

        With no ``entry``, returns a decorator that registers the decorated
        object itself.
        """
        if entry is not None:
            self._register(name, entry, override)
            return entry

        def deco(obj: Any) -> Any:
            self._register(name, obj, override)
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
