"""Misc string/helpers.  Reference parity: ``include/dmlc/common.h :: Split``
and friends (SURVEY.md §2a)."""

from __future__ import annotations

from typing import List

__all__ = ["split"]


def split(s: str, delim: str) -> List[str]:
    """Split keeping interior empty segments, dropping only a trailing one —
    matches ``dmlc::Split`` (istringstream + getline) semantics:
    ``split("a,,b,", ",") == ["a", "", "b"]``."""
    parts = s.split(delim)
    if parts and parts[-1] == "":
        parts.pop()
    return parts
