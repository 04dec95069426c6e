"""Old-style ``key = value`` config files.

Reference parity: ``include/dmlc/config.h + src/config.cc :: dmlc::Config``
(SURVEY.md §2a) — iterate ``(key, value)`` pairs from a config text, with
optional multi-value keys and quoted "proto-style" string values.
"""

from __future__ import annotations

import io as _pyio
from typing import Dict, Iterator, List, Tuple, Union

from dmlc_core_tpu_torch.base.logging import log_fatal

__all__ = ["Config"]


class Config:
    """Parse ``key = value`` config text.

    * ``#`` starts a comment (outside quotes).
    * Values may be double-quoted and may span multiple tokens; quoted values
      keep embedded ``=`` and whitespace (the reference's proto-string case).
    * ``multi_value=True`` keeps every occurrence of a repeated key (in order);
      otherwise later occurrences overwrite earlier ones.
    """

    def __init__(self, source: Union[str, _pyio.TextIOBase], multi_value: bool = False):
        text = source if isinstance(source, str) else source.read()
        self.multi_value = multi_value
        self._order: List[Tuple[str, str]] = []
        self._latest: Dict[str, str] = {}
        self._parse(text)

    def _parse(self, text: str) -> None:
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = self._strip_comment(raw).strip()
            if not line:
                continue
            if "=" not in line:
                log_fatal(f"Config: line {lineno} has no '=': {raw!r}")
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if not key:
                log_fatal(f"Config: line {lineno} has empty key: {raw!r}")
            if len(value) >= 2 and value[0] == '"' and value[-1] == '"':
                value = value[1:-1].replace('\\"', '"').replace("\\n", "\n")
            if not self.multi_value and key in self._latest:
                self._order = [(k, v) for (k, v) in self._order if k != key]
            self._order.append((key, value))
            self._latest[key] = value

    @staticmethod
    def _strip_comment(line: str) -> str:
        out = []
        in_quote = False
        i = 0
        while i < len(line):
            ch = line[i]
            if ch == '"' and (i == 0 or line[i - 1] != "\\"):
                in_quote = not in_quote
            if ch == "#" and not in_quote:
                break
            out.append(ch)
            i += 1
        return "".join(out)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return iter(self._order)

    def __getitem__(self, key: str) -> str:
        if key not in self._latest:
            log_fatal(f"Config: unknown key {key!r}")
        return self._latest[key]

    def get(self, key: str, default: str = "") -> str:
        return self._latest.get(key, default)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._order)

    def to_dict(self) -> Dict[str, str]:
        return dict(self._latest)
