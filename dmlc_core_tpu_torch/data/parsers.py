"""Text parsers: LibSVM / CSV / LibFM chunks → CSR RowBlocks.

Reference parity: ``src/data/parser.h :: ParserImpl (FillData, BytesRead)``,
``text_parser.h :: TextParserBase`` (the multithreaded parse hot loop),
``libsvm_parser.h``, ``csv_parser.h :: CSVParserParam``, ``libfm_parser.h``,
and ``src/data.cc``'s parser factory registry / ``src/io/uri_spec.h``'s
URI-embedded kwargs (SURVEY.md §2b).

Engine split: the hot loop lives in ``cpp/fastparse.cc`` (OpenMP over line
ranges, from_chars number parsing) reached via ctypes; a pure-numpy fallback
keeps the package dependency-free.  Parsers pull chunks from a (threaded)
InputSplit, so storage read, parse, and device staging pipeline into each
other exactly like the reference's two thread boundaries (SURVEY.md §3.1).

This package's own copy of ``dmlc_core_tpu.data.parsers``: the native
engine is ``data/_native.py`` over ``cpp/fastparse.cc``, built on first use
(``base/_native_build.py``); the ``_py_parse_*`` functions are its
correctness reference and the route where the library is absent.
"""

from __future__ import annotations

import urllib.parse
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import Error, log_fatal
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.registry import Registry
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.data import _native
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.io.input_split import InputSplit
from dmlc_core_tpu_torch.utils.profiler import global_tracer, tracing_enabled

__all__ = ["Parser", "LibSVMParser", "CSVParser", "LibFMParser", "parse_uri_spec"]

PARSER_REGISTRY: Registry = Registry.get("data_parser")

_PM = None


def _parser_metrics():
    global _PM
    if _PM is None:
        r = _metrics.default_registry()
        _PM = {
            "bytes": r.counter("data_parse_bytes_total",
                               "raw input bytes parsed", labels=("format",)),
            "rows": r.counter("data_parse_rows_total",
                              "rows produced by parsers", labels=("format",)),
            "seconds": r.histogram("data_parse_seconds",
                                   "per-chunk parse time",
                                   labels=("format",)),
        }
    return _PM


def parse_uri_spec(uri: str) -> Tuple[str, Dict[str, str], Optional[str]]:
    """Split ``path?key=val&key2=val2#cachefile`` into (path, args, cache).

    Reference parity: ``src/io/uri_spec.h :: URISpec`` — parser kwargs ride
    inside the URI so consumer call sites stay one-string.
    """
    cache = None
    if "#" in uri:
        uri, _, cache = uri.rpartition("#")
    args: Dict[str, str] = {}
    if "?" in uri:
        uri, _, query = uri.partition("?")
        for key, val in urllib.parse.parse_qsl(query, keep_blank_values=True):
            args[key] = val
    return uri, args, cache


class CSVParserParam(Parameter):
    """Reference parity: ``csv_parser.h :: CSVParserParam``."""

    format = field(str, default="csv")
    label_column = field(int, default=0, description="column used as label")
    weight_column = field(int, default=-1, description="column used as weight (-1: none)")
    delimiter = field(str, default=",", description="field delimiter")


class Parser:
    """Chunk-pulling parser producing RowBlocks.

    Reference parity: ``dmlc::Parser<IndexType>`` — created by format name
    via the ``data_parser`` registry; iterating yields CSR
    :class:`RowBlock` batches; ``bytes_read`` tracks raw input consumed.
    """

    #: metrics label; each registered parser class overrides
    format_name = "unknown"

    def __init__(self, split: InputSplit, nthread: int = 0):
        self._split = split
        self._nthread = nthread
        self.bytes_read = 0

    # -- factory ---------------------------------------------------------
    @staticmethod
    def create(uri: str, part: int = 0, nparts: int = 1,
               format: Optional[str] = None, nthread: int = 0) -> "Parser":
        """Reference: ``Parser<I>::Create(uri, part, nparts, type)``.

        Format comes from the explicit arg or a ``?format=`` URI key
        (default libsvm, like the reference).
        """
        path, args, _cache = parse_uri_spec(uri)
        fmt = format or args.get("format", "libsvm")
        entry = PARSER_REGISTRY.find(fmt)
        if entry is None:
            log_fatal(
                f"Parser.create: unknown format {fmt!r}; known: "
                f"{PARSER_REGISTRY.list_all_names()}"
            )
        return entry(path, part, nparts, args, nthread)

    # -- iteration -------------------------------------------------------
    def _parse_chunk(self, chunk: bytes) -> Optional[RowBlock]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            chunk = self._split.next_chunk()
            if chunk is None:
                return
            self.bytes_read += len(chunk)
            if _metrics.enabled():
                m = _parser_metrics()
                fmt = self.format_name
                m["bytes"].inc(len(chunk), format=fmt)
                t0 = get_time()
                if tracing_enabled():
                    with global_tracer().scope("parse", format=fmt,
                                               bytes=len(chunk)):
                        block = self._parse_chunk(chunk)
                else:
                    block = self._parse_chunk(chunk)
                m["seconds"].observe(get_time() - t0, format=fmt)
                if block is not None:
                    m["rows"].inc(block.size, format=fmt)
            else:
                block = self._parse_chunk(chunk)
            if block is not None and block.size > 0:
                yield block

    def before_first(self) -> None:
        self._split.before_first()
        self.bytes_read = 0

    def hint_chunk_size(self, nbytes: int) -> None:
        self._split.hint_chunk_size(nbytes)

    def close(self) -> None:
        self._split.close()

    @staticmethod
    def _from_arrays(d: dict) -> Optional[RowBlock]:
        if len(d["label"]) == 0:
            return None
        return RowBlock(
            offset=d["offset"], label=d["label"], index=d["index"],
            value=d.get("value"), weight=d.get("weight"), qid=d.get("qid"),
            field=d.get("field"),
        )


@PARSER_REGISTRY.register("libsvm")
class LibSVMParser(Parser):
    """``label [qid:n] idx:val ...`` — XGBoost's classic input format."""

    format_name = "libsvm"

    def __init__(self, path: str, part: int, nparts: int,
                 args: Optional[Dict[str, str]] = None, nthread: int = 0):
        super().__init__(InputSplit.create(path, part, nparts, "text"), nthread)

    def _parse_chunk(self, chunk: bytes) -> Optional[RowBlock]:
        if _native.native_available():
            return self._from_arrays(_native.parse_libsvm(chunk, self._nthread))
        return self._from_arrays(_py_parse_libsvm(chunk))


@PARSER_REGISTRY.register("csv")
class CSVParser(Parser):
    """Dense CSV → CSR (zeros kept, feature index = column position
    excluding label/weight columns)."""

    format_name = "csv"

    def __init__(self, path: str, part: int, nparts: int,
                 args: Optional[Dict[str, str]] = None, nthread: int = 0):
        super().__init__(InputSplit.create(path, part, nparts, "text"), nthread)
        self.param = CSVParserParam()
        self.param.init(args or {}, allow_unknown=True)

    def _parse_chunk(self, chunk: bytes) -> Optional[RowBlock]:
        p = self.param
        if _native.native_available():
            return self._from_arrays(
                _native.parse_csv(chunk, p.delimiter, p.label_column,
                                  p.weight_column, self._nthread)
            )
        return self._from_arrays(
            _py_parse_csv(chunk, p.delimiter, p.label_column, p.weight_column)
        )


@PARSER_REGISTRY.register("libfm")
class LibFMParser(Parser):
    """``label field:idx:val ...`` — field-aware FM format."""

    format_name = "libfm"

    def __init__(self, path: str, part: int, nparts: int,
                 args: Optional[Dict[str, str]] = None, nthread: int = 0):
        super().__init__(InputSplit.create(path, part, nparts, "text"), nthread)

    def _parse_chunk(self, chunk: bytes) -> Optional[RowBlock]:
        if _native.native_available():
            return self._from_arrays(_native.parse_libfm(chunk, self._nthread))
        return self._from_arrays(_py_parse_libfm(chunk))


# -- pure-python fallbacks (correctness reference for the native engine) --

def _py_parse_libsvm(chunk: bytes) -> dict:
    offsets = [0]
    labels: list = []
    qids: list = []
    idx_parts: list = []
    val_parts: list = []
    any_qid = False
    nnz = 0
    for line in chunk.split(b"\n"):
        tokens = line.split()
        if not tokens:
            continue
        try:
            labels.append(float(tokens[0]))
        except ValueError as e:
            raise Error(f"libsvm: bad label {tokens[0]!r}") from e
        qid = 0
        for tok in tokens[1:]:
            if tok.startswith(b"qid:"):
                qid = int(tok[4:])
                any_qid = True
                continue
            feat, _, val = tok.partition(b":")
            try:
                idx_parts.append(int(feat))
                val_parts.append(float(val) if val else 1.0)
            except ValueError as e:
                raise Error(f"libsvm: bad feature {tok!r}") from e
            nnz += 1
        qids.append(qid)
        offsets.append(nnz)
    return {
        "offset": np.asarray(offsets, np.int64),
        "label": np.asarray(labels, np.float32),
        "index": np.asarray(idx_parts, np.int64),
        "value": np.asarray(val_parts, np.float32),
        "weight": None,
        "qid": np.asarray(qids, np.int64) if any_qid else None,
        "field": None,
    }


def _py_parse_csv(chunk: bytes, delimiter: str, label_col: int, weight_col: int) -> dict:
    delim = delimiter.encode()
    offsets = [0]
    labels: list = []
    weights: list = []
    values: list = []
    indices: list = []
    any_weight = False
    nnz = 0
    for line in chunk.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        cells = line.split(delim)
        try:
            row = [float(c) if c.strip() else 0.0 for c in cells]
        except ValueError as e:
            raise Error(f"csv: bad number in line {line!r}") from e
        label = 0.0
        weight = 1.0
        feat = 0
        for col, v in enumerate(row):
            if col == label_col:
                label = v
            elif col == weight_col:
                weight = v
                any_weight = True
            else:
                indices.append(feat)
                values.append(v)
                feat += 1
                nnz += 1
        labels.append(label)
        weights.append(weight)
        offsets.append(nnz)
    return {
        "offset": np.asarray(offsets, np.int64),
        "label": np.asarray(labels, np.float32),
        "index": np.asarray(indices, np.int64),
        "value": np.asarray(values, np.float32),
        "weight": np.asarray(weights, np.float32) if any_weight else None,
        "qid": None,
        "field": None,
    }


def _py_parse_libfm(chunk: bytes) -> dict:
    offsets = [0]
    labels: list = []
    fields: list = []
    indices: list = []
    values: list = []
    nnz = 0
    for line in chunk.split(b"\n"):
        tokens = line.split()
        if not tokens:
            continue
        try:
            labels.append(float(tokens[0]))
        except ValueError as e:
            raise Error(f"libfm: bad label {tokens[0]!r}") from e
        for tok in tokens[1:]:
            parts = tok.split(b":")
            if len(parts) < 2:
                raise Error(f"libfm: bad token {tok!r}")
            fields.append(int(parts[0]))
            indices.append(int(parts[1]))
            values.append(float(parts[2]) if len(parts) > 2 else 1.0)
            nnz += 1
        offsets.append(nnz)
    return {
        "offset": np.asarray(offsets, np.int64),
        "label": np.asarray(labels, np.float32),
        "index": np.asarray(indices, np.int64),
        "value": np.asarray(values, np.float32),
        "weight": None,
        "qid": None,
        "field": np.asarray(fields, np.int32),
    }
