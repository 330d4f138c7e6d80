"""Structured record logging: console + CSV (counterpart of
livevisionkit_tpu/utils/logging.py, kept as the port's own copy).

Reference parity: ``lvk::Logger`` — a stream-oriented logger with record /
object framing and hold/resume (reference Logging/Logger.hpp:27-92) — and
``lvk::CSVLogger`` (Logging/CSVLogger.hpp:27-41).  Host code only.
"""

from __future__ import annotations

import csv
import io
import sys
from typing import Any, Iterable, TextIO


class RecordLogger:
    """Writes records (one line each) of delimited values to a text stream.

    Values within a record are separated by the value delimiter, records
    end with the record delimiter, and `begin_object()`/`end_object()` wrap
    a group of values in object delimiters.  `hold()` buffers output until
    `resume()`.
    """

    def __init__(
        self,
        stream: TextIO | None = None,
        delimiter: str = " ",
        record_delimiter: str = "\n",
        object_open: str = "{",
        object_close: str = "}",
    ):
        self._stream = stream if stream is not None else sys.stderr
        self._delim = delimiter
        self._rdelim = record_delimiter
        self._obj = (object_open, object_close)
        self._held: io.StringIO | None = None
        self._in_record = False
        self._depth = 0

    def _out(self) -> TextIO:
        return self._held if self._held is not None else self._stream

    def _emit(self, text: str) -> None:
        if self._in_record:
            self._out().write(self._delim)
        self._out().write(text)
        self._in_record = True

    def write(self, *values: Any) -> None:
        """Append values to the current record (no record break)."""
        for v in values:
            self._emit(str(v))

    def begin_object(self) -> None:
        self._emit(self._obj[0])
        self._in_record = False  # no delimiter right after the open
        self._depth += 1

    def end_object(self) -> None:
        if self._depth <= 0:
            raise RuntimeError("end_object without begin_object")
        self._out().write(self._obj[1])
        self._in_record = True
        self._depth -= 1

    def end_record(self) -> None:
        if self._depth != 0:
            raise RuntimeError("record break inside an object")
        self._out().write(self._rdelim)
        self._in_record = False

    def record(self, *values: Any) -> None:
        """Write a complete record: values + record delimiter."""
        self.write(*values)
        self.end_record()

    def hold(self) -> None:
        if self._held is None:
            self._held = io.StringIO()

    def resume(self) -> None:
        if self._held is not None:
            self._stream.write(self._held.getvalue())
            self._held = None


class CSVLogger:
    """CSV record logger with a lazily written header row."""

    def __init__(self, path: str, fieldnames: Iterable[str]):
        self.path = path
        self.fieldnames = list(fieldnames)
        self._file: TextIO | None = None
        self._writer = None

    def _ensure(self):
        if self._file is None:
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=self.fieldnames)
            self._writer.writeheader()

    def record(self, **values: Any) -> None:
        self._ensure()
        self._writer.writerow({k: values.get(k, "") for k in self.fieldnames})

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
