"""Row-flushed TSV metric/output writer
(reference: mrgcn/data/io/tsv.py:7-55)."""

from __future__ import annotations

import csv
import io
import os


class TSV:
    def __init__(self, path: str, mode: str = "w", dry_run: bool = False):
        self.dry_run = dry_run
        if dry_run:
            self._file = io.StringIO()
        else:
            self._file = open(path, mode, newline="")
        self._writer = csv.writer(self._file, delimiter="\t")

    def writerow(self, row) -> None:
        self._writer.writerow(row)
        self._file.flush()
        if not self.dry_run:
            os.fsync(self._file.fileno())

    def writerows(self, rows) -> None:
        for row in rows:
            self.writerow(row)

    def close(self) -> None:
        self._file.close()
