"""PerfDB — the performance database (paper §4.2.5).

Append-only JSONL (one record per benchmark result) + in-memory query /
aggregation API.  The paper uses MongoDB; a cluster deployment would swap
the storage backend behind the same interface — the schema is the point.

A copy of ``repro.core.perfdb``, importing only ``repro_torch``.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


class PerfDB:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        if self.path and self.path.exists():
            with self.path.open() as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._records.append(json.loads(line))

    # ---- write ------------------------------------------------------------
    def append(self, record: Dict[str, Any]) -> None:
        """Write-through append: memory + JSONL line under one lock.

        The line is serialized outside the file write and emitted as a
        single ``write`` followed by a flush, so concurrent executor
        workers appending from different threads can never interleave
        partial JSONL lines.
        """
        record = dict(record)
        record.setdefault("ts", time.time())
        line = json.dumps(record) + "\n"
        with self._lock:
            self._records.append(record)
            if self.path:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with self.path.open("a") as f:
                    f.write(line)
                    f.flush()

    def insert(self, record: Dict[str, Any]) -> None:
        """Alias of :meth:`append` (the original name)."""
        self.append(record)

    # ---- query ------------------------------------------------------------
    @staticmethod
    def get_path(record: Dict[str, Any], key: str) -> Any:
        """Dotted-path lookup into a nested record (``"result.p99_s"``).

        Returns ``None`` when any path component is missing or the node
        it names is not a dict — dotted filters are first-class in both
        :meth:`query` and the analysis heat maps.
        """
        node = record
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    def query(self, **eq) -> List[Dict[str, Any]]:
        """Equality filter over (possibly dotted) record keys."""
        return [r for r in self._records
                if all(self.get_path(r, k) == v for k, v in eq.items())]

    def all(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def distinct(self, key: str) -> List[Any]:
        seen = []
        for r in self.query():
            v = r.get(key)
            if v not in seen:
                seen.append(v)
        return seen

    def __len__(self) -> int:
        return len(self._records)
