"""Corpus-job manifest: checkpoint/resume for large decode runs.

SURVEY.md §5: checkpoint/resume is ABSENT in the reference; required here so
a 10k-image multi-host corpus decode can resume after preemption. The
manifest is an append-only JSONL of completed work items — crash-safe
(partial final lines are ignored) and mergeable across hosts (each host
writes ``manifest.<process_index>.jsonl``).
"""

from __future__ import annotations

import json
import os
import time


class Manifest:
    def __init__(self, path: str, process_index: int = 0):
        self.path = f"{path}.{process_index}.jsonl"
        self._done: dict[str, dict] = {}
        self._load()
        self._fh = open(self.path, "a")

    def _load(self):
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line from a crash
                self._done[rec["item"]] = rec

    def is_done(self, item: str) -> bool:
        return item in self._done

    def pending(self, items) -> list:
        return [i for i in items if str(i) not in self._done]

    def mark_done(self, item: str, **info) -> None:
        # Completion timestamp: resume diagnostics and steady-state
        # throughput measurements read it.
        rec = {"item": str(item), "ts": round(time.time(), 3), **info}
        self._done[str(item)] = rec
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    @property
    def done_count(self) -> int:
        return len(self._done)

    def close(self):
        self._fh.close()
