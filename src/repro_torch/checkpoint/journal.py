"""FL round journal: crash-consistent record of per-round transport state.

The server appends an entry per state transition (round started, client
update ingested, round finalized). On restart, the journal tells the server
which round to resume, which client updates were already aggregated, and
which transactions were in flight (those clients simply retransmit —
MUDP's receiver dedups by (addr, txn), so replays are idempotent).
"""

from __future__ import annotations

import json
import os
from typing import Optional


class FLJournal:
    def __init__(self, path: str):
        self.path = path
        self._entries: list[dict] = []
        if os.path.exists(path):
            with open(path) as f:
                self._entries = [json.loads(l) for l in f if l.strip()]

    def append(self, kind: str, **fields) -> None:
        entry = {"kind": kind, **fields}
        self._entries.append(entry)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- writers ------------------------------------------------------------
    def round_started(self, round_idx: int, roster: list[str]) -> None:
        self.append("round_started", round=round_idx, roster=roster)

    def update_ingested(self, round_idx: int, client: str) -> None:
        self.append("update_ingested", round=round_idx, client=client)

    def round_finalized(self, round_idx: int, ckpt: str,
                        arrived: list[str], failed: list[str]) -> None:
        self.append("round_finalized", round=round_idx, ckpt=ckpt,
                    arrived=arrived, failed=failed)

    # -- recovery ----------------------------------------------------------
    def last_finalized_round(self) -> Optional[int]:
        for e in reversed(self._entries):
            if e["kind"] == "round_finalized":
                return e["round"]
        return None

    def last_checkpoint(self) -> Optional[str]:
        for e in reversed(self._entries):
            if e["kind"] == "round_finalized":
                return e["ckpt"]
        return None

    def resume_round(self) -> int:
        last = self.last_finalized_round()
        return 0 if last is None else last + 1

    def pending_clients(self) -> list[str]:
        """Clients whose round-in-progress update never finalized."""
        started: Optional[dict] = None
        for e in self._entries:
            if e["kind"] == "round_started":
                started = e
            elif e["kind"] == "round_finalized":
                started = None
        if started is None:
            return []
        done = {e["client"] for e in self._entries
                if e["kind"] == "update_ingested"
                and e["round"] == started["round"]}
        return [c for c in started["roster"] if c not in done]
