"""Persistent `DetPlan` record store — the durable half of warm-start.

Port of ``repro/checkpoint/plan_store.py``, copied: the same layout,
schema, env-stamp invalidation, deferred blobs and write-behind thread.
One directory per plan family under the store root, named by the plan
key's :func:`stable_key_hash`::

    plan_<16-hex>/
      manifest.json   (schema, env stamp, plan meta, blob names)
      <name>.bin      (optional opaque blobs; the port's engine writes none)

Writes reuse :class:`CheckpointManager`'s atomicity discipline verbatim:
everything lands in a ``.tmp-<name>`` sibling first and is published with
one ``os.replace``, so a crash mid-write never corrupts a published
entry; stale ``.tmp-`` leftovers are swept on init (same
:func:`sweep_stale_tmp` the manager uses).

The store's code is deliberately **stdlib-pure** (no torch, no numpy;
only the shared sweep comes from the manager): callers hand it
plain-JSON metadata and opaque ``bytes`` blobs.  Blob values may also be
zero-arg callables producing bytes — evaluated on the writer thread, so
expensive serialization never runs on the dispatch path.
Validation is by env stamp: a manifest whose ``env`` (for the port's
engine: torch and CUDA versions, the card, the kernel sources' hash) or
schema differs from this process is treated as a miss, never an error —
persistence is an acceleration, not a correctness dependency.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import deque

from .manager import sweep_stale_tmp

__all__ = ["PlanStore", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1


class PlanStore:
    """Atomic on-disk map ``key_hash -> (meta, blobs)`` with async writes.

    Thread-safe: reads touch only the filesystem (published entries are
    immutable snapshots thanks to ``os.replace``); the write queue and
    its counters are guarded state.
    """

    # reprolint lock-discipline registry: the write queue is shared
    # between every planner thread and the background writer.
    _GUARDED_BY = {
        "_pending": ("_lock", "_cv"),
        "_busy": ("_lock", "_cv"),
        "_writer": ("_lock", "_cv"),
        "_closed": ("_lock", "_cv"),
        "_written": ("_lock", "_cv"),
        "_write_errors": ("_lock", "_cv"),
    }

    def __init__(self, directory: str, *, env: dict | None = None):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        sweep_stale_tmp(self.dir)
        # env stamp: plain strings only, compared for equality on read
        self.env = {str(k): str(v) for k, v in dict(env or {}).items()}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: deque = deque()
        self._busy = False
        self._writer: threading.Thread | None = None
        self._closed = False
        self._written = 0
        self._write_errors = 0

    # --------------------------------------------------------------- naming
    @staticmethod
    def entry_name(key_hash: int) -> str:
        return f"plan_{int(key_hash):016x}"

    # ---------------------------------------------------------------- write
    def put(self, key_hash: int, meta: dict, blobs: dict | None = None):
        """Synchronous atomic write (tests / explicit flush points)."""
        self._write_entry(self.entry_name(key_hash), dict(meta),
                          dict(blobs or {}))

    def put_async(self, key_hash: int, meta: dict,
                  blobs: dict | None = None):
        """Enqueue a write for the background thread; never blocks on IO.

        ``blobs`` values may be bytes or zero-arg callables returning
        bytes (or None to skip) — callables run on the writer thread.
        """
        job = (self.entry_name(key_hash), dict(meta), dict(blobs or {}))
        with self._cv:
            if self._closed:
                return
            self._pending.append(job)
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain, name="plan-store-writer", daemon=True)
                self._writer.start()
            self._cv.notify_all()

    def _drain(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:       # closed and drained
                    return
                name, meta, blobs = self._pending.popleft()
                self._busy = True
            ok = True
            try:
                self._write_entry(name, meta, blobs)
            except Exception:   # noqa: BLE001 — persistence must not kill
                ok = False      # the process; the entry is simply absent
            with self._cv:
                self._busy = False
                if ok:
                    self._written += 1
                else:
                    self._write_errors += 1
                self._cv.notify_all()

    def _write_entry(self, name: str, meta: dict, blobs: dict):
        tmp = os.path.join(self.dir, f".tmp-{name}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        written_blobs = []
        for bname, blob in blobs.items():
            if callable(blob):              # deferred serialization
                blob = blob()
            if blob is None:                # serializer declined:
                continue                    # metadata-only
            with open(os.path.join(tmp, f"{bname}.bin"), "wb") as f:
                f.write(blob)
            written_blobs.append(bname)
        manifest = {"schema": SCHEMA_VERSION, "env": self.env,
                    "meta": meta, "blobs": sorted(written_blobs)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def flush(self):
        """Block until every enqueued write has been attempted."""
        with self._cv:
            while self._pending or self._busy:
                self._cv.wait()

    def close(self):
        """Drain outstanding writes and stop the writer thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            w = self._writer
        if w is not None:
            w.join(timeout=30)

    # ----------------------------------------------------------------- read
    def _load_manifest(self, final: str) -> dict | None:
        try:
            with open(os.path.join(final, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(manifest, dict):
            return None
        if manifest.get("schema") != SCHEMA_VERSION:
            return None      # future/foreign layout: miss, not error
        if manifest.get("env") != self.env:
            return None      # other versions/card: plans don't transfer
        if not isinstance(manifest.get("meta"), dict):
            return None
        return manifest

    def get(self, key_hash: int) -> tuple | None:
        """``(meta, blobs)`` for a stored family, or None on any miss —
        absent entry, schema/env mismatch, unreadable blob."""
        final = os.path.join(self.dir, self.entry_name(key_hash))
        manifest = self._load_manifest(final)
        if manifest is None:
            return None
        blobs = {}
        for bname in manifest.get("blobs", []):
            try:
                with open(os.path.join(final, f"{bname}.bin"), "rb") as f:
                    blobs[bname] = f.read()
            except OSError:
                return None
        return dict(manifest["meta"]), blobs

    def families(self) -> list:
        """Metadata of every valid stored family (prefill enumeration)."""
        out = []
        try:
            entries = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for d in entries:
            if not d.startswith("plan_"):
                continue
            manifest = self._load_manifest(os.path.join(self.dir, d))
            if manifest is not None:
                out.append(dict(manifest["meta"]))
        return out

    def stats(self) -> dict:
        entries = sum(1 for d in os.listdir(self.dir)
                      if d.startswith("plan_"))
        with self._cv:
            return {"entries": entries, "written": self._written,
                    "write_errors": self._write_errors,
                    "pending": len(self._pending)}
