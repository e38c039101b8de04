"""Crash-safe on-disk memo store behind the ``Explorer._store`` interface.

The Explorer memoizes every stage in a plain dict keyed by stable
content hashes (stage name + graph fingerprints + the config fields that
stage reads).  :class:`DiskStore` is a drop-in ``MutableMapping`` over
the same keys that write-throughs each entry to its own file, so a
``kill -9`` mid-run loses at most the stage that was executing — the
next invocation with the same store directory resumes from every
completed stage and produces bit-identical records (CI-asserted).

Entry file layout (``<dir>/<keyhash>.entry``):

* line 1 — a JSON header: ``{"magic": "repro-store", "schema": 1,
  "stage": ..., "sha256": <payload digest>, "size": <payload bytes>}``
* the raw pickled ``(key, value)`` payload.

Durability and integrity:

* writes go to a temp file in the same directory, are flushed +
  fsynced, then :func:`os.replace`'d into place — an entry is either
  fully present or absent, never half-written;
* on open, every entry is checksum-verified before being trusted;
  corrupted / truncated / undecodable files are moved to
  ``<dir>/quarantine/`` (kept for post-mortems, never read again) and
  their keys simply recompute;
* values that cannot be pickled (stale jit handles, etc.) stay
  memoized in memory only, counted by ``store.unpicklable``.

Cross-process safety (the serving layer runs multiple server processes
over one store directory):

* every mutation holds an advisory file lock (``<dir>/.lock``,
  :mod:`fcntl` ``flock``; an ``O_EXCL`` spin when flock is missing), so
  concurrent writers serialize instead of racing quarantine moves;
* a miss *read-throughs* the directory before recomputing — an entry
  another process committed after our open is verified, adopted, and
  counted as ``store.readthrough``.

For sharing one store between threads of a single process (the serving
batcher's executor thread next to its event loop), wrap it in
:class:`ThreadSafeStore`.

Metrics (on the optional registry): ``store.load`` / ``store.hit`` /
``store.miss`` / ``store.write`` / ``store.quarantined`` /
``store.unpicklable`` / ``store.delete`` / ``store.readthrough``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, MutableMapping, Optional, Tuple

from ..errors import StoreCorruption
from .. import faultinject

try:                                   # POSIX; the O_EXCL spin covers the rest
    import fcntl as _fcntl
except ImportError:                    # pragma: no cover - non-POSIX
    _fcntl = None

__all__ = ["DiskStore", "FileLock", "ThreadSafeStore", "MAGIC",
           "STORE_SCHEMA"]

MAGIC = "repro-store"
STORE_SCHEMA = 1
_SUFFIX = ".entry"
_WRITE_SITE = "store.write"


class FileLock:
    """Advisory cross-process mutex on a lockfile.

    ``flock``-based where available (the lock dies with the process, so
    a ``kill -9`` never wedges the store); otherwise an ``O_EXCL``
    create-spin with a staleness timeout.  Not reentrant; hold briefly
    around individual store mutations.
    """

    def __init__(self, path: str, *, timeout_s: float = 30.0) -> None:
        self.path = path
        self.timeout_s = timeout_s
        self._fd: Optional[int] = None

    def acquire(self) -> None:
        if self._fd is not None:
            raise RuntimeError(f"FileLock({self.path!r}) is not reentrant")
        if _fcntl is not None:
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                _fcntl.flock(fd, _fcntl.LOCK_EX)
            except BaseException:
                os.close(fd)
                raise
            self._fd = fd
            return
        deadline = time.monotonic() + self.timeout_s
        while True:                    # pragma: no cover - non-POSIX path
            try:
                self._fd = os.open(self.path,
                                   os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o644)
                return
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not acquire {self.path} within "
                        f"{self.timeout_s}s (stale lock from a dead "
                        f"writer? remove it by hand)")
                time.sleep(0.005)

    def release(self) -> None:
        fd, self._fd = self._fd, None
        if fd is None:
            return
        if _fcntl is not None:
            _fcntl.flock(fd, _fcntl.LOCK_UN)
            os.close(fd)
        else:                          # pragma: no cover - non-POSIX path
            os.close(fd)
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _key_filename(key: Any) -> str:
    """Stable filename for a content key (keys are tuples of str/int
    whose ``repr`` is deterministic across processes)."""
    return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()[:32] + _SUFFIX


class DiskStore(MutableMapping):
    """Persistent, checksummed, crash-safe memo store.

    Slots into ``Explorer(store=DiskStore(path))`` — the pipeline sees
    an ordinary dict.  All reads are served from memory (the directory
    is scanned once at open); writes go through to disk atomically.
    """

    def __init__(self, path: str, *, metrics: Any = None) -> None:
        self.path = str(path)
        self.quarantine_dir = os.path.join(self.path, "quarantine")
        self.lock_path = os.path.join(self.path, ".lock")
        self._metrics = metrics
        self._mem: Dict[Any, Any] = {}
        self._unpicklable: set = set()
        os.makedirs(self.path, exist_ok=True)
        self._load_all()

    def _lock(self) -> FileLock:
        """A fresh (non-nested) cross-process lock for one mutation."""
        return FileLock(self.lock_path)

    # -- metrics ---------------------------------------------------------
    def _inc(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc(name, n)

    # -- load / verify ---------------------------------------------------
    def _load_all(self) -> None:
        for fname in sorted(os.listdir(self.path)):
            if not fname.endswith(_SUFFIX):
                continue
            fpath = os.path.join(self.path, fname)
            try:
                key, value = self._read_entry(fpath)
            except Exception as e:  # corrupt header, checksum, pickle...
                self._quarantine(fpath, reason=repr(e))
                continue
            self._mem[key] = value
            self._inc("store.load")

    def _read_entry(self, fpath: str) -> Tuple[Any, Any]:
        with open(fpath, "rb") as f:
            header_line = f.readline()
            try:
                header = json.loads(header_line)
            except Exception:
                raise StoreCorruption(f"undecodable header in {fpath}")
            if not isinstance(header, dict) or header.get("magic") != MAGIC:
                raise StoreCorruption(f"bad magic in {fpath}")
            if header.get("schema") != STORE_SCHEMA:
                raise StoreCorruption(
                    f"store schema {header.get('schema')!r} != "
                    f"{STORE_SCHEMA} in {fpath}")
            payload = f.read()
        if len(payload) != header.get("size"):
            raise StoreCorruption(
                f"truncated payload in {fpath}: "
                f"{len(payload)} != {header.get('size')} bytes")
        digest = hashlib.sha256(payload).hexdigest()
        if digest != header.get("sha256"):
            raise StoreCorruption(f"checksum mismatch in {fpath}")
        key, value = pickle.loads(payload)
        return key, value

    def _quarantine(self, fpath: str, reason: str) -> None:
        os.makedirs(self.quarantine_dir, exist_ok=True)
        dest = os.path.join(self.quarantine_dir, os.path.basename(fpath))
        try:
            os.replace(fpath, dest)
            with open(dest + ".reason", "w") as f:
                f.write(reason + "\n")
        except OSError:
            pass
        self._inc("store.quarantined")

    # -- write path ------------------------------------------------------
    def _write_entry(self, key: Any, value: Any) -> bool:
        try:
            payload = pickle.dumps((key, value), protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            self._unpicklable.add(_key_filename(key))
            self._inc("store.unpicklable")
            return False
        header = json.dumps({
            "magic": MAGIC, "schema": STORE_SCHEMA,
            "stage": key[0] if isinstance(key, tuple) and key else None,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "size": len(payload),
        }, sort_keys=True).encode("utf-8") + b"\n"
        fname = _key_filename(key)
        fpath = os.path.join(self.path, fname)
        with self._lock():
            fd, tmp = tempfile.mkstemp(prefix=fname + ".", suffix=".tmp",
                                       dir=self.path)
            try:
                with io.FileIO(fd, "wb", closefd=True) as f:
                    f.write(header)
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, fpath)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        # Fault injection: simulate a torn write by truncating the entry
        # we just committed (the next open must quarantine + recompute).
        if faultinject.consume_flag(_WRITE_SITE):
            with open(fpath, "r+b") as f:
                f.truncate(max(0, os.path.getsize(fpath) - 7))
        self._inc("store.write")
        return True

    def _read_through(self, key: Any) -> bool:
        """Adopt an entry another process committed after our open.

        Returns True when the key is now in memory.  A corrupt file is
        quarantined (and the key recomputes); a filename-prefix
        collision with a different key is treated as a miss.
        """
        fpath = os.path.join(self.path, _key_filename(key))
        if not os.path.exists(fpath):
            return False
        try:
            k, value = self._read_entry(fpath)
        except Exception as e:
            self._quarantine(fpath, reason=repr(e))
            return False
        if k != key:
            return False
        self._mem[k] = value
        self._inc("store.readthrough")
        return True

    # -- MutableMapping --------------------------------------------------
    def __getitem__(self, key: Any) -> Any:
        if key not in self._mem and not self._read_through(key):
            self._inc("store.miss")
            raise KeyError(key)
        self._inc("store.hit")
        return self._mem[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        faultinject.fire(_WRITE_SITE, key=key[0] if isinstance(key, tuple)
                         and key else key)
        self._write_entry(key, value)
        self._mem[key] = value

    def __delitem__(self, key: Any) -> None:
        del self._mem[key]
        fpath = os.path.join(self.path, _key_filename(key))
        with self._lock():
            try:
                os.unlink(fpath)
            except FileNotFoundError:
                pass
        self._inc("store.delete")

    def __contains__(self, key: Any) -> bool:
        hit = key in self._mem or self._read_through(key)
        self._inc("store.hit" if hit else "store.miss")
        return hit

    def __iter__(self) -> Iterator[Any]:
        return iter(list(self._mem))

    def __len__(self) -> int:
        return len(self._mem)

    def __repr__(self) -> str:
        return (f"DiskStore({self.path!r}, entries={len(self._mem)}, "
                f"unpicklable={len(self._unpicklable)})")


class ThreadSafeStore(MutableMapping):
    """RLock facade making any memo store shareable across threads.

    The serving layer's batcher mutates its store from an executor
    thread while the event loop (or a second batcher) may read it;
    ``ThreadSafeStore(DiskStore(path))`` gives every mapping operation
    a process-level mutex on top of DiskStore's cross-*process* file
    lock.  Wraps plain dicts just as well for in-memory services.
    """

    def __init__(self, inner: MutableMapping) -> None:
        self.inner = inner
        self._mutex = threading.RLock()

    def __getitem__(self, key: Any) -> Any:
        with self._mutex:
            return self.inner[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        with self._mutex:
            self.inner[key] = value

    def __delitem__(self, key: Any) -> None:
        with self._mutex:
            del self.inner[key]

    def __contains__(self, key: Any) -> bool:
        with self._mutex:
            return key in self.inner

    def __iter__(self) -> Iterator[Any]:
        with self._mutex:
            return iter(list(self.inner))

    def __len__(self) -> int:
        with self._mutex:
            return len(self.inner)

    def __repr__(self) -> str:
        return f"ThreadSafeStore({self.inner!r})"
