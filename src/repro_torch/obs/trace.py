"""Nested span tracing with Chrome trace-event / flat-jsonl export.

Zero-dependency, off by default.  Call :func:`enable` to install a
process-global :class:`Tracer`; instrumented code wraps work in

    with span("pnr", variant="PE_3x3", app="conv4"):
        ...

When tracing is disabled, :func:`span` returns a shared no-op context
manager singleton — no allocation, no clock reads — so instrumentation
left in hot paths costs ~nothing.  When enabled, spans collect into a
tree (exception-safe: a raising body still closes its span and records
the error) and export as

* Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable in
  Perfetto / ``chrome://tracing``; nesting is encoded by time
  containment on a single track, with extra tracks (``tid``) for
  out-of-band events such as kernel builds;
* flat jsonl — one object per span with its slash-joined ``path``,
  depth, start, duration, and attrs (consumed by
  ``results/make_tables.py stages``).

The tracer is single-process, single-thread by design (the pipeline is);
timestamps come from ``time.perf_counter`` relative to tracer creation.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "span", "event", "enable", "disable",
           "current"]


class Span:
    """One timed region; ``children`` makes the tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "error")

    def __init__(self, name: str, t0: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.attrs: Dict[str, Any] = attrs or {}
        self.children: List[Span] = []
        self.error: str = ""

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, dur={self.dur:.6f}, "
                f"children={len(self.children)})")


class _SpanCtx:
    """Context manager that opens/closes one span on the tracer stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", sp: Span):
        self._tracer = tracer
        self._span = sp

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.error = f"{exc_type.__name__}: {exc}"
        self._tracer._pop(self._span)
        return False            # never suppress


class _NullCtx:
    """Shared do-nothing context manager used while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_CTX = _NullCtx()


class Tracer:
    """Collects a forest of spans; exports Chrome JSON and flat jsonl."""

    def __init__(self):
        self._origin = time.perf_counter()
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        # out-of-band complete events (e.g. XLA compiles): extra tracks
        self._tracks: Dict[str, List[Span]] = {}

    # -- recording ---------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._origin

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, Span(name, self.now(), attrs or None))

    def event(self, name: str, **attrs: Any) -> Span:
        """Zero-duration marker attached at the current tree position."""
        sp = Span(name, self.now(), attrs or None)
        (self._stack[-1].children if self._stack else self.roots).append(sp)
        return sp

    def add_complete(self, name: str, t0: float, dur: float,
                     track: str = "main", **attrs: Any) -> Span:
        """Record an already-finished region on a named side track."""
        sp = Span(name, t0, attrs or None)
        sp.t1 = t0 + dur
        self._tracks.setdefault(track, []).append(sp)
        return sp

    def _push(self, sp: Span) -> None:
        sp.t0 = sp.t1 = self.now()
        (self._stack[-1].children if self._stack else self.roots).append(sp)
        self._stack.append(sp)

    def _pop(self, sp: Span) -> None:
        sp.t1 = self.now()
        # exception-safe even if an inner span leaked: unwind to `sp`
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
            top.t1 = sp.t1

    # -- queries -----------------------------------------------------------
    def iter_spans(self) -> Iterator[tuple]:
        """Yield ``(span, depth, path)`` depth-first over the main tree."""

        def walk(sp: Span, depth: int, prefix: str):
            path = f"{prefix}/{sp.name}" if prefix else sp.name
            yield sp, depth, path
            for ch in sp.children:
                yield from walk(ch, depth + 1, path)

        for root in self.roots:
            yield from walk(root, 0, "")

    def span_names(self) -> set:
        names = {sp.name for sp, _, _ in self.iter_spans()}
        for track in self._tracks.values():
            names.update(sp.name for sp in track)
        return names

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (``ph: "X"`` complete events)."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "pipeline"}}]

        def emit(sp: Span, tid: int) -> None:
            args = dict(sp.attrs)
            if sp.error:
                args["error"] = sp.error
            events.append({
                "ph": "X", "name": sp.name, "cat": "repro",
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round(max(sp.dur, 0.0) * 1e6, 3),
                "pid": 1, "tid": tid, "args": args})

        for sp, _, _ in self.iter_spans():
            emit(sp, 1)
        for i, (track, spans) in enumerate(sorted(self._tracks.items())):
            tid = 2 + i
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
            for sp in spans:
                emit(sp, tid)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        doc = self.to_chrome()
        # every exported trace records what environment produced it
        from .manifest import capture
        doc["metadata"] = {"manifest": capture().to_dict()}
        with open(path, "w") as fh:
            json.dump(doc, fh)

    def to_rows(self) -> List[Dict[str, Any]]:
        """Flat rows for jsonl export (main tree + side tracks)."""
        rows = [{"name": sp.name, "path": path, "depth": depth,
                 "t0_s": round(sp.t0, 9), "dur_s": round(sp.dur, 9),
                 "error": sp.error, "attrs": sp.attrs}
                for sp, depth, path in self.iter_spans()]
        for track, spans in sorted(self._tracks.items()):
            rows.extend({"name": sp.name, "path": f"{track}/{sp.name}",
                         "depth": 1, "t0_s": round(sp.t0, 9),
                         "dur_s": round(sp.dur, 9), "error": sp.error,
                         "attrs": sp.attrs, "track": track}
                        for sp in spans)
        return rows

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for row in self.to_rows():
                fh.write(json.dumps(row) + "\n")


# ---------------------------------------------------------------------------
# process-global switch
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def enable() -> Tracer:
    """Install (or return) the process-global tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Stop tracing; returns the tracer so callers can still export it."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **attrs: Any):
    """Open a span on the global tracer, or a shared no-op when off."""
    t = _TRACER
    if t is None:
        return _NULL_CTX
    return t.span(name, **attrs)


def event(name: str, **attrs: Any) -> Optional[Span]:
    """Zero-duration marker on the global tracer (no-op when off)."""
    t = _TRACER
    if t is None:
        return None
    return t.event(name, **attrs)
