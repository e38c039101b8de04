"""Wire types for the exploration serving front-end.

One request = one client's exploration: a set of application graphs plus
an :class:`~repro_torch.explore.ExploreConfig`.  Requests and responses
travel as newline-delimited JSON (one object per line) over a socket or
stdio — see :mod:`repro_torch.serve.frontend` — or as in-process
:class:`ServeRequest` / :class:`ServeResponse` objects.

Request line::

    {"id": "r1",
     "config": {... ExploreConfig.to_dict() blob ...},
     "apps": {"conv": {... Graph.to_dict() blob ...}}}

``apps`` may be replaced (or extended) by a built-in suite reference:
``{"suite": "ml"}`` or ``{"suite": "image", "select": ["conv2d"]}`` —
the graphs are built server-side, so two clients naming the same suite
app share one content key (and therefore one computation).

Response line::

    {"id": "r1", "ok": true, "cached": false, "schema": <RECORD_SCHEMA>,
     "records": [...], "failures": [...], "elapsed_ms": 12.3}

``records`` rows are schema-versioned :class:`repro_torch.explore.
ExploreRecord` dicts in exactly the order (and with exactly the bytes)
a solo ``Explorer(request.apps, request.config).run()`` would produce —
the serving layer's bit-identity guarantee.  A malformed request gets
``{"ok": false, "error": "..."}`` and never kills the connection.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from ..explore import ExploreConfig
from ..explore.records import RECORD_SCHEMA
from ..graphir.graph import Graph

__all__ = ["PROTOCOL_SCHEMA", "ProtocolError", "ServeRequest",
           "ServeResponse", "parse_request_line", "request_key"]

#: bump when the request/response line shape changes incompatibly
PROTOCOL_SCHEMA = 1


class ProtocolError(ValueError):
    """A request line that can't be parsed — reported as a one-line
    ``{"ok": false}`` response, never a dropped connection."""


def _suite_graphs(suite: str, select=None) -> Dict[str, Graph]:
    from ..apps import image, image_graphs, ml_graphs
    if suite == "ml":
        apps = ml_graphs()
    elif suite == "image":
        apps = image_graphs()
    elif suite == "camera":
        apps = {"camera": image.build_graph("camera")}
    else:
        raise ProtocolError(f"unknown suite {suite!r} (ml | image | camera)")
    if select is not None:
        missing = [n for n in select if n not in apps]
        if missing:
            raise ProtocolError(f"suite {suite!r} has no apps {missing} "
                                f"(has {sorted(apps)})")
        apps = {n: apps[n] for n in select}
    return apps


@dataclass
class ServeRequest:
    """One client exploration: id + app graphs + config.

    The service normalizes ``config.on_error`` to ``"isolate"`` at
    admission (see :class:`repro_torch.serve.frontend.ExploreService`):
    a batched stranger must never be able to fail-fast its batchmates.
    """

    rid: str
    apps: Dict[str, Graph]
    config: ExploreConfig

    def key(self) -> Tuple:
        return request_key(self.apps, self.config)


def request_key(apps: Dict[str, Graph], config: ExploreConfig) -> Tuple:
    """Content identity of one exploration: the config digest plus every
    app's name + structural fingerprint.  Two requests with equal keys
    are the same computation — the batcher coalesces them."""
    from ..explore.pipeline import _digest, graph_key
    return (_digest(config.to_dict()),
            tuple(sorted((name, graph_key(g)) for name, g in apps.items())))


@dataclass
class ServeResponse:
    """What one request gets back (in-process object = wire line)."""

    rid: str
    ok: bool
    records: List[Dict[str, Any]] = field(default_factory=list)
    failures: List[Dict[str, Any]] = field(default_factory=list)
    cached: bool = False
    elapsed_ms: float = 0.0
    error: str = ""

    def record_lines(self) -> List[str]:
        """The response's records as jsonl lines — the byte-level view
        the bit-identity guarantee (solo == batched == cached) is
        asserted on."""
        return [json.dumps(r) for r in self.records]

    def to_dict(self) -> Dict[str, Any]:
        d = {"id": self.rid, "ok": self.ok, "schema": RECORD_SCHEMA,
             "protocol": PROTOCOL_SCHEMA}
        if self.ok:
            d.update(cached=self.cached, records=self.records,
                     failures=self.failures,
                     elapsed_ms=round(self.elapsed_ms, 3))
        else:
            d["error"] = self.error
        return d


def parse_request_line(d: Any) -> ServeRequest:
    """One decoded NDJSON request object -> :class:`ServeRequest`.

    Raises :class:`ProtocolError` (with the offending field named) on
    anything malformed; the caller turns that into an ``ok: false``
    response line.
    """
    from ..explore.config import ConfigFormatError
    if not isinstance(d, dict):
        raise ProtocolError(f"request must be an object, "
                            f"got {type(d).__name__}")
    rid = d.get("id")
    if not isinstance(rid, str) or not rid:
        raise ProtocolError("request needs a non-empty string 'id'")
    op = d.get("op", "explore")
    if op != "explore":
        raise ProtocolError(f"unknown op {op!r} (only 'explore')")

    cfg_blob = d.get("config")
    if not isinstance(cfg_blob, dict):
        raise ProtocolError("request needs a 'config' object "
                            "(ExploreConfig.to_dict() blob)")
    try:
        config = ExploreConfig.from_dict(cfg_blob)
    except ConfigFormatError as e:
        raise ProtocolError(f"bad config: {e}")

    apps: Dict[str, Graph] = {}
    if d.get("suite") is not None:
        apps.update(_suite_graphs(d["suite"], d.get("select")))
    inline = d.get("apps")
    if inline is not None:
        if not isinstance(inline, dict):
            raise ProtocolError("'apps' must map app names to graph blobs")
        for name, blob in inline.items():
            try:
                apps[str(name)] = Graph.from_dict(blob)
            except ValueError as e:
                raise ProtocolError(f"bad graph for app {name!r}: {e}")
    if not apps:
        raise ProtocolError("request has no apps (inline 'apps' and/or "
                            "a 'suite' reference)")
    return ServeRequest(rid=rid, apps=apps, config=config)


def encode_request(rid: str, apps: Dict[str, Graph],
                   config: ExploreConfig) -> Dict[str, Any]:
    """The NDJSON request object for (apps, config) — what a client
    sends; inverse of :func:`parse_request_line`."""
    return {"id": rid, "op": "explore", "config": config.to_dict(),
            "apps": {name: g.to_dict() for name, g in apps.items()}}
