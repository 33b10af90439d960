"""Pull-based HTTP ops endpoint — one per process.

The port's copy of the JAX package's `telemetry/opsserver.py`, with the
same routes:

``/metrics``
    Prometheus text exposition (format 0.0.4) of every declared live
    metric — what a fleet scraper collects.
``/varz``
    Full JSON snapshot: every backing counter (flat histogram keys
    included), every evaluated gauge, recorder ring stats — the
    "give me everything" incident view.
``/healthz``
    Liveness + per-component health from the registered providers
    (producer/worker supervision state, per-bucket compile status,
    serving queue).  HTTP 200 when every component is healthy, 503
    otherwise — load-balancer-pollable.
``/timeseries``
    Windowed JSON history from the process `TimeSeriesStore` rings
    (``?names=a,b`` filters by key/prefix, ``?window_s=60`` bounds
    the lookback) — what a controller plots instead of point samples.
``/fleet``
    Federated exposition from an attached `FleetScraper` (per-replica
    ``replica=`` labels + ``glt_fleet_*`` aggregates); ``?format=json``
    returns the per-replica healthz rollup instead.  404 until a
    scraper is attached with `OpsServer.attach_fleet`.
``/traces``
    Index of tail-retained request traces from the process tracer
    (`telemetry.tracing` — slow/failed/sampled requests only).
``/trace?trace_id=``
    One trace's spans.  With a fleet scraper attached the spans are
    assembled across EVERY replica; ``?format=chrome`` renders the
    Perfetto-loadable Chrome trace-event object instead of raw spans.

Serving model: a `ThreadingHTTPServer` with daemon threads, so a
slow, stalled or chaos-delayed scrape occupies ITS OWN thread and can
never block the serving executor or a fused dispatch (pinned by the
``ops.scrape`` chaos site + test).  Scrapes read shared state only
through lock-guarded snapshots (`Metrics.snapshot`, gauge callbacks),
so they are consistent but never hold a hot-path lock across I/O.

Enable with ``GLT_OPS_PORT`` (**0 = disabled, the default** — the
data plane is byte-identical with the plane off).
`maybe_start_from_env` is called by the `ServingFrontend` and the bench
scripts; the first caller binds, the rest share the process singleton.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

OPS_PORT_ENV = 'GLT_OPS_PORT'
OPS_HOST_ENV = 'GLT_OPS_HOST'
DEFAULT_HOST = '127.0.0.1'


def ops_port_from_env() -> int:
  try:
    return int(os.environ.get(OPS_PORT_ENV, '0'))
  except ValueError:
    return 0


def ops_host_from_env() -> str:
  return os.environ.get(OPS_HOST_ENV) or DEFAULT_HOST


class _OpsHandler(BaseHTTPRequestHandler):
  server_version = 'glt-ops/1'
  protocol_version = 'HTTP/1.1'

  def do_GET(self):                 # noqa: N802 — http.server API
    from ..testing import chaos
    registry = self.server.registry           # type: ignore[attr-defined]
    parsed = urlparse(self.path)
    path = parsed.path
    query = parse_qs(parsed.query)
    try:
      # chaos seam: a 'delay' stalls THIS handler thread (the
      # serving/fused hot paths must not notice), a 'drop' turns the
      # scrape into a 503 — the scraper's problem, nobody else's
      chaos.ops_scrape_check(path)
      self.server.scrapes.inc()               # type: ignore[attr-defined]
      if path == '/metrics':
        body = registry.prometheus_text().encode('utf-8')
        ctype = 'text/plain; version=0.0.4; charset=utf-8'
        status = 200
      elif path == '/varz':
        body = (json.dumps(registry.varz(), default=repr, indent=1)
                + '\n').encode('utf-8')
        ctype = 'application/json'
        status = 200
      elif path == '/healthz':
        health = registry.healthz()
        body = (json.dumps(health, default=repr, indent=1)
                + '\n').encode('utf-8')
        ctype = 'application/json'
        status = 200 if health.get('ok') else 503
      elif path == '/timeseries':
        from . import timeseries
        store = timeseries.global_store()
        if store is None:
          body = ('no time-series store in this process — set '
                  'GLT_OPS_PORT via maybe_start_from_env or call '
                  'timeseries.ensure_global()\n').encode('utf-8')
          ctype = 'text/plain'
          status = 404
        else:
          names = None
          if query.get('names'):
            names = [n for n in query['names'][0].split(',') if n]
          window_s = None
          if query.get('window_s'):
            try:
              window_s = float(query['window_s'][0])
            except ValueError:
              window_s = None
          body = (json.dumps(store.query(names=names,
                                         window_s=window_s),
                             indent=1) + '\n').encode('utf-8')
          ctype = 'application/json'
          status = 200
      elif path == '/fleet':
        fleet = getattr(self.server, 'fleet', None)
        if fleet is None:
          body = ('no fleet scraper attached — call '
                  'OpsServer.attach_fleet(FleetScraper(...))\n'
                  ).encode('utf-8')
          ctype = 'text/plain'
          status = 404
        elif query.get('format', ['prom'])[0] == 'json':
          rollup = fleet.fleet_json()
          body = (json.dumps(rollup, default=repr, indent=1)
                  + '\n').encode('utf-8')
          ctype = 'application/json'
          status = 200 if rollup.get('ok') else 503
        else:
          body = fleet.prometheus_text().encode('utf-8')
          ctype = 'text/plain; version=0.0.4; charset=utf-8'
          status = 200
      elif path == '/traces':
        from .tracing import tracer
        body = (json.dumps({'traces': tracer.traces(),
                            'stats': tracer.stats()},
                           indent=1) + '\n').encode('utf-8')
        ctype = 'application/json'
        status = 200
      elif path == '/trace':
        from .tracing import tracer
        tid = (query.get('trace_id') or [''])[0]
        fleet = getattr(self.server, 'fleet', None)
        if fleet is not None:
          spans = fleet.fetch_trace(tid)
        else:
          spans = tracer.spans_of(tid)
        if not tid or not spans:
          body = (f'no retained trace {tid!r} — see /traces for the '
                  'index (only slow/failed/sampled requests are '
                  'kept)\n').encode('utf-8')
          ctype = 'text/plain'
          status = 404
        elif query.get('format', ['json'])[0] == 'chrome':
          from . import export
          from .tracing import spans_to_events
          trace = export.to_chrome_trace(spans_to_events(spans))
          body = (json.dumps(trace) + '\n').encode('utf-8')
          ctype = 'application/json'
          status = 200
        else:
          body = (json.dumps({'trace_id': tid, 'spans': spans},
                             indent=1) + '\n').encode('utf-8')
          ctype = 'application/json'
          status = 200
      else:
        body = (f'no such route {path!r} — try /metrics, /varz, '
                '/healthz, /timeseries, /fleet, /traces, '
                '/trace?trace_id=\n').encode('utf-8')
        ctype = 'text/plain'
        status = 404
    except chaos.InjectedFault as e:
      body = f'{e}\n'.encode('utf-8')
      ctype = 'text/plain'
      status = 503
    except Exception as e:          # noqa: BLE001 — a broken render
      # must answer 500, not silently close the connection
      body = f'{type(e).__name__}: {e}\n'.encode('utf-8')
      ctype = 'text/plain'
      status = 500
    self.send_response(status)
    self.send_header('Content-Type', ctype)
    self.send_header('Content-Length', str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def log_message(self, fmt, *args):  # noqa: A003 — silence stderr
    del fmt, args


class OpsServer:
  """One process's ops endpoint.  ``port=0`` here means "pick an
  ephemeral port" (the env-var convention of 0 = disabled lives in
  `maybe_start_from_env`, not in this explicit constructor)."""

  def __init__(self, registry=None, port: int = 0,
               host: Optional[str] = None):
    if registry is None:
      from .live import live as registry
    self.registry = registry
    self._httpd = ThreadingHTTPServer(
        (host or ops_host_from_env(), max(int(port), 0)), _OpsHandler)
    self._httpd.daemon_threads = True
    self._httpd.registry = registry           # type: ignore[attr-defined]
    self._httpd.scrapes = registry.counter('ops.scrapes_total')  # type: ignore[attr-defined]
    self._httpd.fleet = None                  # type: ignore[attr-defined]
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, daemon=True,
        name='glt-ops-server')
    self._thread.start()

  def attach_fleet(self, scraper) -> None:
    """Expose a `federation.FleetScraper` on the ``/fleet`` route
    (pass None to detach)."""
    self._httpd.fleet = scraper               # type: ignore[attr-defined]

  @property
  def fleet(self):
    return getattr(self._httpd, 'fleet', None)

  @property
  def port(self) -> int:
    return self._httpd.server_address[1]

  @property
  def url(self) -> str:
    host = self._httpd.server_address[0]
    return f'http://{host}:{self.port}'

  def close(self) -> None:
    self._httpd.shutdown()
    self._httpd.server_close()


# -- process singleton -------------------------------------------------------
_global: Optional[OpsServer] = None
_global_lock = threading.Lock()


def maybe_start_from_env() -> Optional[OpsServer]:
  """Start (or return) the process-global ops server per
  ``GLT_OPS_PORT``; None when disabled (0/unset — the default, under
  which the data plane is byte-identical to having no ops plane at
  all).  Called by every server/frontend/bench entry point;
  idempotent, first caller binds.  Also chains the post-mortem
  fatal-signal handler when ``GLT_POSTMORTEM_DIR`` is set — the two
  halves of "observable during the incident"."""
  from . import postmortem
  postmortem.install_signal_handlers()
  port = ops_port_from_env()
  if port <= 0:
    return None
  global _global
  with _global_lock:
    if _global is None:
      try:
        _global = OpsServer(port=port)
        # any process with an ops endpoint gets history for free —
        # the /timeseries route and postmortem rings read this store
        from . import timeseries
        timeseries.ensure_global()
      except OSError as e:
        # observability plumbing must never take the data plane down:
        # a bind failure (EADDRINUSE — two processes inheriting one
        # GLT_OPS_PORT on a host) degrades to no-ops-plane, loudly
        import sys
        print(f'glt-ops: could not bind GLT_OPS_PORT={port} ({e}) — '
              'continuing WITHOUT a live ops endpoint (give each '
              'process its own port, or 0 to silence)',
              file=sys.stderr)
        return None
    return _global


def global_server() -> Optional[OpsServer]:
  return _global


def stop_global() -> None:
  global _global
  with _global_lock:
    if _global is not None:
      _global.close()
      _global = None
      from . import timeseries
      timeseries.stop_global()
