"""Scrape endpoint: GET /metrics (Prometheus text) and GET /healthz (JSON)
(counterpart of paddle_tpu/observability/serve.py).

One stdlib ThreadingHTTPServer and a daemon thread; port 0 binds an
ephemeral port. `metrics_body` is shared with the serving front end
(serving/server.py), so both scrape surfaces render alike; the serving
front end starts a MetricsServer on FLAGS_serving_metrics_port. A
training process starts the process-wide one on FLAGS_metrics_port
(`maybe_start_from_flags`, called by the ResilientTrainer), and its
/healthz answers 503 while the trainer's anomaly engine
(`set_health_engine`) has fired in the last few minutes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from . import memory, sinks, telemetry
from .registry import default_registry
from ..core.flags import define_flag, get_flag

define_flag(
    "metrics_port", 0,
    "Serve /metrics (Prometheus text) and /healthz (JSON run health) on "
    "this port from inside the training process; 0 disables the endpoint.")

ANOMALY_RECENT_S = 300.0  # healthz: anomalies within this window count


def metrics_body() -> bytes:
    """The GET /metrics body: the registry as Prometheus text, the memory
    gauges refreshed per scrape."""
    memory.update_memory_gauges()
    return sinks.prometheus_text(default_registry()).encode()


def health_snapshot() -> Dict[str, Any]:
    """The process's /healthz body: up, and how many telemetry events it
    wrote ("idle" before the first). The serving front end's own /healthz
    reads the engine (serving/observability.py)."""
    n = telemetry.get_telemetry().records_emitted
    out = {"status": "ok" if n else "idle", "ok": True,
           "records_emitted": n}
    eng = _engine_ref
    if eng is not None:
        now = time.time()
        recent = [a for a in eng.recent()
                  if now - float(a.get("ts", 0)) <= ANOMALY_RECENT_S]
        out["anomalies_recent"] = len(recent)
        if recent:
            out["status"], out["ok"] = "anomalous", False
            out["last_anomaly"] = {k: v for k, v in recent[-1].items()
                                   if k in ("kind", "step", "value")}
    return out


_engine_ref: Optional[Any] = None


def set_health_engine(engine) -> None:
    """Point /healthz at the live AnomalyEngine (the ResilientTrainer
    does)."""
    global _engine_ref
    _engine_ref = engine


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch_metrics/1.0"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._reply(200, metrics_body(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/healthz", "/health"):
            snap = health_snapshot()
            self._reply(200 if snap["ok"] else 503,
                        json.dumps(snap).encode(), "application/json")
        else:
            self._reply(404, b'{"error": "not found"}', "application/json")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                    # the client left; nothing to answer

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass


class MetricsServer:
    """Owns the HTTP server and its daemon thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="metrics-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __repr__(self):  # pragma: no cover
        return f"MetricsServer(port={self.port})"


_server: Optional[MetricsServer] = None
_server_lock = threading.Lock()


def start_metrics_server(port: Optional[int] = None) -> MetricsServer:
    """Start (or return) the process-wide server. port=None reads
    FLAGS_metrics_port; port=0 binds an ephemeral port (tests)."""
    global _server
    with _server_lock:
        if _server is None:
            _server = MetricsServer(int(get_flag("metrics_port"))
                                    if port is None else port)
        return _server


def maybe_start_from_flags() -> Optional[MetricsServer]:
    """FLAGS_metrics_port > 0: the server; else None. Idempotent, and a
    bind error becomes an event, not a dead training job."""
    p = int(get_flag("metrics_port"))
    if p <= 0:
        return None
    try:
        return start_metrics_server(p)
    except OSError as e:
        telemetry.get_telemetry().event(
            "metrics_server_error", port=p, error=f"{type(e).__name__}: {e}")
        return None


def reset() -> None:
    """Stop and drop the process-wide server and the health engine."""
    global _server, _engine_ref
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
    _engine_ref = None
