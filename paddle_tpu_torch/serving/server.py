"""Stdlib HTTP front ends for the serving engine and the fleet
(counterpart of paddle_tpu/serving/server.py: ServingServer and
FleetServer).

One ThreadingHTTPServer plus daemon threads, no third-party web stack. The
server owns the engine loop thread: handler threads only submit requests
and wait on their events, so concurrent clients are batched continuously by
the one engine loop (the only thread that touches the device).

  POST /generate   {"prompt": [int, ...], "max_new_tokens": 16,
                    "temperature": 0.0, "eos_token_id": null,
                    "tier": "default", "prefill_only": false}
               ->  {"request_id", "output_tokens", "finish_reason",
                    "telemetry": {queue_s, ttft_s, decode_tok_s, ...}}
                   With "stream": true the reply is chunked NDJSON: one
                   {"request_id", "tokens", "done": false} line per flush
                   of the engine's deferred tokens, then a final
                   {"done": true, "finish_reason", "telemetry"} line. A
                   client that disconnects cancels its request.
  POST /kv/export  {"tokens": [...]} -> NDJSON, one line per resident full
                   block of the prefix (chain digest + base64 page bytes)
  POST /kv/ingest  that NDJSON -> {"imported", "dedup", "rejected",
                   "skipped", "bytes"}; chain-hash verified, idempotent
  GET  /stats      the engine's stats(graphs=True), one engine-lock
                   snapshot, plus two keys of the port's own (as stats'
                   "graphs" is), which a process replica's supervisor reads
                   from its child: "launches", this process's launch counts
                   of the serving kernels (ops.gpu.launch_counts), and
                   "memory", the engine's card's allocator bytes (peak
                   and reserved; null on the CPU) and the host RSS
  GET  /metrics    the metrics registry as Prometheus text
  GET  /healthz    200 {"ok": true, status, steps, last_tick_age_s, ...},
                   503 when the engine loop is dead, a serving anomaly fired
                   recently, or the engine has work but has not ticked

A full queue answers 503 with a jittered Retry-After. With
FLAGS_serving_metrics_port > 0, /metrics and /healthz are also served on
that port (observability/serve.py).

FleetServer carries the same /generate over a FleetRouter (no streaming: a
request may move between replicas, so its tokens are final once it
settles), plus POST /drain {"replica": id} (?migrate=1 live-migrates the
replica's sessions; without it FLAGS_fleet_drain_migrate decides) and POST
/resume, GET /healthz (200 while any replica takes traffic, every
replica's snapshot in the body), /stats (router and per-replica
snapshots), /metrics (with the fleet SLO rollups refreshed) and
/trace?id= (a request's merged cross-replica chrome trace). When every
replica's queue is full, /generate answers 503 with a jittered
Retry-After.
"""
from __future__ import annotations

import base64
import binascii
import json
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from ..core.flags import define_flag, get_flag
from ..observability import memory as _memory
from ..observability import serve as _obs_serve
from ..ops import gpu as _gpu
from .engine import QueueFullError

define_flag("serving_port", 0,
            "Port of the serving HTTP front end (POST /generate); 0 binds "
            "an ephemeral port.")
define_flag("serving_request_timeout_s", 300.0,
            "Per-request wall-clock cap for POST /generate before the "
            "server answers 504 and cancels the request.")

# what a malformed request body raises while it is read and parsed
_BAD_REQUEST = (ValueError, TypeError, KeyError, binascii.Error)

# the kernels a serving engine launches (its graphs' replays included)
SERVING_KERNELS = ("rms_norm", "rope", "rope_packed", "paged_decode",
                   "paged_verify")


# -------------------------------------------- KV-block wire format
# One NDJSON line per block, chain order:
#   {"digest": hex, "prev": hex, "tokens": [int, ...],
#    "layers": [[k_b64, v_b64], ...]}
# engine.export_kv_blocks()'s records with the page bytes base64'd. The
# receiver re-derives every digest from (prev, tokens) before it admits
# anything.

def kv_wire_encode(records) -> bytes:
    lines = [json.dumps({
        "digest": r["digest"], "prev": r["prev"], "tokens": r["tokens"],
        "layers": [[base64.b64encode(k).decode("ascii"),
                    base64.b64encode(v).decode("ascii")]
                   for k, v in r["layers"]],
    }) for r in records]
    return ("\n".join(lines) + "\n").encode() if lines else b""


def kv_wire_decode(body: bytes):
    records = []
    for line in body.splitlines():
        if not line.strip():
            continue
        o = json.loads(line)
        o["layers"] = [(base64.b64decode(k), base64.b64decode(v))
                       for k, v in o["layers"]]
        records.append(o)
    return records


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch_serving/1.0"
    # chunked streaming needs HTTP/1.1; every other reply carries a
    # Content-Length, so keep-alive stays valid
    protocol_version = "HTTP/1.1"

    @property
    def _srv(self):
        return self.server._serving_server  # type: ignore[attr-defined]

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        if path in ("/kv/export", "/kv/ingest"):
            self._kv_transfer(path)
            return
        if path != "/generate":
            self._reply(404, {"error": "not found"})
            return
        try:
            body = json.loads(self._body() or b"{}")
            prompt = body.get("prompt")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                self._reply(400, {"error": "prompt must be a non-empty "
                                           "list of token ids"})
                return
            stream = bool(body.get("stream", False))
            req = self._srv.engine.submit(
                prompt,
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                eos_token_id=body.get("eos_token_id"),
                tier=str(body.get("tier", "default")),
                prefill_only=bool(body.get("prefill_only", False)))
        except QueueFullError as e:
            # tell the client when to come back instead of queueing
            # without bound
            self._reply(503, {"error": str(e), "queue_depth": e.depth,
                              "queue_limit": e.limit,
                              "retry_after_s": e.retry_after_s},
                        headers={"Retry-After":
                                 str(max(1, int(round(e.retry_after_s))))})
            return
        except _BAD_REQUEST as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        timeout = float(get_flag("serving_request_timeout_s"))
        if stream:
            self._stream(req, timeout)
            return
        if not req.wait(timeout):
            # evict the abandoned request: its slot and KV reservation go
            # back to the pool
            cancelled = self._srv.engine.cancel(req, reason="timeout")
            self._reply(504, {"error": "generation timed out",
                              "request_id": req.request_id,
                              "cancelled": cancelled})
            return
        tokens, _, reason = self._srv.engine.snapshot_output(req)
        self._reply(200, {"request_id": req.request_id,
                          "output_tokens": tokens, "finish_reason": reason,
                          "telemetry": req.telemetry()})

    def _kv_transfer(self, path: str) -> None:
        """POST /kv/export {"tokens": [...]} -> NDJSON records; POST
        /kv/ingest NDJSON -> the ingest counts."""
        try:
            raw = self._body()
            if path == "/kv/export":
                tokens = json.loads(raw or b"{}").get("tokens")
                if (not isinstance(tokens, list)
                        or not all(isinstance(t, int) for t in tokens)):
                    self._reply(400, {"error": "tokens must be a list of "
                                               "token ids"})
                    return
            else:
                records = kv_wire_decode(raw)
        except _BAD_REQUEST as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        if path == "/kv/export":
            self._reply_raw(200, kv_wire_encode(
                self._srv.engine.export_kv_blocks(tokens)),
                "application/x-ndjson")
        else:
            self._reply(200, self._srv.engine.ingest_kv_blocks(records))

    def _stream(self, req, timeout: float) -> None:
        """Chunked NDJSON: a line per engine flush with the newly fetched
        tokens, a last line with the finish reason and telemetry. Snapshots
        are taken under the engine lock, so a line never shows tokens past
        an eos cut. A client gone cancels the request: found at a write
        (a broken pipe), or while nothing is due to be written (the socket
        reads as closed), since a greedy request's tokens stay on the
        device until its budget ends and the stream is silent until
        then."""
        engine = self._srv.engine
        deadline = time.monotonic() + timeout
        sent = 0
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while True:
                req._progress.clear()
                toks, state, reason = engine.snapshot_output(req)
                if len(toks) > sent:
                    self._chunk({"request_id": req.request_id,
                                 "tokens": toks[sent:], "done": False})
                    sent = len(toks)
                if state == "finished":
                    self._chunk({"request_id": req.request_id,
                                 "done": True, "finish_reason": reason,
                                 "telemetry": req.telemetry()})
                    break
                if time.monotonic() > deadline:
                    engine.cancel(req, reason="timeout")
                    self._chunk({"request_id": req.request_id,
                                 "done": True, "finish_reason": "timeout"})
                    break
                if self._client_gone():
                    engine.cancel(req, reason="disconnect")
                    return
                req.wait_progress(timeout=0.1)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            engine.cancel(req, reason="disconnect")

    def _client_gone(self) -> bool:
        """Has the client closed its end? It sends nothing after the
        request's body, so a readable socket means an end of file or a
        reset."""
        try:
            ready, _, _ = select.select([self.connection], [], [], 0)
            return bool(ready) and not self.connection.recv(
                1, socket.MSG_PEEK)
        except OSError:
            return True

    def _chunk(self, obj) -> None:
        line = json.dumps(obj).encode() + b"\n"
        self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
        self.wfile.flush()

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path == "/stats":
            self._reply(200, self._srv.stats())
        elif path == "/metrics":
            self._reply_raw(200, _obs_serve.metrics_body(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/healthz", "/health"):
            snap = self._srv.engine.obs.health_snapshot(
                loop_alive=self._srv.loop_alive())
            self._reply(200 if snap["ok"] else 503, snap)
        else:
            self._reply(404, {"error": "not found"})

    def _reply(self, code: int, obj, headers=None) -> None:
        self._reply_raw(code, json.dumps(obj).encode(), "application/json",
                        headers=headers)

    def _reply_raw(self, code: int, body: bytes, ctype: str,
                   headers=None) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                    # the client left; nothing to answer

    def log_message(self, fmt, *args):  # requests must not spam stderr
        pass


class _FleetHandler(_Handler):
    """The fleet's front end: _Handler's wire protocol, with requests routed
    across replicas by a FleetRouter (a replica's death, hedges and drains
    show only in the reply's "fleet" block)."""

    @property
    def _router(self):
        return self._srv.router

    def do_POST(self):  # noqa: N802
        split = self.path.split("?", 1)
        path = split[0]
        if path in ("/drain", "/resume"):
            try:
                body = json.loads(self._body() or b"{}")
                rid = str(body.get("replica", ""))
                query = parse_qs(split[1]) if len(split) > 1 else {}
                migrate = (query.get("migrate") or [None])[0]
            except _BAD_REQUEST as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if rid not in self._router.replicas:
                self._reply(404, {"error": f"unknown replica {rid!r}"})
                return
            if path == "/drain":
                self._router.drain(rid, migrate=(
                    None if migrate is None
                    else migrate.lower() in ("1", "true", "on", "yes")))
                self._reply(200, {"replica": rid, "status": "draining",
                                  "drained": self._router.drained(rid)})
            else:
                self._router.resume(rid)
                self._reply(200, {"replica": rid, "status": "ok"})
            return
        if path != "/generate":
            self._reply(404, {"error": "not found"})
            return
        try:
            body = json.loads(self._body() or b"{}")
            prompt = body.get("prompt")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                self._reply(400, {"error": "prompt must be a non-empty "
                                           "list of token ids"})
                return
            freq = self._router.submit(
                prompt,
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                eos_token_id=body.get("eos_token_id"),
                tier=str(body.get("tier", "default")))
        except QueueFullError as e:
            self._reply(503, {"error": str(e), "queue_depth": e.depth,
                              "queue_limit": e.limit,
                              "retry_after_s": e.retry_after_s},
                        headers={"Retry-After":
                                 str(max(1, int(round(e.retry_after_s))))})
            return
        except _BAD_REQUEST as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        timeout = float(get_flag("serving_request_timeout_s"))
        if not freq.wait(timeout):
            self._reply(504, {"error": "generation timed out",
                              "request_id": freq.request_id})
            return
        self._reply(200, {
            "request_id": freq.request_id,
            "output_tokens": freq.output_tokens,
            "finish_reason": freq.finish_reason,
            "fleet": {"redispatches": freq.redispatches,
                      "hedged": freq.hedged},
        })

    def do_GET(self):  # noqa: N802
        split = self.path.split("?", 1)
        path = split[0]
        if path == "/stats":
            self._reply(200, self._router.stats())
        elif path == "/metrics":
            # the fleet_slo_seconds gauges roll the attempt histograms up:
            # recompute them for the scrape
            self._router.obs.publish_rollups()
            self._reply_raw(200, _obs_serve.metrics_body(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/healthz", "/health"):
            snap = self._router.health()
            self._reply(200 if snap["ok"] else 503, snap)
        elif path == "/trace":
            query = parse_qs(split[1]) if len(split) > 1 else {}
            rid = (query.get("id") or [None])[0]
            if not rid:
                self._reply(400, {"error": "usage: /trace?id=<request_id>"})
                return
            payload = self._router.obs.trace_payload(rid)
            if payload is None:
                self._reply(404, {
                    "error": f"no merged trace for request {rid!r} "
                             "(unknown id, evicted from the settled "
                             "ring, or FLAGS_metrics was off at submit)"})
                return
            self._reply(200, payload)
        else:
            self._reply(404, {"error": "not found"})


class FleetServer:
    """HTTP front end over a FleetRouter. The router owns the replica loops
    and the failure monitor; the server binds the socket and starts and
    stops the router with it."""

    def __init__(self, router, port: Optional[int] = None,
                 host: str = "127.0.0.1"):
        self.router = router
        if port is None:
            port = int(get_flag("serving_port"))
        self._httpd = ThreadingHTTPServer((host, int(port)), _FleetHandler)
        self._httpd.daemon_threads = True
        self._httpd._serving_server = self  # type: ignore[attr-defined]
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self.router.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="fleet-http", daemon=True)
        self._http_thread.start()

    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=5)
        self.router.stop()

    def __repr__(self):  # pragma: no cover
        return f"FleetServer(port={self.port})"


class ServingServer:
    """HTTP server plus the engine loop thread. The loop ticks the engine
    while there is work and sleeps `idle_sleep_s` otherwise; handler
    threads never touch the device. A tick that raises ends the loop
    (/healthz then answers 503 "dead"). `stop()` ends both threads."""

    def __init__(self, engine, port: Optional[int] = None,
                 host: str = "127.0.0.1", idle_sleep_s: float = 0.002):
        self.engine = engine
        if port is None:
            port = int(get_flag("serving_port"))
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._serving_server = self  # type: ignore[attr-defined]
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self._idle_sleep_s = float(idle_sleep_s)
        # FLAGS_serving_metrics_port (serving/observability.py): the
        # process-wide /metrics and /healthz on a port of their own
        self.metrics_server = None
        mp = int(get_flag("serving_metrics_port"))
        if mp > 0:
            self.metrics_server = _obs_serve.MetricsServer(mp, host=host)
        self._stop = threading.Event()
        self._loop = threading.Thread(target=self._run_loop,
                                      name="serving-engine", daemon=True)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="serving-http", daemon=True)
        self._loop.start()
        self._http_thread.start()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            if self.engine.sched.has_work():
                self.engine.step()
            else:
                time.sleep(self._idle_sleep_s)

    def loop_alive(self) -> bool:
        return self._loop.is_alive()

    def stats(self) -> dict:
        """The /stats body: the engine's stats(graphs=True), the serving
        kernels' launch counts and this process's memory."""
        out = self.engine.stats(graphs=True)
        out["launches"] = _gpu.launch_counts(SERVING_KERNELS)
        dev = self.engine.device
        card = None
        if dev.type == "cuda":
            import torch

            m = torch.cuda.memory_stats(dev)
            card = {"peak_bytes_in_use": int(m.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(m.get(
                        "reserved_bytes.all.current", 0)),
                    "peak_bytes_reserved": int(m.get(
                        "reserved_bytes.all.peak", 0))}
        out["memory"] = {"device": card,
                         "host": _memory.host_memory_bytes()}
        return out

    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._stop.set()
        self._loop.join(timeout=10)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=5)
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    def __repr__(self):  # pragma: no cover
        return f"ServingServer(port={self.port})"
