"""The port's serving observability and HTTP front end on the CPU: mirrors
of the reference's tests/test_serving_observability.py and the HTTP cases
of tests/test_serving.py, over a tiny GPT (float32) whose seeded weights
both packages load; /generate is held against the JAX model's generate()
token for token.

Covered: the request lifecycle span set and its chrome-trace export, SLO
histograms against a hand-timed oracle, the tier label, the Prometheus
scrape parsed back, serving anomalies (a goodput collapse dumps the flight
arm with the offending trace, a KV conservation breach fires at once,
anomaly off is inert), the metrics-off no-op, POST /generate plain and
streamed (the stream's lines add up to the final answer; a disconnect
cancels), 503 with a Retry-After when the queue is full, /kv/export ->
/kv/ingest between two servers, /stats under concurrent streaming and
/healthz. Servers bind port 0.
"""
import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability import (flight_recorder, registry,
                                            reset_all, sinks, spans)
from paddle_tpu_torch.observability.anomaly import (
    CacheHitCollapse, GoodputCollapse, KVConservationBreach, TTFTRegression,
    serving_default_detectors)
from paddle_tpu_torch.serving import (Request, ServingEngine, ServingServer,
                                      export_request_trace, kv_wire_decode,
                                      kv_wire_encode)
from paddle_tpu_torch.serving.observability import (EngineStats,
                                                    chrome_trace_events,
                                                    new_engine_id)

R = registry.REGISTRY


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's) with the same seeded weights."""
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    rng = np.random.default_rng(3)
    state = {k: (np.zeros(v.shape, np.float32) if k.endswith(".bias")
                 else np.ones(v.shape, np.float32) if len(v.shape) == 1
                 else (rng.standard_normal(v.shape) * 0.05).astype(
                     np.float32))
             for k, v in jm.state_dict().items()}
    jm.set_state_dict(state)
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    flags.set_flags({"metrics": "off", "metrics_dir": "",
                     "serving_anomaly": "auto", "serving_max_queue": 0})
    reset_all()


@pytest.fixture
def metrics_on(tmp_path):
    d = str(tmp_path / "metrics")
    flags.set_flags({"metrics": "on", "metrics_dir": d})
    return d


def _engine(tm, **kw):
    kw = {"max_slots": 2, "block_size": 16, "prefill_chunk": 16, **kw}
    return ServingEngine(tm, device="cpu", **kw)


def _post(url, obj, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


@pytest.fixture
def server(models):
    """A ServingServer on port 0 over a fresh engine (fuse_steps=4)."""
    srv = ServingServer(_engine(models[1], fuse_steps=4), port=0)
    yield srv
    srv.stop()


# ------------------------------------------------------ lifecycle traces
def test_full_lifecycle_span_set(models, metrics_on, tmp_path):
    eng = _engine(models[1])
    req = eng.submit(list(range(1, 9)), max_new_tokens=4)
    eng.run_until_idle()
    names = req.trace.names()
    assert names[0] == "serving.queue" and names[-1] == "serving.finish"
    for n in ("serving.prefill_chunk", "serving.admit", "serving.decode"):
        assert n in names
    assert names.index("serving.admit") < names.index("serving.decode")
    finish = list(req.trace.spans)[-1]
    assert finish["args"] == dict(finish["args"], reason="length",
                                  request_id=req.request_id)
    ring = [s["name"] for s in spans.tail(500)]
    assert "serving.queue" in ring and "serving.tick" in ring
    p = str(tmp_path / "trace.json")
    export_request_trace(req, p)
    with open(p) as f:
        evs = json.load(f)["traceEvents"]
    assert len(evs) == len(names) and evs[0]["name"] == "serving.queue"
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    # export-time tags go on copies, never on the shared tick spans
    other = eng.submit(list(range(101, 109)), max_new_tokens=4)
    mine = eng.submit(list(range(201, 209)), max_new_tokens=4)
    eng.run_until_idle()
    ev = chrome_trace_events(list(mine.trace.spans), pid=7,
                             extra_args={"attempt": 0})
    assert {e["args"]["attempt"] for e in ev} == {0}
    assert all("attempt" not in (s.get("args") or {})
               for s in other.trace.spans)


@pytest.mark.parametrize("reason", ["cancelled", "timeout", "disconnect"])
def test_cancel_paths_close_the_trace(models, metrics_on, reason):
    eng = _engine(models[1])
    req = eng.submit(list(range(1, 9)), max_new_tokens=64)
    eng.step()
    assert eng.cancel(req, reason=reason)
    assert req.trace.names()[-1] == "serving.finish"
    assert R.get("serving_shed_requests_total").value(
        tier="default", reason=reason) == 1
    assert R.get("serving_goodput_tokens_total").value(tier="default") == 0


def test_cow_admission_and_spec_ticks_traced(models, metrics_on):
    eng = _engine(models[1])
    prompt = list(range(1, 33))
    eng.generate([prompt], max_new_tokens=2)
    req = eng.submit(prompt, max_new_tokens=2)
    eng.run_until_idle()
    assert "serving.prefill_chunk" not in req.trace.names()
    admit = [s for s in req.trace.spans if s["name"] == "serving.admit"]
    assert admit[0]["args"]["cached"] is True
    zero = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    with torch.no_grad():
        for p in zero.parameters():
            p.zero_()
    spec = ServingEngine(zero, device="cpu", max_slots=2, block_size=8,
                         prefill_chunk=8, spec_k=4)
    req = spec.submit([5, 0, 0, 0, 0], max_new_tokens=24)
    spec.run_until_idle()
    assert "serving.spec_verify" in req.trace.names()


def test_metrics_off_is_a_no_op(models):
    eng = _engine(models[1])
    req = eng.submit([1, 2, 3, 4], max_new_tokens=3)
    eng.run_until_idle()
    assert req.trace is None and list(eng.obs._ticks) == []
    assert eng.obs._anomaly is None and spans.tail(10) == []
    with pytest.raises(ValueError):
        export_request_trace(req, os.devnull)
    assert R.get("serving_slot_occupancy").value() == 0.0
    # the always-on SLO histograms still count
    assert R.get("serving_ttft_seconds").stats(tier="default")["count"] == 1
    assert eng.obs.health_snapshot()["ok"] is True
    t0 = eng.obs.tick_begin()
    assert t0 is None and eng.obs.now() is None


# ------------------------------------------------------ SLO metrics
def test_histograms_match_a_hand_timed_oracle(models, metrics_on):
    eng = _engine(models[1])
    req = Request([1, 2, 3], max_new_tokens=8, tier="gold")
    t0 = req.arrival_time
    req.prefill_start = t0 + 0.25
    req.first_token_time = t0 + 0.40
    eng.obs.on_first_token(req)
    req.output_tokens = list(range(5))
    req.finish_time = t0 + 1.40
    req.state, req.finish_reason = "finished", "stop"
    eng.obs.on_finish(req, "stop")

    def stat(name):
        return R.get(name).stats(tier="gold")

    assert stat("serving_queue_seconds")["sum"] == pytest.approx(0.25)
    assert stat("serving_ttft_seconds")["sum"] == pytest.approx(0.40)
    assert stat("serving_e2e_seconds")["sum"] == pytest.approx(1.40)
    assert stat("serving_tpot_seconds")["sum"] == pytest.approx(0.25)
    assert stat("serving_decode_tokens_per_s")["sum"] == pytest.approx(4.0)
    assert R.get("serving_goodput_tokens_total").value(tier="gold") == 5
    h = registry.histogram("t_quantile_seconds", buckets=(1.0, 2.0, 4.0),
                           always=True)
    assert np.isnan(h.quantile(0.5))
    h.observe(1.7)
    assert h.quantile(0.9) == pytest.approx(1.7)
    for v in (0.5, 1.5, 3.0):
        h.observe(v)
    assert h.quantile(0.5) == pytest.approx(1.5)
    assert h.quantile(1.0) == pytest.approx(4.0)


def test_tier_label_and_engine_counter_views(models, metrics_on):
    eng = _engine(models[1])
    eng.submit([1, 2, 3, 4], max_new_tokens=2, tier="bulk")
    eng.run_until_idle()
    h = R.get("serving_ttft_seconds")
    assert h.stats(tier="bulk")["count"] == 1
    assert h.stats(tier="default")["count"] == 0
    assert R.get("serving_engine_events_total").value(
        engine=eng._stats._eid, event="prefill_tokens") == 4
    a, b = EngineStats(new_engine_id()), EngineStats(new_engine_id())
    a.inc("prefill_tokens", 7)
    assert a["prefill_tokens"] == 7 and b["prefill_tokens"] == 0
    with pytest.raises(KeyError):
        a.inc("nonsense")


def test_scrape_parses_back(models, metrics_on):
    eng = _engine(models[1])
    eng.generate([[1, 2, 3, 4, 5, 6]], max_new_tokens=3)
    parsed = sinks.parse_prometheus_text(sinks.prometheus_text())
    assert parsed[("serving_ttft_seconds_count", (("tier", "default"),))] \
        == 1.0
    assert ("serving_e2e_seconds_sum", (("tier", "default"),)) in parsed
    assert ("serving_kv_blocks_used", ()) in parsed
    assert any(k[0] == "serving_slot_occupancy" for k in parsed)
    assert any(k[0] == "device_memory_bytes" or k[0] == "host_memory_bytes"
               for k in parsed)
    events = [dict(lbls).get("event") for name, lbls in parsed
              if name == "serving_engine_events_total"]
    assert "prefill_tokens" in events
    path = sinks.write_prometheus_textfile(os.path.join(metrics_on, "x.prom"))
    with open(path) as f:
        assert sinks.parse_prometheus_text(f.read()) == parsed


# --------------------------------------------------- serving anomalies
def _tick(step, **kw):
    return {"kind": "serving_tick", "step": step, "ts": 0.0, "running": 1,
            "waiting": 0, "kv_conservation_breach": 0.0, **kw}


def test_goodput_collapse_dumps_the_flight_arm(models, metrics_on):
    flags.set_flags({"serving_anomaly": "on"})
    eng = _engine(models[1])
    req = eng.submit([1, 2, 3, 4], max_new_tokens=3)
    eng.run_until_idle()
    for i in range(12):
        eng.obs.observe_record(_tick(i, goodput_tokens_per_s=100.0))
    for i in range(12, 18):
        eng.obs.observe_record(_tick(i, goodput_tokens_per_s=4.0))
    assert eng.obs.dumps and not eng.obs.dump_errors
    with open(eng.obs.dumps[0]) as f:
        payload = json.load(f)
    assert payload["anomaly"]["kind"] == "goodput_collapse"
    mine = [r for r in payload["serving_requests"]
            if r["request_id"] == req.request_id]
    assert mine[0]["trace"][-1]["name"] == "serving.finish"
    assert payload["serving_ticks"]
    base = os.path.basename(eng.obs.dumps[0])
    assert base.startswith("flight_")
    assert base.endswith("_serving_goodput_collapse.json")
    assert os.sep + "flight" + os.sep in eng.obs.dumps[0]
    snap = eng.obs.health_snapshot()
    assert snap["status"] == "anomalous" and snap["ok"] is False
    assert flight_recorder.get_flight_recorder().anomalies()


def test_conservation_breach_fires_and_off_is_inert(models, metrics_on):
    flags.set_flags({"serving_anomaly": "on"})
    eng = _engine(models[1])
    evs = eng.obs.observe_record(_tick(0, kv_conservation_breach=1.0))
    assert [e["kind"] for e in evs] == ["kv_conservation_breach"]
    flags.set_flags({"serving_anomaly": "off"})
    off = _engine(models[1])
    for i in range(20):
        assert off.obs.observe_record(
            _tick(i, kv_conservation_breach=1.0)) == []
    assert off.obs.dumps == []


def test_detector_semantics():
    d = TTFTRegression()
    assert not any(d.observe({"step": i, "ttft_s": 0.01}) for i in range(10))
    assert any(d.observe({"step": 10 + i, "ttft_s": 0.2}) for i in range(4))
    g = GoodputCollapse()
    for i in range(10):
        g.observe({"step": i, "goodput_tokens_per_s": 50.0, "running": 1})
    assert all(g.observe({"step": i, "goodput_tokens_per_s": 1.0,
                          "running": 0, "waiting": 0}) is None
               for i in range(10, 20))
    c = CacheHitCollapse()
    for i in range(10):
        c.observe({"step": i, "prefix_hit_rate": 0.8})
    assert any(c.observe({"step": 10 + i, "prefix_hit_rate": 0.1})
               for i in range(4))
    assert KVConservationBreach().observe(
        {"step": 0, "kv_conservation_breach": 1.0})
    assert {d.kind for d in serving_default_detectors()} == {
        "ttft_regression", "goodput_collapse", "cache_hit_collapse",
        "kv_conservation_breach"}


# --------------------------------------------------------- HTTP surface
def test_generate_matches_jax_and_stream_adds_up(models, server):
    jm, tm = models
    prompt = [int(t) for t in np.random.default_rng(3).integers(
        0, tm.config.vocab_size, 5)]
    code, body = _post(server.url() + "/generate",
                       {"prompt": prompt, "max_new_tokens": 6,
                        "tier": "gold"})
    out = json.loads(body)
    want = jm.generate(paddle.to_tensor(np.asarray([prompt], np.int32)),
                       max_new_tokens=6).numpy()[0, -6:]
    assert code == 200 and out["finish_reason"] == "length"
    assert out["output_tokens"] == [int(t) for t in want]
    assert out["telemetry"]["tier"] == "gold"
    assert out["telemetry"]["ttft_s"] is not None
    # streamed: the lines' tokens add up to the plain answer
    code, body = _post(server.url() + "/generate",
                       {"prompt": prompt, "max_new_tokens": 6,
                        "stream": True})
    lines = [json.loads(x) for x in body.decode().splitlines() if x]
    assert code == 200 and lines[-1]["done"] is True
    assert lines[-1]["finish_reason"] == "length"
    assert [t for x in lines[:-1] for t in x["tokens"]] == \
        out["output_tokens"]
    for bad in ({"prompt": "not-a-list"}, {"prompt": [1], "max_new_tokens":
                                           "x"}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.url() + "/generate", bad)
        assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server.url() + "/nowhere")
    assert ei.value.code == 404


def test_stream_disconnect_cancels(server):
    """A client that drops its stream cancels the request: an eos id that
    never comes makes the engine flush, and the handler write, every
    tick, so the reset connection shows at the next line."""
    eng = server.engine
    body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 200,
                       "eos_token_id": -1, "stream": True}).encode()
    s = socket.create_connection((server.host, server.port))
    try:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  b"application/json\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while b'"done": false' not in got:
            got += s.recv(4096)
    finally:
        # close with a reset, as a client that goes away does
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["running"] == st["waiting"] == st["prefilling"] == 0:
            break
        time.sleep(0.01)
    assert st["kv"]["used_blocks"] == 0
    assert R.get("serving_shed_requests_total").value(
        tier="default", reason="disconnect") == 1


def test_queue_full_answers_503_with_retry_after(models):
    eng = _engine(models[1], max_slots=1)
    srv = ServingServer(eng, port=0)
    try:
        flags.set_flags({"serving_max_queue": 1})
        hog = eng.submit([1, 2, 3], max_new_tokens=5000)
        deadline = time.monotonic() + 30
        while eng.stats()["waiting"] and time.monotonic() < deadline:
            time.sleep(0.01)
        filler = eng.submit([4, 5, 6], max_new_tokens=8)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url() + "/generate", {"prompt": [7, 8, 9]})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        payload = json.loads(ei.value.read())
        assert (payload["queue_depth"], payload["queue_limit"]) == (1, 1)
        # forward-only jitter around the base hint
        base = flags.get_flag("serving_retry_after_s")
        jitter = flags.get_flag("serving_retry_after_jitter")
        assert base <= payload["retry_after_s"] <= base * (1 + jitter)
        assert R.get("serving_shed_requests_total").value(
            tier="default", reason="queue_full") == 1
        eng.cancel(hog)
        eng.cancel(filler)
    finally:
        srv.stop()


def test_kv_round_trip_between_two_servers(models, server):
    tm = models[1]
    prompt = [int(t) for t in np.random.default_rng(9).integers(
        0, tm.config.vocab_size, 32)]          # two whole blocks
    code, body = _post(server.url() + "/generate",
                       {"prompt": prompt, "prefill_only": True})
    assert json.loads(body)["finish_reason"] == "prefill_complete"
    code, wire = _post(server.url() + "/kv/export", {"tokens": prompt})
    recs = kv_wire_decode(wire)
    assert len(recs) == 2 and kv_wire_encode(recs) == wire
    other = ServingServer(_engine(tm, fuse_steps=4), port=0)
    try:
        req = urllib.request.Request(other.url() + "/kv/ingest", data=wire)
        with urllib.request.urlopen(req, timeout=30) as r:
            st = json.loads(r.read())
        layers = tm.config.num_layers
        page = other.engine.pool.layers[0][0][0]
        assert st["imported"] == 2 and st["rejected"] == 0
        assert st["bytes"] == 2 * 2 * layers * page.numel() * 4
        code, again = _post(other.url() + "/kv/export", {"tokens": prompt})
        assert again == wire                       # bitwise the same pages
        code, body = _post(other.url() + "/generate",
                           {"prompt": prompt, "max_new_tokens": 5})
        out = json.loads(body)["output_tokens"]
        assert other.engine.prefill_tokens == 0       # a full prefix hit
        assert other.engine.cow_admissions == 1
        assert out == tm.generate(torch.tensor([prompt]), max_new_tokens=5)[
            0, -5:].tolist()
        for bad in (b"not json\n", b'{"digest": "zz", "prev": ""}\n'):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    other.url() + "/kv/ingest", data=bad), timeout=30)
            assert ei.value.code == 400
    finally:
        other.stop()


def test_stats_metrics_healthz_under_concurrent_streaming(models, server,
                                                          metrics_on):
    eng = server.engine
    bad, done = [], threading.Event()

    def scrape():
        while not done.is_set():
            s = json.loads(_get(server.url() + "/stats")[1])
            if not s["kv"]["conservation_ok"] or \
                    s["running"] + s["prefilling"] + s["free_slots"] \
                    != eng.max_slots:
                bad.append(s)

    t = threading.Thread(target=scrape)
    t.start()
    try:
        streams = []

        def stream(p):
            streams.append(_post(server.url() + "/generate",
                                 {"prompt": p, "max_new_tokens": 7,
                                  "stream": True})[1])

        clients = [threading.Thread(target=stream, args=([i + 1] * 5,))
                   for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(60)
    finally:
        done.set()
        t.join(30)
    assert not bad and len(streams) == 4
    for body in streams:
        lines = [json.loads(x) for x in body.decode().splitlines() if x]
        assert sum(len(x.get("tokens", ())) for x in lines) == 7
    code, text = _get(server.url() + "/metrics")
    parsed = sinks.parse_prometheus_text(text.decode())
    assert parsed[("serving_ttft_seconds_count", (("tier", "default"),))] \
        == 4.0
    code, body = _get(server.url() + "/healthz")
    snap = json.loads(body)
    assert code == 200 and snap["ok"] is True and snap["status"] == "ok"
    assert snap["steps"] >= 1 and snap["last_tick_age_s"] is not None
