"""Observability (counterpart of paddle_tpu/observability): the metrics
registry, sinks, the span ring, the flight recorder (with its step ring,
training triggers, cluster view and membership trigger), per-step
training telemetry, cross-rank aggregation and straggler flags
(`cluster`), the anomaly engine, memory gauges and the /metrics +
/healthz endpoint. Importing it defines FLAGS_metrics, FLAGS_metrics_dir,
FLAGS_metrics_port, FLAGS_anomaly, FLAGS_flight_recorder_steps,
FLAGS_straggler_k and FLAGS_straggler_m."""
from . import (anomaly, cluster, flight_recorder, memory,  # noqa: F401
               registry, serve, sinks, spans, telemetry)
from .anomaly import AnomalyEngine  # noqa: F401
from .cluster import ClusterTelemetry  # noqa: F401
from .flight_recorder import FlightRecorder, get_flight_recorder  # noqa
from .registry import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, counter, default_registry, gauge,
                       histogram, metrics_enabled)
from .serve import MetricsServer  # noqa: F401
from .sinks import (JsonlEventLog, parse_prometheus_text,  # noqa: F401
                    prometheus_text, write_prometheus_textfile)
from .spans import record_span  # noqa: F401


def reset_all() -> None:
    """Zero metrics, clear spans, drop the telemetry and flight-recorder
    singletons and stop the process-wide metrics server (test
    isolation)."""
    registry.REGISTRY.reset()
    spans.clear()
    telemetry.reset()
    flight_recorder.reset()
    serve.reset()
