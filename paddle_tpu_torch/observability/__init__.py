"""Observability (counterpart of paddle_tpu/observability), cut to what
serving and single-card training use: the metrics registry, sinks, the
span ring, the flight recorder (with its step ring and training
triggers), per-step training telemetry, the anomaly engine, memory gauges
and the /metrics + /healthz endpoint. Importing it defines FLAGS_metrics,
FLAGS_metrics_dir, FLAGS_anomaly and FLAGS_flight_recorder_steps."""
from . import (anomaly, flight_recorder, memory, registry,  # noqa: F401
               serve, sinks, spans, telemetry)
from .anomaly import AnomalyEngine  # noqa: F401
from .flight_recorder import FlightRecorder, get_flight_recorder  # noqa
from .registry import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, counter, default_registry, gauge,
                       histogram, metrics_enabled)
from .serve import MetricsServer  # noqa: F401
from .sinks import (JsonlEventLog, parse_prometheus_text,  # noqa: F401
                    prometheus_text, write_prometheus_textfile)
from .spans import record_span  # noqa: F401


def reset_all() -> None:
    """Zero metrics, clear spans and drop the telemetry and flight-recorder
    singletons (test isolation)."""
    registry.REGISTRY.reset()
    spans.clear()
    telemetry.reset()
    flight_recorder.reset()
