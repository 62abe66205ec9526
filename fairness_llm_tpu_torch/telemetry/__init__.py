"""Telemetry core of the port (counterpart of ``fairness_llm_tpu/telemetry/``,
its framework-free modules):

- ``registry``  — process-wide counters/gauges/log-bucket histograms,
  labeled by component (``engine``, ``serving``, ``paged_kv``);
  percentiles derive from bucket counts (no sample retention).
- ``tracing``   — per-request lifecycle spans in the serving scheduler
  (submitted -> admitted -> prefill_start -> first_token -> terminal),
  yielding queue-wait / TTFT / per-output-token / e2e histograms.
- ``export``    — JSONL event sink, snapshot dump (JSON + Prometheus text),
  schema validation and the terminal report.
- ``heartbeat`` — low-frequency liveness pulse, with missed-beat gap
  detection (``heartbeat_gap_s``).
- ``timeline``  — host-clock spans for every prefill batch and decode
  chunk, request lanes, Chrome-trace/Perfetto export and the
  ``step_gap_s`` host-sync histogram.
- ``slo``       — SLO targets and multi-window burn rates
  (``slo_burn_rate{slo,window}``) with alert events.
- ``flightrecorder`` — bounded rings of recent decode chunks, request
  edges, gauge transitions and the decision trail.
- ``incidents`` — the decision audit trail (``record_decision``), the
  trigger registry (``maybe_trigger``, armed by ``arm_incidents``, the
  CLI's ``--incidents``) and the postmortem bundles it dumps, with
  ``validate_incidents`` and ``render_incident_report``.
- ``fairness`` — the fairness monitor: streaming per-group DP/IF/exposure,
  the counterfactual pair watch and the serving-neutrality audit
  (``--fairness-obs``), ``render_fairness_report`` and the snapshot check
  ``check_fairness``.

The device-facing modules:

- ``compilestats`` — program-key lookups and first uses
  (``compiles_total``, ``compile_seconds``, the cache hit/miss counters).
- ``roofline`` — bytes a decode step streams, the bandwidth it reached and
  its fraction of the card's (``CARDS``, or ``--achievable-gbps``).
- ``memory`` — the device-memory ledger by pool, its reconciliation with
  the allocator (``measured`` on the card, ``indicative`` on the CPU), the
  per-program memory and the headroom signals; ``render_memory_report``
  (``memory-report``), ``check_memory``.
- ``costmodel`` — the aten-walked cost ledger per program (the hand-written
  kernels report their own counts) and the gap attribution;
  ``render_cost_report`` (``perf-report``), ``check_costmodel``.

Instrumentation is always on (host-side arithmetic; the cost walk runs
once per program key); the exporters are opt-in through ``configure`` (the
CLI's ``--telemetry-dir``), which also arms the per-program memory capture.
``SpeculationStats``/``ServingStats`` publish into the registry
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

from fairness_llm_tpu_torch.telemetry.compilestats import note_lookup, record_compile
from fairness_llm_tpu_torch.telemetry.costmodel import (
    COMPONENT_TITLES,
    COMPONENTS,
    ComponentCost,
    CostLedger,
    InstrumentedProgram,
    check_costmodel,
    classify,
    gap_decomposition,
    has_cost_data,
    note_invocation,
    publish_ledger,
    reference_achievable_gflops,
    reference_dispatch_s,
    render_cost_report,
    set_achievable_gflops,
    set_dispatch_s,
)
from fairness_llm_tpu_torch.telemetry.export import (
    EVENTS_FILENAME,
    EVENTS_MAX_BYTES,
    JsonlSink,
    load_snapshot,
    read_events,
    render_report,
    snapshot,
    to_prometheus,
    validate_snapshot,
    write_snapshot,
)
from fairness_llm_tpu_torch.telemetry.fairness import (
    FAIRNESS_TOLERANCE,
    FairnessMonitor,
    check_fairness,
    get_fairness_monitor,
    group_exposure,
    publish_offline_reference,
    render_fairness_report,
    set_fairness_monitor,
    use_fairness_monitor,
)
from fairness_llm_tpu_torch.telemetry.flightrecorder import (
    FlightRecorder,
    get_flight_recorder,
    recording_on,
    set_flight_recorder,
    set_recording,
    use_flight_recorder,
)
from fairness_llm_tpu_torch.telemetry.heartbeat import Heartbeat
from fairness_llm_tpu_torch.telemetry.incidents import (
    DecisionRecord,
    IncidentManager,
    arm_incidents,
    causal_chain,
    get_incident_manager,
    list_bundles,
    maybe_trigger,
    record_decision,
    render_incident_report,
    set_incident_manager,
    use_incident_manager,
    validate_incidents,
)
from fairness_llm_tpu_torch.telemetry.memory import (
    POOLS,
    RECONCILE_TOL_FRAC,
    MemoryLedger,
    check_memory,
    device_memory_stats,
    get_memory_ledger,
    has_memory_data,
    render_memory_report,
    set_memory_ledger,
    set_memory_obs,
    set_program_memory_capture,
    tree_device_bytes,
    use_memory_ledger,
)
from fairness_llm_tpu_torch.telemetry.registry import (
    DEFAULT_COUNT_BOUNDS,
    DEFAULT_LATENCY_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
    use_registry,
)
from fairness_llm_tpu_torch.telemetry.roofline import (
    CARDS,
    decode_step_bytes,
    observe_decode,
    reference_achievable_gbps,
    set_achievable_gbps,
)
from fairness_llm_tpu_torch.telemetry.slo import (
    SLOEvaluator,
    SLOTargets,
    get_slo_targets,
    render_slo_report,
    set_slo_targets,
)
from fairness_llm_tpu_torch.telemetry.timeline import (
    TRACE_FILENAME,
    Timeline,
    attribution_on,
    get_timeline,
    set_attribution,
    set_timeline,
    summarize_chrome_trace,
    use_timeline,
    validate_chrome_trace,
)
from fairness_llm_tpu_torch.telemetry.tracing import (
    RequestTracer,
    SpanEvent,
    TraceSummaryRow,
    assert_span_order,
)

# -- process-wide event sink --------------------------------------------------
# One sink per process, installed by ``configure`` (the CLI's
# --telemetry-dir) or by tests directly. emit_event is a no-op without one,
# so span recording costs nothing in runs that export nothing.

_event_sink: Optional[JsonlSink] = None


def install_event_sink(sink: Optional[JsonlSink]) -> Optional[JsonlSink]:
    """Install (or, with None, remove) the process event sink; returns the
    previous one so callers can restore it."""
    global _event_sink
    prev, _event_sink = _event_sink, sink
    return prev


def event_sink() -> Optional[JsonlSink]:
    return _event_sink


def emit_event(kind: str, **fields) -> None:
    if _event_sink is not None:
        _event_sink.emit(kind, **fields)


def configure(telemetry_dir: str, events_max_bytes: Optional[int] = None) -> JsonlSink:
    """Stand up the exporters for a run: make the telemetry dir, install
    the JSONL event sink there, size-rotated (``events.jsonl.1..N`` kept),
    and arm the per-program memory capture (``program_memory_bytes``).
    Snapshot writing stays explicit (``write_snapshot`` at the end of a
    run)."""
    import os

    os.makedirs(telemetry_dir, exist_ok=True)
    sink = JsonlSink(os.path.join(telemetry_dir, EVENTS_FILENAME),
                     max_bytes=(events_max_bytes if events_max_bytes is not None
                                else EVENTS_MAX_BYTES))
    install_event_sink(sink)
    set_program_memory_capture(True)
    return sink


__all__ = [
    "arm_incidents",
    "assert_span_order",
    "attribution_on",
    "CARDS",
    "causal_chain",
    "check_costmodel",
    "check_fairness",
    "check_memory",
    "classify",
    "COMPONENT_TITLES",
    "ComponentCost",
    "COMPONENTS",
    "configure",
    "CostLedger",
    "Counter",
    "DecisionRecord",
    "decode_step_bytes",
    "DEFAULT_COUNT_BOUNDS",
    "DEFAULT_LATENCY_BOUNDS",
    "device_memory_stats",
    "emit_event",
    "event_sink",
    "FAIRNESS_TOLERANCE",
    "FairnessMonitor",
    "FlightRecorder",
    "gap_decomposition",
    "Gauge",
    "get_fairness_monitor",
    "get_flight_recorder",
    "get_incident_manager",
    "get_memory_ledger",
    "get_registry",
    "get_slo_targets",
    "get_timeline",
    "group_exposure",
    "has_cost_data",
    "has_memory_data",
    "Heartbeat",
    "Histogram",
    "IncidentManager",
    "install_event_sink",
    "InstrumentedProgram",
    "JsonlSink",
    "list_bundles",
    "load_snapshot",
    "maybe_trigger",
    "MemoryLedger",
    "MetricsRegistry",
    "note_invocation",
    "note_lookup",
    "observe_decode",
    "POOLS",
    "publish_ledger",
    "publish_offline_reference",
    "read_events",
    "RECONCILE_TOL_FRAC",
    "record_compile",
    "record_decision",
    "recording_on",
    "reference_achievable_gbps",
    "reference_achievable_gflops",
    "reference_dispatch_s",
    "render_cost_report",
    "render_fairness_report",
    "render_incident_report",
    "render_memory_report",
    "render_report",
    "render_slo_report",
    "RequestTracer",
    "set_achievable_gbps",
    "set_achievable_gflops",
    "set_attribution",
    "set_dispatch_s",
    "set_fairness_monitor",
    "set_flight_recorder",
    "set_incident_manager",
    "set_memory_ledger",
    "set_memory_obs",
    "set_program_memory_capture",
    "set_recording",
    "set_registry",
    "set_slo_targets",
    "set_timeline",
    "SLOEvaluator",
    "SLOTargets",
    "snapshot",
    "SpanEvent",
    "summarize_chrome_trace",
    "Timeline",
    "to_prometheus",
    "TRACE_FILENAME",
    "TraceSummaryRow",
    "tree_device_bytes",
    "use_fairness_monitor",
    "use_flight_recorder",
    "use_incident_manager",
    "use_memory_ledger",
    "use_registry",
    "use_timeline",
    "validate_chrome_trace",
    "validate_incidents",
    "validate_snapshot",
    "write_snapshot",
]
