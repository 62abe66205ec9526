"""Device traces, decode and serving counters and the phase timer
(counterpart of ``fairness_llm_tpu/utils/profiling.py``).

``maybe_trace(trace_dir, label)`` always records the region as a
``cat="phase"`` span on the host track of the timeline
(``telemetry/timeline.py``), so ``--telemetry-dir``'s ``trace.json`` shows
the phases; with a directory it also captures the region with
``torch.profiler`` (host ops, and the device's kernels where a card is
present) under ``record_function(label)`` and writes one Chrome-trace JSON
per region and rank: ``<trace_dir>/<label>-<time>/<host>.rank<r>.pt.trace.json``.
The reference captures with ``jax.profiler`` into XProf files.

``summarize_trace`` reads those captures back without a viewer: per
capture, the device's kernels (and copies and sets) grouped by name with
their total ms and count, the device total being the union of their
intervals, and the host's ops beside them (on the CPU the host ops are all
there is, as the reference falls back to its host planes).
``device_busy_share`` is the share of a named span's wall in which the
device ran a kernel.

Each stats object ``publish``es its counters into the telemetry registry
(``telemetry/registry.py``), so the registry's totals equal the merged
records."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import logging
import os
import socket
import time
from typing import Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

CAPTURE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of the device's own work, and of the host's ops.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], label: str = "region") -> Iterator[None]:
    """Record ``label`` as a phase span on the timeline; with ``trace_dir``,
    capture the region with ``torch.profiler`` and write it there. A failed
    region writes no capture."""
    from fairness_llm_tpu_torch.telemetry.timeline import get_timeline

    t0 = time.monotonic()
    try:
        if not trace_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from fairness_llm_tpu_torch.parallel.multihost import process_index

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{time.time_ns() % 10**9:09d}"
        out = os.path.join(trace_dir, f"{label}-{stamp}")
        logger.info("profiling %s -> %s", label, out)
        with profile(activities=activities) as prof:
            with record_function(label):
                yield
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{socket.gethostname()}.rank{process_index()}"
                                 f"{CAPTURE_SUFFIX}")
        prof.export_chrome_trace(path)
        logger.info("%s capture: %s (%d bytes)", label, path, os.path.getsize(path))
    finally:
        get_timeline().record_span(label, "phase", "host", t0, time.monotonic() - t0,
                                   profiler=bool(trace_dir))


@dataclasses.dataclass
class TraceSummary:
    """One capture's events on one side (``cuda`` or ``host``)."""

    device: str
    total_ms: float
    num_events: int
    top_ops: List[Tuple[str, float, int]]  # (op name, total ms, count)

    def format(self, width: int = 80) -> str:
        lines = [f"{self.device}: {self.total_ms:.1f} ms device time, "
                 f"{self.num_events} events"]
        for name, ms, cnt in self.top_ops:
            lines.append(f"  {ms:9.2f} ms  x{cnt:6d}  {name[:width]}")
        return "\n".join(lines)


def _captures(trace_dir: str, latest_only: bool) -> List[str]:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*" + CAPTURE_SUFFIX),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *{CAPTURE_SUFFIX} under {trace_dir}")
    if latest_only:
        # the newest capture directory, every rank's file in it
        newest = max({os.path.dirname(p) for p in paths}, key=os.path.getmtime)
        paths = [p for p in paths if os.path.dirname(p) == newest]
    return paths


def _events(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize_trace(trace_dir: str, top_k: int = 15, device_filter: str = "cuda",
                    latest_only: bool = False) -> List[TraceSummary]:
    """Every capture under ``trace_dir``, one ``TraceSummary`` per side:
    ``<capture>/<file>: cuda`` (kernels, copies and sets by name; the total
    is the union of their intervals, the device's busy time) and
    ``<capture>/<file>: host`` (host ops by name; the total is the sum of
    their durations, nested ops counted in each). ``device_filter`` is a
    substring of the side's label ("" for both); ``latest_only`` keeps the
    newest capture. A side with no events is left out."""
    out: List[TraceSummary] = []
    for path in _captures(trace_dir, latest_only):
        label = os.path.join(os.path.basename(os.path.dirname(path)),
                             os.path.basename(path)[:-len(CAPTURE_SUFFIX)])
        events = _events(path)
        for side, cats in (("cuda", DEVICE_CATS), ("host", HOST_CATS)):
            name = f"{label}: {side}"
            if device_filter and device_filter not in name:
                continue
            mine = [e for e in events if e.get("cat") in cats]
            if not mine:
                continue
            totals: collections.Counter = collections.Counter()
            counts: collections.Counter = collections.Counter()
            for e in mine:
                totals[e["name"]] += e["dur"] / 1e3  # us -> ms
                counts[e["name"]] += 1
            if side == "cuda":
                total_ms = _union_us((e["ts"], e["ts"] + e["dur"]) for e in mine) / 1e3
            else:
                total_ms = sum(totals.values())
            out.append(TraceSummary(
                device=name, total_ms=round(total_ms, 3), num_events=len(mine),
                top_ops=[(n, round(ms, 3), counts[n]) for n, ms in totals.most_common(top_k)]))
    return out


def device_busy_share(path: str, span: str) -> dict:
    """Over every host span named ``span`` (a ``record_function`` region)
    in the capture at ``path``: the spans' count and wall, the union of
    the device's kernel intervals inside them, and the busy share (their
    ratio; None with no span)."""
    events = _events(path)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span]
    work = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    busy = _union_us((max(a, lo), min(b, hi)) for lo, hi in spans for a, b in work
                     if a < hi and b > lo)
    wall = sum(hi - lo for lo, hi in spans)
    return {"spans": len(spans), "wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall if wall > 0 else None}


@dataclasses.dataclass
class SpeculationStats:
    """Prompt-lookup speculation counters for one decode call, or a sweep
    (``merge``). ``GenerateOutput.stats["speculation"]`` holds ``as_dict()``;
    ``EngineBackend.spec_totals`` merges them over a sweep.

    - ``drafted``: draft tokens proposed, over verify steps x live rows;
    - ``accepted``: drafted tokens emitted (each saves one decode step);
    - ``verify_steps``: verify forwards run; the batch moves in lockstep,
      so this replaces plain decode's step count (the most tokens of a row);
    - ``emitted``: real tokens produced over all rows, each step's greedy
      token included; ``tokens_per_step`` = emitted / verify_steps is
      summed over the batch.
    """

    drafted: int = 0
    accepted: int = 0
    verify_steps: int = 0
    emitted: int = 0
    draft_len: int = 0
    ngram_max: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / self.verify_steps if self.verify_steps else 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "SpeculationStats":
        """Inverse of ``as_dict``; the derived keys are dropped."""
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def merge(self, other: "SpeculationStats") -> "SpeculationStats":
        return SpeculationStats(
            drafted=self.drafted + other.drafted,
            accepted=self.accepted + other.accepted,
            verify_steps=self.verify_steps + other.verify_steps,
            emitted=self.emitted + other.emitted,
            draft_len=other.draft_len or self.draft_len,
            ngram_max=other.ngram_max or self.ngram_max,
        )

    def as_dict(self) -> dict:
        return {
            "drafted": self.drafted,
            "accepted": self.accepted,
            "verify_steps": self.verify_steps,
            "emitted": self.emitted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "tokens_per_step": round(self.tokens_per_step, 3),
            "draft_len": self.draft_len,
            "ngram_max": self.ngram_max,
        }

    def publish(self, registry=None, component: str = "engine") -> None:
        """Mirror this object's counters into the telemetry registry; the
        engine publishes each call's stats once, so the registry's totals
        equal the merged sweep totals."""
        from fairness_llm_tpu_torch.telemetry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter("spec_drafted_total", component=component).inc(self.drafted)
        reg.counter("spec_accepted_total", component=component).inc(self.accepted)
        reg.counter("spec_verify_steps_total", component=component).inc(self.verify_steps)
        reg.counter("spec_emitted_total", component=component).inc(self.emitted)


@dataclasses.dataclass
class ServingStats:
    """Continuous-batching counters for one ``ContinuousScheduler`` drain,
    or a sweep (``merge``). ``ServingBackend.serve_totals`` merges them; the
    phase records hold ``as_dict()`` under ``serving``.

    - ``admitted``: requests admitted into KV slots;
    - ``completed`` / ``failed`` / ``expired``: terminal outcomes
      (``expired``: the deadline passed first);
    - ``preempted`` (a drain), ``shed`` (overload control refused it) and
      ``requeued`` (a contained fault, retried once);
    - ``rejected``: submissions refused at the queue (capacity or rate);
    - ``prefill_batches`` / ``prefill_tokens``: prefill forwards and the
      real prompt tokens they processed;
    - ``decode_steps`` / ``decoded_tokens``: decode-step forwards and the
      real tokens emitted (tokens per step at most ``num_slots``);
    - ``occupancy_sum``: live rows summed over decode steps (mean occupancy
      = occupancy_sum / decode_steps);
    - ``queue_depth_sum`` / ``queue_depth_max`` / ``loop_iterations``: the
      admission queue's depth over the scheduler loop.
    """

    num_slots: int = 0
    admitted: int = 0
    completed: int = 0
    failed: int = 0
    expired: int = 0
    preempted: int = 0
    shed: int = 0
    rejected: int = 0
    requeued: int = 0
    prefill_batches: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decoded_tokens: int = 0
    occupancy_sum: int = 0
    queue_depth_sum: int = 0
    queue_depth_max: int = 0
    loop_iterations: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.decoded_tokens / self.decode_steps if self.decode_steps else 0.0

    @property
    def avg_occupancy(self) -> float:
        return self.occupancy_sum / self.decode_steps if self.decode_steps else 0.0

    @property
    def avg_queue_depth(self) -> float:
        return self.queue_depth_sum / self.loop_iterations if self.loop_iterations else 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "ServingStats":
        """Inverse of ``as_dict``; the derived keys are dropped."""
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def merge(self, other: "ServingStats") -> "ServingStats":
        summed = {f.name: getattr(self, f.name) + getattr(other, f.name)
                  for f in dataclasses.fields(self)}
        summed["num_slots"] = other.num_slots or self.num_slots
        summed["queue_depth_max"] = max(self.queue_depth_max, other.queue_depth_max)
        return ServingStats(**summed)

    def as_dict(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        out["tokens_per_step"] = round(self.tokens_per_step, 3)
        out["avg_occupancy"] = round(self.avg_occupancy, 3)
        out["avg_queue_depth"] = round(self.avg_queue_depth, 3)
        return out

    def publish(self, registry=None, component: str = "serving", labels=None) -> None:
        """Mirror one drain's counters into the telemetry registry (call once
        per drain, so the registry carries process totals). ``num_slots``
        and ``queue_depth_max`` are levels, not event counts, so they
        publish as gauges; ``labels`` adds instrument labels."""
        from fairness_llm_tpu_torch.telemetry import get_registry

        reg = registry if registry is not None else get_registry()
        lbl = dict(labels or {})
        for name in ("admitted", "completed", "failed", "expired", "preempted", "shed",
                     "rejected", "requeued", "prefill_batches", "prefill_tokens",
                     "decode_steps", "decoded_tokens", "loop_iterations"):
            reg.counter(f"serving_{name}_total", component=component,
                        **lbl).inc(getattr(self, name))
        reg.gauge("serving_num_slots", component=component, **lbl).set(self.num_slots)
        reg.gauge("serving_queue_depth_max", component=component,
                  **lbl).set_max(self.queue_depth_max)


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock phase timing, logged, with an optional dict sink for
    machine-readable timings."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.info("%s took %.2fs", name, dt)
        if sink is not None:
            sink[name] = dt
