"""Trace-driven load replay against the fleet (counterpart of
``fairness_llm_tpu/serving/replay.py``; framework-free, copied as it is).

**Trace generation** (``TraceConfig``, ``generate_trace``): a seeded
non-homogeneous Poisson process of sessions over a million-user id space: a
diurnal rate curve, a burst overlay of (start, duration, multiplier)
windows, Pareto-distributed session lengths with exponential think time,
and an interactive/batch QoS mix. Arrivals are thinned from the peak rate
(Lewis-Shedler), so a seed gives the same arrivals under any curve. The
generator draws from numpy's ``default_rng``, so the same seed gives the
reference's events byte for byte; ``write_trace`` writes sorted-key JSONL
with rounded stamps.

**Replay** (``ReplayDriver``): events are submitted through a
``ReplicaSet``'s ``submit``/``tick``/``take_result`` when their arrival
time comes due on a ``ReplayClock`` (``(clock() - t0) * compression`` in
trace seconds, injectable). Deadlines are divided by the compression;
a ``ScriptedFaultInjector`` is armed with the trace clock, so that its
``at_seconds`` schedules fire at trace-time positions.

Every event ends ``accepted`` (it must reach a terminal Result), ``shed``
(a refusal Result with a retry-after, honoured once) or ``backpressured``
(re-offered while it stays due); ``replay_accepted_total`` against
``replay_terminal_total`` makes "zero accepted-then-lost" checkable
(``serving/autoscaler.check_autoscale``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fairness_llm_tpu_torch.serving.request import Request, Result
from fairness_llm_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)

TRACE_VERSION = 1

# A tiny built-in prompt catalog so traces can generate without a study
# corpus; real drills pass the sweep's own prompts for realistic shapes.
DEFAULT_PROMPTS = (
    "recommend five movies for a quiet evening",
    "recommend five upbeat movies for a road trip",
    "recommend five classic films for a family night",
    "recommend five documentaries about nature",
    "recommend five comedies from the nineties",
    "recommend five thrillers with a twist ending",
    "recommend five animated films for all ages",
    "recommend five dramas with strong ensembles",
)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for one synthetic trace. Everything is TRACE time (seconds
    from trace start); the replay's compression factor maps it to wall
    time later. Frozen/hashable like every other config object."""

    seed: int = 0
    duration_s: float = 86400.0  # trace span (default: one day)
    users: int = 1_000_000  # user-id space sessions draw from
    # Session arrivals per second at the diurnal MIDLINE. The mean request
    # rate is roughly base_sessions_per_s x mean session turns.
    base_sessions_per_s: float = 0.5
    # Diurnal curve: rate x (1 + amplitude * sin(2pi (t+phase)/period)),
    # clamped at 0. amplitude 0 = flat.
    diurnal_amplitude: float = 0.6
    diurnal_period_s: float = 86400.0
    diurnal_phase_s: float = 0.0
    # Burst overlay: (start_s, duration_s, multiplier) windows that
    # multiply the instantaneous rate — flash crowds on the diurnal base.
    bursts: Tuple[Tuple[float, float, float], ...] = ()
    # Heavy-tailed session length: turns = 1 + floor(Pareto(alpha)),
    # capped. alpha 1.3 gives mean ~4 with a long tail.
    session_tail_alpha: float = 1.3
    session_max_turns: int = 32
    think_time_s: float = 120.0  # mean exponential gap between turns
    interactive_frac: float = 0.85  # sessions that are interactive QoS
    # Per-class deadlines in TRACE seconds (None = no deadline). The
    # replay driver scales them by 1/compression at submission.
    interactive_deadline_s: Optional[float] = None
    batch_deadline_s: Optional[float] = None
    max_tokens_choices: Tuple[int, ...] = (8, 12, 16, 24)
    max_events: Optional[int] = None  # hard cap (None = the curve decides)


@dataclasses.dataclass
class TraceEvent:
    """One request arrival in trace time."""

    t: float  # trace seconds from start
    id: str
    user: int
    session: int
    turn: int
    prompt: str
    qos: str
    max_tokens: int
    row_seed: int
    deadline_s: Optional[float] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["deadline_s"] is None:
            del d["deadline_s"]
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "TraceEvent":
        return cls(**json.loads(line))


def _rate(cfg: TraceConfig, t: float) -> float:
    lam = cfg.base_sessions_per_s * max(
        0.0,
        1.0 + cfg.diurnal_amplitude
        * math.sin(2.0 * math.pi * (t + cfg.diurnal_phase_s)
                   / cfg.diurnal_period_s),
    )
    for start, dur, mult in cfg.bursts:
        if start <= t < start + dur:
            lam *= mult
    return lam


def _peak_burst_mult(bursts: Tuple[Tuple[float, float, float], ...]) -> float:
    """Max PRODUCT of simultaneously-active burst multipliers. Overlapping
    windows multiply in ``_rate``, so the thinning majorant must bound the
    product, not the largest single multiplier — otherwise rate(t)/peak
    silently clamps past 1 in the overlap and the trace under-generates.
    The product is piecewise-constant between window boundaries; every
    maximal interval starts at t=0, a window start, or a window end."""
    best = 1.0
    points = {0.0}
    for start, dur, _ in bursts:
        points.add(start)
        points.add(start + dur)
    for t in points:
        prod = 1.0
        for start, dur, mult in bursts:
            if start <= t < start + dur:
                prod *= mult
        best = max(best, prod)
    return best


def _peak_rate(cfg: TraceConfig) -> float:
    peak = cfg.base_sessions_per_s * (1.0 + abs(cfg.diurnal_amplitude))
    return max(peak * _peak_burst_mult(cfg.bursts), 1e-9)


def generate_trace(cfg: TraceConfig,
                   prompts: Sequence[str] = DEFAULT_PROMPTS
                   ) -> List[TraceEvent]:
    """Deterministic synthetic trace: same (cfg, prompts) -> same events.
    Events come back sorted by (t, id) with stamps rounded to
    microseconds, so serialization is byte-stable."""
    if not prompts:
        raise ValueError("generate_trace needs a non-empty prompt catalog")
    rng = np.random.default_rng(cfg.seed)
    peak = _peak_rate(cfg)
    events: List[TraceEvent] = []
    t = 0.0
    session = 0
    while True:
        # Lewis–Shedler thinning: candidate arrivals at the PEAK rate,
        # kept with probability rate(t)/peak — one rng stream regardless
        # of curve parameters.
        t += float(rng.exponential(1.0 / peak))
        if t >= cfg.duration_s:
            break
        if float(rng.random()) > _rate(cfg, t) / peak:
            continue
        user = int(rng.integers(cfg.users))
        turns = 1 + int(rng.pareto(cfg.session_tail_alpha))
        turns = min(turns, cfg.session_max_turns)
        interactive = float(rng.random()) < cfg.interactive_frac
        qos = "interactive" if interactive else "batch"
        deadline = (cfg.interactive_deadline_s if interactive
                    else cfg.batch_deadline_s)
        tt = t
        for turn in range(turns):
            if turn:
                tt += float(rng.exponential(cfg.think_time_s))
            if tt >= cfg.duration_s:
                break
            prompt = prompts[int(rng.integers(len(prompts)))]
            max_tokens = int(
                cfg.max_tokens_choices[
                    int(rng.integers(len(cfg.max_tokens_choices)))
                ]
            )
            # Stable per-request identity: the row seed keys the sampling
            # stream, so a migrated/requeued/re-run request decodes the
            # same text (the engine's row_seeds contract).
            row_seed = (cfg.seed * 2_654_435_761
                        + user * 1_000_003 + session * 8191 + turn) \
                & 0xFFFFFFFF
            events.append(TraceEvent(
                t=round(tt, 6),
                id=f"u{user:07d}_s{session:06d}_t{turn:02d}",
                user=user, session=session, turn=turn,
                prompt=prompt, qos=qos, max_tokens=max_tokens,
                row_seed=row_seed, deadline_s=deadline,
            ))
        session += 1
        if cfg.max_events is not None and len(events) >= cfg.max_events:
            events = events[: cfg.max_events]
            break
    events.sort(key=lambda e: (e.t, e.id))
    return events


def write_trace(path: str, events: Sequence[TraceEvent],
                cfg: Optional[TraceConfig] = None) -> str:
    """Write one JSONL trace: a header record (version + the generating
    config, when given) then one event per line. Byte-deterministic for a
    given (cfg, events)."""
    with open(path, "w", encoding="utf-8") as f:
        header = {"trace_version": TRACE_VERSION}
        if cfg is not None:
            header["config"] = dataclasses.asdict(cfg)
        f.write(json.dumps(header, sort_keys=True,
                           separators=(",", ":")) + "\n")
        for ev in events:
            f.write(ev.to_json() + "\n")
    return path


def read_trace(path: str) -> List[TraceEvent]:
    events: List[TraceEvent] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            if i == 0 and "trace_version" in line:
                continue  # header record
            events.append(TraceEvent.from_json(line))
    return events


class ReplayClock:
    """Monotonic TRACE-time clock: ``now()`` is trace seconds elapsed,
    i.e. ``(clock() - t0) * compression``. Injectable base clock for
    deterministic tests (a fake clock stepping a fixed dt per read walks
    the replay through its schedule with no sleeping)."""

    def __init__(self, compression: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if compression <= 0:
            raise ValueError(f"compression must be > 0, got {compression}")
        self.compression = float(compression)
        self._clock = clock
        self._t0 = clock()

    def now(self) -> float:
        return (self._clock() - self._t0) * self.compression

    __call__ = now


@dataclasses.dataclass
class ReplayReport:
    """What one replay did — the drill's raw material."""

    events: int = 0
    accepted: int = 0
    gate_sheds: int = 0  # refused at the overload gate (terminal Results)
    backpressured: int = 0  # refusal INSTANCES (an event may retry many)
    dropped: int = 0  # events never accepted (still backpressured at end)
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)
    tokens: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # Full Result objects, populated only under ReplayDriver(
    # keep_results=True): at the advertised million-user scale, retaining
    # every Result would roughly double the driver's memory for data
    # ``tokens``/``outcomes``/``ttft_by_qos`` already carry.
    results: Dict[str, Result] = dataclasses.field(default_factory=dict)
    ttft_by_qos: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    wall_s: float = 0.0
    trace_span_s: float = 0.0
    compression: float = 1.0
    timed_out: bool = False

    @property
    def terminal(self) -> int:
        """Terminal Results observed, gate refusals included (``outcomes``
        counts both — an explicit shed is an answer, not a loss)."""
        return sum(self.outcomes.values())

    @property
    def lost(self) -> int:
        """Accepted-then-lost — the number the whole stack exists to keep
        at zero. Gate sheds were never accepted, so they subtract out."""
        return self.accepted - (self.terminal - self.gate_sheds)

    def shed_rate(self) -> float:
        """Explicit refusals (gate + post-admission sheds) over everything
        terminally answered."""
        return (self.outcomes.get("shed", 0) / self.terminal
                if self.terminal else 0.0)

    def slo_attainment(self, ttft_target_s: float,
                       qos: str = "interactive") -> Optional[float]:
        """Fraction of completed ``qos`` requests whose TTFT met the
        target (None when none completed with a TTFT)."""
        vals = self.ttft_by_qos.get(qos, [])
        if not vals:
            return None
        return sum(1 for v in vals if v <= ttft_target_s) / len(vals)

    def summary(self) -> Dict:
        out = {
            "events": self.events,
            "accepted": self.accepted,
            "terminal": self.terminal,
            "lost": self.lost,
            "gate_sheds": self.gate_sheds,
            "backpressured": self.backpressured,
            "dropped": self.dropped,
            "outcomes": dict(sorted(self.outcomes.items())),
            "shed_rate": round(self.shed_rate(), 4),
            "wall_s": round(self.wall_s, 3),
            "trace_span_s": round(self.trace_span_s, 3),
            "compression": self.compression,
            "timed_out": self.timed_out,
        }
        for qos, vals in sorted(self.ttft_by_qos.items()):
            if vals:
                v = sorted(vals)
                out[f"ttft_p50_{qos}_s"] = round(
                    v[len(v) // 2], 4)
                out[f"ttft_p95_{qos}_s"] = round(
                    v[min(len(v) - 1, int(0.95 * len(v)))], 4)
        return out


class ReplayDriver:
    """Replays one trace against a ``ReplicaSet`` (or anything exposing
    the same ``submit``/``tick``/``take_result``/``has_work``/``drain``
    streaming surface, e.g. a bare ``ContinuousScheduler`` via a thin
    adapter).

    ``settings`` is the fleet's compiled sampler settings; each event's
    ``max_tokens`` replaces the decode budget per request (sampler fields
    must match the fleet — one fleet, one compiled sampler). ``max_wall_s``
    is the CI hang-guard: a replay that exceeds it stops submitting,
    drains what it accepted, and reports ``timed_out`` instead of wedging
    the job."""

    def __init__(self, fleet, events: Sequence[TraceEvent],
                 compression: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 fault_injector=None,
                 scale_deadlines: bool = True,
                 max_wall_s: Optional[float] = None,
                 poll_s: float = 0.001,
                 tail_s: float = 0.0,
                 keep_results: bool = False):
        self.fleet = fleet
        self.events = sorted(events, key=lambda e: (e.t, e.id))
        self.compression = float(compression)
        self._base_clock = clock
        self.fault_injector = fault_injector
        self.scale_deadlines = scale_deadlines
        self.max_wall_s = max_wall_s
        self.poll_s = poll_s
        # Quiet-tail ticking, in TRACE seconds past the last event: the
        # replay keeps driving the fleet loop through the post-trace lull
        # so time-based controllers (autoscaler scale-DOWN hysteresis,
        # brownout de-escalation, SLO window decay) see the quiet period
        # instead of the run ending the instant the last Result lands.
        self.tail_s = float(tail_s)
        self.keep_results = keep_results

    def _request_for(self, ev: TraceEvent) -> Request:
        settings = dataclasses.replace(self.fleet.settings,
                                       max_tokens=ev.max_tokens)
        deadline = ev.deadline_s
        if deadline is not None and self.scale_deadlines:
            # Trace-time budgets hold under compression: a 2 s deadline in
            # a 60x-compressed day is ~33 ms of wall time — the workload's
            # urgency scales with its arrival cadence.
            deadline = deadline / self.compression
        return Request(
            prompt=ev.prompt, id=ev.id, settings=settings,
            row_seed=ev.row_seed, deadline_s=deadline, qos=ev.qos,
        )

    def run(self) -> ReplayReport:
        reg = get_registry()
        trace_clock = ReplayClock(self.compression, self._base_clock)
        if self.fault_injector is not None and \
                hasattr(self.fault_injector, "arm"):
            # Time-indexed fault schedules fire in TRACE seconds: "crash
            # r1 at t=30" means mid-burst whatever the compression.
            self.fault_injector.arm(clock=trace_clock)
        report = ReplayReport(
            events=len(self.events), compression=self.compression,
            trace_span_s=self.events[-1].t if self.events else 0.0,
        )
        outstanding: Dict[str, TraceEvent] = {}
        # Backpressured/shed arrivals awaiting re-offer, as (event,
        # not-before trace-time). Backpressure keeps the hot re-offer
        # (not_before = now); a SHED Result's retry_after_s is honored as
        # real wall seconds (x compression = trace seconds), so the replay
        # client backs off exactly as a well-behaved caller would instead
        # of hammering the gate every poll.
        retry: List[Tuple[TraceEvent, float]] = []
        shed_retried: Dict[str, int] = {}  # id -> honored-shed count
        i = 0
        t0_wall = time.monotonic()
        reg.counter("replay_events_total", component="replay") \
            .inc(len(self.events))
        submitting = True
        abandoned = False
        while True:
            now = trace_clock.now()
            progressed = False
            if submitting:
                due: List[Tuple[TraceEvent, bool]] = []
                if retry:
                    still_held = [(ev, nb) for ev, nb in retry if nb > now]
                    due.extend((ev, True) for ev, nb in retry if nb <= now)
                    retry = still_held
                while i < len(self.events) and self.events[i].t <= now:
                    due.append((self.events[i], False))
                    i += 1
                for ev, is_retry in due:
                    # A retry re-offers an arrival the fleet already
                    # counted one rejection for; re-counting every ~1 ms
                    # poll would inflate the rejection stats by orders of
                    # magnitude during saturation.
                    if self.fleet.submit(self._request_for(ev),
                                         count_rejection=not is_retry):
                        outstanding[ev.id] = ev
                        report.accepted += 1
                        reg.counter("replay_accepted_total",
                                    component="replay").inc()
                        progressed = True
                        continue
                    res = self.fleet.take_result(ev.id)
                    if res is not None:
                        if res.retry_after_s is not None and \
                                shed_retried.get(ev.id, 0) < 1:
                            # The gate shed WITH retry advice: honor it
                            # once. No outcome is recorded — the arrival
                            # comes back after the advised backoff and
                            # its retry decides terminal-vs-shed. Trace
                            # time runs compression x wall, so wall
                            # advice maps to advice x compression.
                            shed_retried[ev.id] = \
                                shed_retried.get(ev.id, 0) + 1
                            reg.counter("replay_retry_after_honored_total",
                                        component="replay").inc()
                            retry.append(
                                (ev, now + res.retry_after_s
                                 * self.compression))
                            progressed = True
                            continue
                        # Terminal shed at the gate — an explicit refusal
                        # Result, not backpressure (or retry advice was
                        # already honored once: record the re-shed).
                        report.gate_sheds += 1
                        self._record(report, ev, res, reg, accepted=False)
                        progressed = True
                    else:
                        report.backpressured += 1
                        reg.counter("replay_backpressure_total",
                                    component="replay").inc()
                        retry.append((ev, now))
            progressed |= self.fleet.tick()
            for rid in list(outstanding):
                res = self.fleet.take_result(rid)
                if res is not None:
                    self._record(report, outstanding.pop(rid), res, reg)
                    progressed = True
            if not (i < len(self.events) or retry or outstanding
                    or self.fleet.has_work):
                if now >= report.trace_span_s + self.tail_s:
                    break
            if self.max_wall_s is not None and \
                    time.monotonic() - t0_wall > self.max_wall_s:
                if submitting:
                    # Stop offering load, keep draining what was accepted
                    # — the zero-lost contract outranks trace completion.
                    logger.warning(
                        "replay wall guard hit at %.1fs: %d events unsent, "
                        "%d outstanding — draining", self.max_wall_s,
                        len(self.events) - i + len(retry), len(outstanding))
                    report.timed_out = True
                    report.dropped += len(self.events) - i + len(retry)
                    retry = []
                    i = len(self.events)
                    submitting = False
                elif time.monotonic() - t0_wall > 2 * self.max_wall_s:
                    logger.error("replay drain guard hit; abandoning %d "
                                 "outstanding", len(outstanding))
                    abandoned = True
                    break
            if not progressed:
                time.sleep(self.poll_s)
        if not abandoned:
            # Close the stats window (also publishes per-replica stats).
            # When the drain guard fired, the fleet still OWES the
            # abandoned requests — its unbounded drain() loop would hang
            # on exactly the wedge the guard exists to escape, so the
            # stats window stays open and the report carries the loss.
            self.fleet.drain()
        report.wall_s = time.monotonic() - t0_wall
        reg.gauge("replay_outstanding", component="replay") \
            .set(len(outstanding))
        return report

    def _record(self, report: ReplayReport, ev: TraceEvent, res: Result,
                reg, accepted: bool = True) -> None:
        outcome = res.finish_reason
        if res.ok:
            outcome = "completed"
        report.outcomes[outcome] = report.outcomes.get(outcome, 0) + 1
        if self.keep_results:
            report.results[ev.id] = res
        if res.ok:
            report.tokens[ev.id] = tuple(int(t) for t in res.tokens)
        if res.ttft_s is not None:
            report.ttft_by_qos.setdefault(ev.qos, []).append(res.ttft_s)
        # Accepted terminals only: replay_accepted_total ==
        # replay_terminal_total is the machine-checkable zero-accepted-
        # then-lost witness; gate refusals count separately.
        name = ("replay_terminal_total" if accepted
                else "replay_gate_shed_total")
        reg.counter(name, component="replay", outcome=outcome).inc()


__all__ = [
    "DEFAULT_PROMPTS",
    "ReplayClock",
    "ReplayDriver",
    "ReplayReport",
    "TraceConfig",
    "TraceEvent",
    "generate_trace",
    "read_trace",
    "write_trace",
]
