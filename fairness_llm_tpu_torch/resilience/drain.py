"""Preemption-safe serving: graceful drain + crash-safe request journal
(the port's copy of ``fairness_llm_tpu/resilience/drain.py``; the journal's
on-disk schema is the reference's, so either package resumes the other's
journal).

A preempted host gives a serving process seconds between SIGTERM and the
kill. The scheduler's in-memory state (queue, slot pool, half-decoded
rows) is worthless across that boundary; what must survive is the *intake
contract*: every request the server accepted either reaches a terminal
Result or is durably recorded so a successor process can finish it.

Three pieces:

- :class:`ServingJournal` — an append-only ``journal.jsonl``: one
  ``submitted`` record per accepted request (id, prompt, sampler settings,
  row seed, deadline, wall timestamp) and one ``terminal`` record per
  outcome. Appends are flushed per record (the ``JsonlSink`` durability
  stance); compaction — dropping finished pairs once enough terminals
  accumulate — rewrites through a tmp file + ``os.replace`` so a preemption
  mid-rotation can never lose the journal (the same atomicity contract as
  ``pipeline/results.save_results``). ``unfinished()`` is the recovery
  read: submitted ids minus terminal ids, torn trailing line tolerated.
- :class:`GracefulDrain` — a SIGTERM/SIGINT handler that *requests* a drain
  (sets a flag the scheduler polls per loop iteration) instead of dying
  mid-call. First signal: drain; second signal: restore the
  original handler and re-deliver (the operator's escape hatch). The
  scheduler's drain stops admission, gives live slots ``drain_grace_s`` to
  finish, and preempts the rest — their journal records stay unfinished.
- :func:`resume_serving` — the successor path (CLI ``resume-serving
  <dir>``): load unfinished specs, rebuild ``Request`` objects with their
  ORIGINAL ids, sampler settings, and row seeds (greedy parity for
  survivors holds because identity is what the sampling streams key on),
  deadlines reduced by wall time already spent, and serve them — through
  one scheduler per sampler tuple, since a scheduler samples one way.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time
from typing import Callable, Dict, List, Optional

from fairness_llm_tpu_torch.telemetry import emit_event, get_registry

logger = logging.getLogger(__name__)

JOURNAL_FILENAME = "journal.jsonl"

# Journal record schema versions — the migration table. Every ``submitted``
# record written today carries ``schema_version: JOURNAL_SCHEMA_VERSION``;
# readers accept every PAST version by explicit defaulting and refuse
# FUTURE versions with :class:`JournalSchemaError` (a newer writer's
# records must not be silently misparsed by an older resume).
#
#   version  written by            migration on read
#   -------  --------------------  ----------------------------------------
#   1        pre-schema_version    no ``schema_version`` field. Subsumes
#            journals (≤ PR 19)    the pre-QoS era: missing ``qos``
#                                  defaults to "interactive" (the Request
#                                  default those runs implicitly served
#                                  as); missing ``group``/``attribute``/
#                                  ``pair_id`` default to None.
#   2        PR 20+                adds ``schema_version`` and the
#                                  optional ``version`` field (the rollout
#                                  version pin of the replica that
#                                  accepted the request; absent on
#                                  fleet-intake records not yet placed).
#                                  ``resume_serving`` uses it to keep a
#                                  resumed request's stream single-version.
JOURNAL_SCHEMA_VERSION = 2


class JournalSchemaError(RuntimeError):
    """A journal record carries a schema_version newer than this reader
    understands — refusing beats misparsing (the record may carry fields
    whose absence of handling silently corrupts the resume)."""


class ServingJournal:
    """Crash-safe intake ledger for one serving directory."""

    def __init__(self, journal_dir: str, rotate_every: int = 256):
        if rotate_every < 1:
            raise ValueError(f"rotate_every must be >= 1, got {rotate_every}")
        self.journal_dir = journal_dir
        self.path = os.path.join(journal_dir, JOURNAL_FILENAME)
        self.rotate_every = rotate_every
        self._terminals_since_rotate = 0
        os.makedirs(journal_dir, exist_ok=True)
        # Append mode: a resumed process extends the predecessor's ledger —
        # its unfinished records are exactly what the resume serves.
        self._f = open(self.path, "a", encoding="utf-8")
        # Incident bundles (telemetry/incidents.py) include this ledger's
        # tail — registration here, import lazily: the reverse edge
        # (incidents importing resilience) would cycle.
        from fairness_llm_tpu_torch.telemetry.incidents import note_journal

        note_journal(self.path)

    # -- writes --------------------------------------------------------------

    def _append(self, rec: Dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def record_submitted(self, request, version: Optional[str] = None) -> None:
        """Ledger one accepted request. Wall-clock timestamped (monotonic
        clocks don't survive the process this journal exists to outlive);
        the remaining deadline is recomputed from it at resume.
        ``version`` is the accepting replica's rollout version (None at
        fleet intake, before placement); a replica-level record for the
        same id supersedes the intake record (newest submission per id
        wins in ``unfinished``), so the pin lands in the ledger."""
        s = request.settings
        self._append({
            "kind": "submitted",
            "schema_version": JOURNAL_SCHEMA_VERSION,
            **({"version": version} if version is not None else {}),
            "id": request.id,
            "prompt": request.prompt,
            "row_seed": request.row_seed,
            "deadline_s": request.deadline_s,
            # QoS class survives the drain: a resumed batch request must
            # stay batch (or it would jump the interactive sub-queue and
            # dodge the brownout ladder in the successor process).
            "qos": getattr(request, "qos", "interactive"),
            # Study tags survive too (telemetry/fairness.py): the resumed
            # request must keep its group identity or the successor
            # process's neutrality audit would see untagged traffic.
            "group": getattr(request, "group", None),
            "attribute": getattr(request, "attribute", None),
            "pair_id": getattr(request, "pair_id", None),
            "settings": dataclasses.asdict(s) if s is not None else None,
            "ts_unix": time.time(),
        })

    def record_terminal(self, request_id: str, outcome: str) -> None:
        self._append({"kind": "terminal", "id": request_id,
                      "outcome": outcome})
        self._terminals_since_rotate += 1
        if self._terminals_since_rotate >= self.rotate_every:
            self.rotate()

    def rotate(self) -> None:
        """Compact: rewrite with only unfinished submitted records, via
        tmp + ``os.replace`` so a preemption mid-rotation leaves either the
        old complete journal or the new complete journal — never a torn
        one. (A crash between the replace and reopening the handle can lose
        nothing either: the replaced file already holds every unfinished
        record.)"""
        keep = self.unfinished()
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in keep:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        finally:
            if self._f.closed:
                self._f = open(self.path, "a", encoding="utf-8")
        self._terminals_since_rotate = 0
        get_registry().counter("journal_rotations_total",
                               component="serving").inc()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- reads ---------------------------------------------------------------

    def records(self) -> List[Dict]:
        """Every parseable record, in order (torn trailing line skipped —
        the ``read_events`` convention for killed writers)."""
        out: List[Dict] = []
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except FileNotFoundError:
            pass
        return out

    def unfinished(self) -> List[Dict]:
        """Submitted records with no terminal record, newest submission per
        id, in first-submission order — the resume workload. Raises
        :class:`JournalSchemaError` on a record from a FUTURE schema
        version (see the migration table at ``JOURNAL_SCHEMA_VERSION``);
        records without the field parse as version 1 (legacy
        defaulting)."""
        submitted: Dict[str, Dict] = {}
        order: List[str] = []
        done = set()
        for rec in self.records():
            rid = rec.get("id")
            sv = rec.get("schema_version", 1)
            if not isinstance(sv, int) or sv > JOURNAL_SCHEMA_VERSION:
                raise JournalSchemaError(
                    f"journal record for id={rid!r} in {self.path} has "
                    f"schema_version {sv!r}; this reader understands "
                    f"<= {JOURNAL_SCHEMA_VERSION} — refusing to misparse "
                    "a newer writer's journal (upgrade before resuming)"
                )
            if rec.get("kind") == "submitted" and rid is not None:
                if rid not in submitted:
                    order.append(rid)
                submitted[rid] = rec
            elif rec.get("kind") == "terminal" and rid is not None:
                done.add(rid)
        return [submitted[rid] for rid in order if rid not in done]

    def to_requests(self, specs: Optional[List[Dict]] = None) -> List:
        """Rebuild ``Request`` objects from journal specs — original id,
        settings, and row seed (the identity the sampling streams key on,
        so survivors decode the exact tokens an uninterrupted run would);
        deadlines shrink by the wall time already burned, and an
        already-blown deadline carries 0 remaining so the resuming
        scheduler expires it instead of decoding it."""
        from fairness_llm_tpu_torch.config import ModelSettings
        from fairness_llm_tpu_torch.serving.request import Request

        now = time.time()
        out = []
        for spec in (self.unfinished() if specs is None else specs):
            settings = None
            if spec.get("settings") is not None:
                fields = {f.name for f in dataclasses.fields(ModelSettings)}
                settings = ModelSettings(**{
                    k: v for k, v in spec["settings"].items() if k in fields
                })
            deadline = spec.get("deadline_s")
            if deadline is not None:
                deadline = max(0.0, deadline - (now - spec.get("ts_unix", now)))
            out.append(Request(
                prompt=spec["prompt"], id=spec["id"], settings=settings,
                row_seed=spec.get("row_seed"), deadline_s=deadline,
                # Pre-QoS journals have no field; interactive is the
                # Request default those runs were implicitly serving as.
                qos=spec.get("qos", "interactive"),
                group=spec.get("group"), attribute=spec.get("attribute"),
                pair_id=spec.get("pair_id"),
            ))
        return out


# -- graceful drain -----------------------------------------------------------

_active_drain: Optional["GracefulDrain"] = None


def drain_requested() -> bool:
    """Process-wide drain flag — the scheduler polls this once per loop
    iteration, so installing a handler anywhere (the CLI, a tool) drains
    every scheduler in the process without threading references through."""
    return _active_drain is not None and _active_drain.requested


def take_signal_telemetry() -> List[str]:
    """Flush the active handler's pending signal names into telemetry.

    Called from the scheduler loop (a safe, non-signal context) — the
    handler itself must not log or write events (see ``_handle``). Returns
    the names flushed."""
    h = _active_drain
    if h is None or not h.pending_signals:
        return []
    names, h.pending_signals = h.pending_signals, []
    for name in names:
        get_registry().counter(
            "drain_signals_total", component="serving", signal=name
        ).inc()
        emit_event("drain_requested", signal=name)
        logger.warning("drain requested by %s", name)
    return names


class GracefulDrain:
    """SIGTERM/SIGINT -> drain request. Install via context manager (or
    ``install()``/``uninstall()``); nesting replaces the active handler and
    restores the previous one on exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self.signal_count = 0
        # Signal names awaiting telemetry flush (take_signal_telemetry):
        # appended by the handler, drained by the scheduler loop.
        self.pending_signals: List[str] = []
        self._prev_handlers: Dict[int, object] = {}
        self._prev_active: Optional[GracefulDrain] = None

    def _handle(self, signum, frame) -> None:
        # Async-signal context: mutate plain Python state ONLY. Logging and
        # event emission acquire locks / write files and are not reentrant
        # — a signal landing mid-write in the JSONL sink would RuntimeError
        # and kill the very run this handler exists to protect. The
        # scheduler flushes pending_signals from its loop instead.
        self.signal_count += 1
        self.requested = True
        self.pending_signals.append(signal.Signals(signum).name)
        if self.signal_count >= 2:
            # The operator insists: restore the previous disposition and
            # re-deliver, so a wedged drain can still be killed normally.
            self.uninstall()
            signal.raise_signal(signum)

    def install(self) -> "GracefulDrain":
        global _active_drain
        for sig in self.signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handle)
        self._prev_active, _active_drain = _active_drain, self
        return self

    def uninstall(self) -> None:
        global _active_drain
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()
        if _active_drain is self:
            _active_drain = self._prev_active

    def __enter__(self) -> "GracefulDrain":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# -- resume -------------------------------------------------------------------


def resume_serving(
    engine,
    journal: ServingJournal,
    serving=None,
    resilience=None,
    fault_injector=None,
    version: Optional[str] = None,
) -> Dict[str, object]:
    """Serve a journal's unfinished requests to termination; returns
    ``{request_id: Result}``.

    One scheduler per sampler tuple (a scheduler samples one way — the
    ``ServingBackend.scheduler_for`` rule), each sharing the
    SAME journal so completions append terminal records and a drain during
    the resume journals survivors for the next attempt. Requests whose
    settings carry no sampler fields group under the scheduler default.

    ``version`` is the resuming engine's rollout version. A record pinned
    to a DIFFERENT version (the process died mid-rollout with v+1 work in
    flight) is re-decoded from scratch on THIS engine and its pin
    restamped — the wave is effectively rolled back at resume, each
    request's final token stream stays single-version, and the restamps
    are counted (``rollout_resume_restamped_total``) and logged so the
    decision is auditable. Raises :class:`JournalSchemaError` on a
    future-schema journal instead of misparsing it.
    """
    from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler

    specs = journal.unfinished()
    requests = journal.to_requests(specs)
    restamped = sorted(
        s["id"] for s in specs
        if s.get("version") is not None and s.get("version") != version
    )
    if restamped:
        get_registry().counter(
            "rollout_resume_restamped_total", component="rollout",
        ).inc(len(restamped))
        emit_event("rollout_resume_restamped", count=len(restamped),
                   to_version=version, ids=restamped[:16])
        logger.warning(
            "resume-serving: %d request(s) were pinned to another rollout "
            "version; re-decoding from scratch on this engine (version "
            "%s) — the interrupted wave is rolled back at resume",
            len(restamped), version,
        )
    emit_event("resume_serving", unfinished=len(requests))
    logger.info("resume-serving: %d unfinished request(s) in %s",
                len(requests), journal.path)
    results: Dict[str, object] = {}
    if not requests:
        return results
    groups: Dict[tuple, list] = {}
    for r in requests:
        s = r.settings
        key = (None if s is None
               else (s.temperature, s.top_k, s.top_p))
        groups.setdefault(key, []).append(r)
    for key, reqs in groups.items():
        sched = ContinuousScheduler(
            engine, serving, settings=reqs[0].settings,
            fault_injector=fault_injector, resilience=resilience,
            journal=journal,
        )
        # Re-journal under THIS engine's version: the resumed decode is
        # the stream of record now, restamped pins included.
        sched.journal_version = version
        for req, res in zip(reqs, sched.serve(reqs)):
            results[req.id] = res
    return results
