"""Canary probe: catch *wrong-but-finite* output in the live serving path
(the port's copy of ``fairness_llm_tpu/integrity/canary.py``).

The numerics guards catch NaN/Inf and the manifests catch corrupt bytes at
rest, but a serving stack can also go wrong while every number stays
finite: a KV slot leaking a previous tenant's keys, a degradation
transition that left stale state behind, a kernel gone wrong on one card.
The only detector for that class is end to end: decode a GOLDEN PROMPT
through the live scheduler and compare it token for token against a
recorded reference.

``CanaryProbe`` is that comparison, packaged for ``ServingBackend``:

- ``record()`` decodes the golden prompt once, greedy, in a pool of the
  live pool's shape, and pins the expected tokens;
- ``tick()`` counts backend ``generate`` calls; every ``every_n``-th call
  is due a probe;
- ``probe(scheduler)`` serves the golden request through the live
  scheduler and compares. A mismatch counts ``canary_mismatch_total``,
  triggers a ``canary_mismatch`` incident and TRIPS the decode breaker
  open, driving the degradation ladder; recovery is the breaker's own
  half-open probe.

Where the reference comes from is the port's one difference. The reference
records it with the static engine, whose batch and cache length differ
from the serving pool's. On the card that is not the same arithmetic: K2
plans its key splits from the batch and the cache length, so a bf16 row
summed in another order parts from the engine's at near ties (PR 10 found
all 48 greedy rows of the 1,280-slot pool part from the engine path), and a
canary comparing across shapes would trip a healthy card. ``record``
serves the golden prompt through a private scheduler of the live pool's
shape instead (``serving``, the live pool's ``ServingConfig``;
``ServingBackend`` passes its own): the same rows and cache length, so the same
splits, the golden request prefilled alone in both (it runs between
backend calls, on an idle pool), so the same prefill shape, and the kernels
are deterministic, so a healthy card gives the same tokens. A paged pool
serves the golden prompt again once its blocks are cached, a suffix
prefill that sums in another order than the cold one, so the record keeps
both the cold and the warm row, and a probe must equal one of them. On the
CPU, in float32, the row equals the engine's, which the reference records.
A probe that overload control sheds (rung 3 refuses every class but
interactive) is inconclusive: ``canary_shed`` is emitted and no mismatch
counted, since tripping the breaker on a deliberate shed would turn flow
control into a fault. ``for_replica`` gives a fleet replica
(``serving/fleet.py``) a sibling probe over the same recorded rows, with
``{"replica": name}`` labels and the replica's own breaker board: the
fleet records one reference a version, in a private pool of its replicas'
shape, and every replica of that version is probed against it.
"""

from __future__ import annotations

import logging
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from fairness_llm_tpu_torch.config import ModelSettings
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline

logger = logging.getLogger(__name__)

DEFAULT_CANARY_PROMPT = (
    "List ten classic films, one per line, numbered 1 through 10."
)


class CanaryProbe:
    def __init__(
        self,
        prompt: str,
        reference_tokens: np.ndarray,
        settings: ModelSettings,
        pad_id: int,
        every_n: int = 32,
        board=None,
        component: str = "serving",
        labels: Optional[Mapping[str, str]] = None,
        alternates: Sequence[np.ndarray] = (),
    ):
        self.prompt = prompt
        # The full token row ([max_tokens], pad-filled after EOS): a served
        # result must be a prefix of it with only pads beyond. ``alternates``
        # are other healthy rows (a paged pool's warm row).
        self.reference = np.asarray(reference_tokens)
        self.alternates = tuple(np.asarray(a) for a in alternates)
        self.settings = settings
        self.pad_id = pad_id
        self.every_n = int(every_n)
        self.board = board
        self.component = component
        self.labels = dict(labels or {})
        self._calls = 0
        self._seq = 0
        # The gauge exists from construction: a healthy snapshot still shows
        # the canary was armed (1 ok / 0 mismatch / -1 never probed).
        get_registry().gauge("canary_last_ok", component=component, **self.labels).set(-1)

    @classmethod
    def record(
        cls,
        engine,
        serving,
        prompt: str = DEFAULT_CANARY_PROMPT,
        max_tokens: int = 16,
        every_n: int = 32,
        board=None,
        component: str = "serving",
    ) -> "CanaryProbe":
        """Pin the reference: the golden prompt served greedy through a
        private scheduler of ``serving``'s shape (a ``ServingConfig``) and,
        paged, served once more with its blocks cached."""
        settings = ModelSettings(temperature=0.0, max_tokens=max_tokens)
        pad = engine.tokenizer.pad_id
        from fairness_llm_tpu_torch.serving.request import Request
        from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler

        sched = ContinuousScheduler(engine, serving, settings=settings)
        rows = []
        for i in range(2 if serving.paged_kv else 1):
            res = sched.serve([Request(prompt=prompt, id=f"__canary_ref_{i}__",
                                       settings=settings, row_seed=0, qos="probe")])[0]
            if not res.ok:
                raise RuntimeError(f"canary reference decode failed: {res.error}")
            row = np.full((max_tokens,), pad, np.int32)
            row[:len(res.tokens)] = res.tokens
            rows.append(row)
        # The private pool is done: its tensors and ledger entries go.
        sched.release_memory()
        alternates = [r for r in rows[1:] if not np.array_equal(r, rows[0])]
        return cls(prompt, rows[0], settings, pad, every_n=every_n, board=board,
                   component=component, alternates=alternates)

    def for_replica(self, replica: str, board=None) -> "CanaryProbe":
        """A sibling probe sharing this probe's recorded rows, with
        per-replica labels and the replica's own breaker board (the fleet's
        rejoin gate and periodic canary): one record, one probe a replica."""
        return CanaryProbe(self.prompt, self.reference, self.settings, self.pad_id, every_n=0,
                           board=board, component=self.component,
                           labels={"replica": replica}, alternates=self.alternates)

    def tick(self) -> bool:
        """Count one backend call; True when a probe is due."""
        self._calls += 1
        return self.every_n > 0 and self._calls % self.every_n == 0

    def _matches(self, got: np.ndarray) -> bool:
        n = len(got)
        return any(n <= len(ref) and np.array_equal(got, ref[:n])
                   and np.all(ref[n:] == self.pad_id)
                   for ref in (self.reference, *self.alternates))

    def probe(self, scheduler) -> bool:
        """Serve the golden request through ``scheduler`` and compare.
        True on a token-for-token match; a mismatch trips the decode
        breaker (and with it the degradation ladder)."""
        from fairness_llm_tpu_torch.serving.request import Request

        self._seq += 1
        req = Request(prompt=self.prompt, id=f"__canary_{self._seq}__",
                      settings=self.settings, row_seed=0, qos="probe")
        probe_t0 = time.monotonic()
        res = scheduler.serve([req])[0]
        get_timeline().record_span("canary_probe", "canary",
                                   self.labels.get("replica") or self.component,
                                   probe_t0, time.monotonic() - probe_t0)
        reg = get_registry()
        if res.finish_reason == "shed":
            # Refused by overload control: inconclusive, not a mismatch.
            reg.counter("canary_runs_total", component=self.component, **self.labels).inc()
            emit_event("canary_shed", component=self.component, **self.labels)
            logger.warning("canary probe shed by overload control; inconclusive (not counted "
                           "as a mismatch)")
            return True
        got = np.asarray(res.tokens)
        ok = bool(res.ok and len(got) > 0 and self._matches(got))
        reg.counter("canary_runs_total", component=self.component, **self.labels).inc()
        reg.gauge("canary_last_ok", component=self.component, **self.labels).set(1 if ok else 0)
        record_decision(
            "canary", "ok" if ok else "mismatch",
            signals=({} if ok else {
                "finish_reason": res.finish_reason,
                "got": [int(t) for t in got[:8]],
                "expected": [int(t) for t in self.reference[:8]],
            }),
            request_id=req.id, replica=self.labels.get("replica"),
        )
        if ok:
            return True
        reg.counter("canary_mismatch_total", component=self.component, **self.labels).inc()
        # Wrong-but-finite output: bundle the evidence before the trip below
        # reshapes the ladder.
        maybe_trigger(
            "canary_mismatch",
            f"golden prompt decoded wrong tokens (finish_reason={res.finish_reason})",
            scope=self.labels.get("replica") or self.component,
            replica=self.labels.get("replica"), request_id=req.id,
        )
        emit_event("canary_mismatch", component=self.component,
                   finish_reason=res.finish_reason, got=[int(t) for t in got[:8]],
                   expected=[int(t) for t in self.reference[:8]], **self.labels)
        logger.error("canary mismatch: golden prompt decoded %s (expected a prefix of %s, "
                     "finish_reason=%s): serving output is silently wrong",
                     [int(t) for t in got[:8]], [int(t) for t in self.reference[:8]],
                     res.finish_reason)
        self._trip_breaker()
        return False

    def _trip_breaker(self) -> None:
        """Force the decode breaker open: a mismatch is direct evidence that
        the decode path produces wrong output, so it spends the whole
        failure budget at once. Recovery is the breaker's half-open probe."""
        if self.board is None or "decode" not in self.board.breakers:
            return
        self.board.trip("decode")
