"""``ServingBackend``: the continuous-batching server behind the
``DecodeBackend`` protocol (counterpart of
``fairness_llm_tpu/serving/backend.py``), so that phases 1-3 run through
the server unchanged: ``backend_for`` returns one when
``Config.serving.enabled`` (CLI ``--continuous``).

How it differs from ``EngineBackend``:

- each row decodes on its own in a KV slot; the sweep-wide shared prefix
  (``prefix_ids``) is accepted and ignored (``use_shared_prefix`` is False,
  so ``shared_prefix_ids`` does not compute it). Greedy output equals
  ``EngineBackend`` with ``share_prefix=False`` token for token;
- the serving counters add up in ``serve_totals`` (a ``ServingStats``), as
  ``EngineBackend.spec_totals`` do, and the last call's ``GenerateOutput``
  (with ``stats["serving"]``) is kept in ``last_output``;
- a request that failed (a second fault) or was preempted by a drain comes
  back as a ``None`` text (the ``with_failure_containment`` sentinel), not
  a failed chunk, because the scheduler contains faults per request;
- with ``resilience`` enabled one ``BreakerBoard`` is shared by every
  scheduler and the engine's speculate gate, and the ladder's last rung
  lives here: at level 3 (``static_fallback``) new calls run through the
  static ``DecodeEngine`` (the same hand-written kernels, another program)
  until the ladder retreats;
- with ``integrity.canary_every_n`` set, a golden-prompt canary
  (``integrity/canary.py``) decodes through the live scheduler every N
  calls, compared token for token against a reference recorded at the
  pool's own shape; a mismatch trips the decode breaker;
- ``fault_injector``, ``journal`` and ``overload`` (an enabled
  ``OverloadConfig``: the QoS queue, the shed controller and deadline
  admission) go through to every scheduler. Sweep requests ride the
  ``batch`` class, the one a brownout sheds first; a shed row comes back
  as ``None``, the sentinel the sweep's containment retries;
- with the fairness monitor armed (``--fairness-obs``: a phase registered
  its profile grid) each sweep request carries its study tags
  (``attribute``, ``group``, ``pair_id``), so that the serving layer's
  treatment of each group is observable per request;
- with ``fleet.replicas`` > 1 (``--replicas N``) or ``autoscale`` on
  (``--autoscale``, a fleet even of one), each sampler tuple gets a
  ``ReplicaSet`` (``serving/fleet.py``) instead of one scheduler: N fault
  domains behind the health router over the engine's one weight tree, the
  second and later fleets named ``s1``, ``s2``, ... There is no shared
  board then (each replica has its own breakers, ladder and watchdog), the
  static-fallback rung gives way to fence, migrate and rejoin, and the
  periodic canary probes one replica a time (``ReplicaSet.periodic_canary``).

A fatal CUDA error raises out of ``generate``, from a scheduler or a fleet.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from fairness_llm_tpu_torch.config import (
    AutoscaleConfig,
    FleetConfig,
    IntegrityConfig,
    ModelSettings,
    OverloadConfig,
    ResilienceConfig,
    ServingConfig,
)
from fairness_llm_tpu_torch.resilience.breaker import BreakerBoard
from fairness_llm_tpu_torch.resilience.drain import ServingJournal
from fairness_llm_tpu_torch.serving.fleet import ReplicaSet
from fairness_llm_tpu_torch.serving.request import Request
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler
from fairness_llm_tpu_torch.telemetry import get_registry
from fairness_llm_tpu_torch.telemetry.fairness import get_fairness_monitor

logger = logging.getLogger(__name__)


class ServingBackend:
    # shared_prefix_ids skips the sweep-wide prefix for this backend
    use_shared_prefix = False

    def __init__(self, engine, serving: Optional[ServingConfig] = None,
                 name: Optional[str] = None, fault_injector=None,
                 resilience: Optional[ResilienceConfig] = None,
                 journal: Optional[ServingJournal] = None,
                 integrity: Optional[IntegrityConfig] = None,
                 fleet: Optional[FleetConfig] = None,
                 overload: Optional[OverloadConfig] = None,
                 autoscale: Optional[AutoscaleConfig] = None):
        self.engine = engine
        self.serving = serving or ServingConfig(enabled=True)
        self.name = name or engine.config.name
        self.fault_injector = fault_injector
        self.resilience = resilience
        self.journal = journal
        self.integrity = integrity
        self.overload = overload if (overload is not None and overload.enabled) else None
        # --autoscale implies a fleet even at one replica: a fleet of one
        # can grow, a bare scheduler cannot.
        self.autoscale = autoscale if (autoscale is not None and autoscale.enabled) else None
        if fleet is not None and fleet.replicas > 1:
            self.fleet: Optional[FleetConfig] = fleet
        elif self.autoscale is not None:
            self.fleet = fleet or FleetConfig(replicas=1)
        else:
            self.fleet = None
        self._fleet_seq = 0  # ReplicaSets this backend built
        # The canary is recorded on the first generate(), not here: its
        # reference decode must not land in the backend's construction.
        self._canary = None
        self._canary_sched = None
        self._canary_calls = 0  # fleet mode's call counter
        self.board: Optional[BreakerBoard] = None
        # Fleet mode keeps resilience per replica: one shared board would
        # couple again the fault domains the fleet separates.
        if self.fleet is None and resilience is not None and resilience.enabled:
            # ONE board for the backend: every scheduler's prefill/decode
            # breakers and the engine's speculate gate share it, so the
            # ladder sees the process's health.
            self.board = BreakerBoard(failure_threshold=resilience.breaker_threshold,
                                      cooldown_s=resilience.breaker_cooldown_s)
            self.engine.breakers = self.board
            if resilience.max_step_seconds > 0 and self.engine.watchdog is None:
                from fairness_llm_tpu_torch.resilience.watchdog import StepWatchdog

                # The static-fallback rung runs engine.generate directly, with
                # the same hang classification as the scheduler.
                self.engine.watchdog = StepWatchdog(resilience.max_step_seconds,
                                                    component="engine")
        self.serve_totals = None  # Optional[ServingStats]
        self.last_output = None  # GenerateOutput of the most recent call
        self._schedulers: dict = {}

    def scheduler_for(self, settings: ModelSettings):
        """One scheduler per sampler tuple, or in fleet mode one
        ``ReplicaSet`` (the same ``serve``/``last_stats`` surface; the first
        keeps the plain r0, r1 labels, later ones are named s1, s2, ...).
        Each holds KV pools, so at most two are kept (least recently used
        first out)."""
        key = (settings.temperature, settings.top_k, settings.top_p)
        sched = self._schedulers.pop(key, None)
        if sched is None:
            if self.fleet is not None:
                sched = ReplicaSet(self.engine, self.serving, settings=settings,
                                   fleet=self.fleet, resilience=self.resilience,
                                   journal=self.journal, fault_injector=self.fault_injector,
                                   integrity=self.integrity,
                                   name=None if self._fleet_seq == 0 else f"s{self._fleet_seq}",
                                   overload=self.overload, autoscale=self.autoscale)
                self._fleet_seq += 1
            else:
                sched = ContinuousScheduler(self.engine, self.serving, settings=settings,
                                            fault_injector=self.fault_injector,
                                            resilience=self.resilience, journal=self.journal,
                                            breakers=self.board, overload=self.overload)
            while len(self._schedulers) >= 2:
                del self._schedulers[next(iter(self._schedulers))]
        self._schedulers[key] = sched
        return sched

    def _maybe_canary(self, live_sched=None) -> None:
        """Record the canary on first use and probe it when due (every
        ``integrity.canary_every_n`` calls), before the user batch, so that
        detected corruption degrades the path before more traffic lands on
        it. In fleet mode the fleet serving this call probes one replica
        with that replica's own canary and board."""
        integ = self.integrity
        if integ is None or integ.canary_every_n <= 0:
            return
        if isinstance(live_sched, ReplicaSet):
            self._canary_calls += 1
            if self._canary_calls % integ.canary_every_n == 0:
                live_sched.periodic_canary()
            return
        if self._canary is None:
            from fairness_llm_tpu_torch.integrity.canary import CanaryProbe

            self._canary = CanaryProbe.record(
                self.engine, self.serving, max_tokens=integ.canary_max_tokens,
                every_n=integ.canary_every_n, board=self.board)
        if self._canary.tick():
            self._canary.probe(self._canary_scheduler())

    def _canary_scheduler(self) -> ContinuousScheduler:
        """The live greedy scheduler when user traffic is greedy; else a
        dedicated greedy scheduler of the same pool shape, held outside the
        LRU (routing it through ``scheduler_for`` would evict a warm user
        scheduler), sharing the board but not the journal (a probe is
        synthetic traffic no successor may resume)."""
        s = self._canary.settings
        live = self._schedulers.get((s.temperature, s.top_k, s.top_p))
        if live is not None:
            return live
        if self._canary_sched is None:
            self._canary_sched = ContinuousScheduler(
                self.engine, self.serving, settings=s, resilience=self.resilience,
                breakers=self.board)
        return self._canary_sched

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,  # accepted, unused
    ) -> List[Optional[str]]:
        """Texts in prompt order; None for a request that did not complete
        (a deadline, a second fault, a drain, a shed), so that a sweep
        retries it."""
        from fairness_llm_tpu_torch.pipeline.backends import _stable_hash
        from fairness_llm_tpu_torch.runtime.engine import GenerateOutput

        settings = settings or ModelSettings()
        if not prompts:
            self.last_output = GenerateOutput(texts=[], tokens=np.zeros((0, 0), np.int32),
                                              steps=0)
            return []
        if self.board is not None and self.board.ladder.level >= 3 \
                and not (self.board.allow("prefill") and self.board.allow("decode")):
            # Degradation rung 3: the server proved unhealthy enough that
            # new calls take the static engine. The allow() consults make the
            # rung recoverable: once the open breakers' cooldowns elapse they
            # half-open and the call falls through to the scheduler as the
            # probe, whose outcome closes (or re-opens) them.
            logger.warning("degradation level %d (%s): serving %d prompt(s) through the "
                           "static engine", self.board.ladder.level, self.board.ladder.rung,
                           len(prompts))
            get_registry().counter("static_fallback_calls_total", component="serving").inc()
            # The same row-seed formula, so that greedy and sampled output
            # stay the same across the fallback; serve_totals do not count it.
            row_seeds = None
            if keys is not None:
                row_seeds = [(_stable_hash(k) ^ seed) & 0xFFFFFFFF for k in keys]
            out = self.engine.generate(prompts, settings, seed=seed, row_seeds=row_seeds,
                                       share_prefix=False)
            self.last_output = out
            return list(out.texts)
        sched = self.scheduler_for(settings)
        self._maybe_canary(sched)
        mon = get_fairness_monitor()
        requests = []
        for i, p in enumerate(prompts):
            if keys is not None:
                # EngineBackend's row-seed formula: stable identity
                rid, row_seed = keys[i], (_stable_hash(keys[i]) ^ seed) & 0xFFFFFFFF
            else:
                rid, row_seed = f"call{seed}_{i:05d}", (seed * 1_000_003 + i) & 0xFFFFFFFF
            tags = mon.request_tags(rid) if mon.active else None
            requests.append(Request(prompt=p, id=rid, settings=settings, row_seed=row_seed,
                                    qos="batch", attribute=tags[0] if tags else None,
                                    group=tags[1] if tags else None,
                                    pair_id=tags[2] if tags else None))
        results = sched.serve(requests)
        stats = sched.last_stats
        self.serve_totals = stats if self.serve_totals is None else self.serve_totals.merge(stats)
        cap = max((len(r.tokens) for r in results), default=0)
        toks = np.full((len(results), cap), self.engine.tokenizer.pad_id, np.int32)
        for i, r in enumerate(results):
            toks[i, : len(r.tokens)] = r.tokens
        self.last_output = GenerateOutput(
            texts=[r.text if r.ok else "" for r in results],
            tokens=toks,
            steps=sched.serving.max_new_tokens,
            stats={
                "batch": sched.num_slots,
                "prompt_len": sched.max_prompt_bucket,
                "prefix_len": 0,
                "cache_slots": sched.cache_len,
                "decode_kernel": bool(self.engine.config.use_decode_attention_kernel),
                "prefill_s": sched.last_seconds["prefill"],
                "decode_s": sched.last_seconds["decode"],
                "serving": stats.as_dict(),
            },
        )
        return [r.text if r.ok else None for r in results]
