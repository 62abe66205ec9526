"""Fairness observability: streaming group metrics, the counterfactual
pair watch and the serving-neutrality audit (the port's copy of
``fairness_llm_tpu/telemetry/fairness.py``).

The study's deliverable is a fairness measurement (per-group DP, IF and
exposure over a counterfactual sweep). A serving stack that sheds, fails
or expires one demographic group's requests more than another's would
bias that measurement without any other instrument noticing. This module
watches for it with three instruments, published through the registry,
the event sink and the incident engine:

1. **Streaming group accumulators.** Requests carry optional study tags
   (``group``, ``attribute``, ``pair_id`` on ``serving/request.py``, kept
   by the serving journal); parsed results fold into per-group title-count
   and exposure accumulators. The gauges ``fairness_dp{attribute,window}``
   (``metrics/fairness.demographic_parity_kernel``),
   ``fairness_if{attribute,window}`` (Jaccard over joined pairs, empty
   against empty = 1.0) and ``fairness_exposure_ratio{attribute,window}``
   (min over max of the group mean positional exposure 1/log2(pos+2)) are
   kept over the whole run and a sliding ``window_s``; the run-window
   values at the end equal the offline phase-1 metrics to float tolerance
   (phases publish their offline scores as ``fairness_offline_*``;
   ``check_fairness`` holds the two against each other).
2. **The counterfactual pair watch.** The two members of a registered pair
   are joined as they complete; ``fairness_pair_js`` records their JS
   distance (``metrics/divergence.js_distance``). A pair is DIVERGENT only
   when serving impaired a member's delivery (failed, expired, shed or a
   decode-error row) or when a byte-identical pair produced different
   bytes: counterfactual members legitimately decode different text.
   Divergent pairs count ``fairness_pair_divergence_total{attribute,
   cause}``, emit ``fairness_pair_divergent`` events and stay in a bounded
   table with the serving events each member saw (requeues, rung).
3. **The serving-neutrality audit.** Per-(attribute, group) outcome
   counters and TTFT and queue-wait histograms, reduced to max-over-groups
   disparity gauges (``fairness_disparity{attribute,signal}``). Delivery
   rates (impaired, shed, expired, fault; exactly 0.0 in a fault-free
   run) alert past ``disparity_threshold``: ``fairness_alerts_total`` and
   ``fairness_alert``/``fairness_resolved`` events. Latency disparities
   are gauges only: a sweep submits its groups in grid order, so queue
   position, not treatment, separates their waits.

The monitor is idle (every hook returns on a dict miss) until a study
registers or a tagged request arrives. Its reductions are host-side
bookkeeping over counts and run on CPU tensors. One process-wide monitor
(``get_fairness_monitor``), with ``use_fairness_monitor`` for tests.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter as TitleCounter
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fairness_llm_tpu_torch.telemetry.registry import get_registry

# Outcomes that mean serving impaired the member's delivery (vs completed
# it). "preempted" is excluded everywhere, the SLO convention: the request
# resumes in a successor process, so judging the pair on it would page on
# every drain.
IMPAIRED_OUTCOMES = ("failed", "expired", "shed")

# Disparity signals that feed the alert machinery: delivery rates, exactly
# 0.0 for every group in a fault-free run. Latency signals stay gauge-only.
ALERTING_SIGNALS = ("impaired_rate", "shed_rate", "expired_rate",
                    "fault_rate")


def group_exposure(recs_by_group: Dict[str, Sequence[Sequence[str]]],
                   ) -> Tuple[float, Dict[str, float]]:
    """Positional-exposure ratio over per-group rec lists: each list's
    position ``p`` contributes ``1/log2(p+2)`` to its group
    (``metrics/fairness.py`` ``exposure_ratio_kernel`` semantics); the
    score is min/max of the group means. Groups with no lists are excluded
    (never NaN); no comparable groups -> 1.0 (vacuously fair). This is the
    offline reference the streaming accumulator must match — phases call
    it to publish ``fairness_offline_exposure``."""
    means: Dict[str, float] = {}
    for group, lists in recs_by_group.items():
        s, n = 0.0, 0
        for recs in lists:
            for pos in range(len(recs)):
                s += 1.0 / math.log2(pos + 2.0)
                n += 1
        if n:
            means[group] = s / n
    if not means:
        return 1.0, {}
    mx = max(means.values())
    return (min(means.values()) / mx if mx > 0 else 1.0), means


def _jaccard(a: Sequence[str], b: Sequence[str]) -> float:
    """Set Jaccard with the ``jaccard_pairs_kernel`` conventions: float32
    division, empty-vs-empty = 1.0 — so the streaming IF mean matches the
    offline kernel's to fp tolerance."""
    sa, sb = set(a), set(b)
    union = len(sa | sb)
    if union == 0:
        return 1.0
    return float(np.float32(len(sa & sb)) / np.float32(union))


def _js_distance(a: Sequence[str], b: Sequence[str]) -> float:
    """JS distance between two rec lists' count distributions through
    ``metrics/divergence.js_distance`` (shared union vocabulary; identical
    lists give 0.0, disjoint ones ~1.0; one empty side is handled by the
    kernel's renormalisation)."""
    if not a and not b:
        return 0.0
    import torch

    from fairness_llm_tpu_torch.metrics.divergence import js_distance

    vocab = sorted(set(a) | set(b))
    idx = {t: i for i, t in enumerate(vocab)}
    ca = np.zeros(len(vocab), np.float32)
    cb = np.zeros(len(vocab), np.float32)
    for t in a:
        ca[idx[t]] += 1
    for t in b:
        cb[idx[t]] += 1
    # Host-side bookkeeping over a few dozen counts, on the CPU on purpose:
    # a device round trip for every joined pair would cost more than the
    # arithmetic.
    return float(js_distance(torch.as_tensor(ca, device="cpu"),
                             torch.as_tensor(cb, device="cpu")))


@dataclasses.dataclass
class _PairState:
    """One watched counterfactual pair, filled as its members report in."""

    pair_id: str
    a: str
    b: str
    attribute: str
    # Per-member state, keyed by member key.
    outcome: Dict[str, str] = dataclasses.field(default_factory=dict)
    content: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    content_error: Dict[str, bool] = dataclasses.field(default_factory=dict)
    text: Dict[str, str] = dataclasses.field(default_factory=dict)
    prompt: Dict[str, str] = dataclasses.field(default_factory=dict)
    info: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    done: bool = False


@dataclasses.dataclass
class _GroupStats:
    """Neutrality-audit accumulator for one (attribute, group)."""

    n: int = 0
    impaired: int = 0
    shed: int = 0
    expired: int = 0
    faulted: int = 0  # requests that experienced >= 1 requeue/fault
    ttft_sum: float = 0.0
    ttft_n: int = 0
    qw_sum: float = 0.0
    qw_n: int = 0

    def rate(self, field: str) -> float:
        return getattr(self, field) / self.n if self.n else 0.0


class FairnessMonitor:
    """Streaming fairness instruments over tagged serving/pipeline traffic.

    Two feeds join inside the monitor, keyed by request key:

    - ``observe_request`` (the serving scheduler's terminal paths): outcome
      + latency decomposition + serving-event attribution — the
      neutrality audit's input, and the pair watch's outcome side.
    - ``observe_output`` (the pipeline's parse step, ``decode_sweep``):
      the parsed recommendation list — the group accumulators' input, and
      the pair watch's content side.

    Engine-only sweeps (no serving) still get the group metrics and the
    content side of the pair watch; serving-only users (tests, the chaos
    drill) still get the neutrality audit and outcome-divergence — a pair
    evaluates once both members have content when a registered study
    expects content, else once both have outcomes.
    """

    def __init__(self, window_s: float = 300.0,
                 disparity_threshold: float = 0.25,
                 min_group_n: int = 4,
                 keep_divergent: int = 64,
                 clock=time.monotonic,
                 registry=None):
        self.window_s = window_s
        self.disparity_threshold = disparity_threshold
        self.min_group_n = min_group_n
        self._clock = clock
        self._registry = registry
        self.active = False
        self._groups: Dict[str, Dict[str, str]] = {}  # key -> {attr: group}
        self._expect_content: set = set()
        self._pairs: Dict[str, _PairState] = {}
        self._pairs_by_key: Dict[str, List[str]] = {}
        self._events: Dict[str, List[str]] = {}  # key -> serving events
        # Run-window accumulators: attr -> group -> title counts / exposure.
        self._counts: Dict[str, Dict[str, TitleCounter]] = {}
        self._expo: Dict[str, Dict[str, List[float]]] = {}  # [sum, n_pos]
        # IF sums: attr (and "__all__") -> [sum, n].
        self._if: Dict[str, List[float]] = {}
        # Sliding window: (t, attr, group, TitleCounter, expo_sum, expo_n).
        self._window: Deque[Tuple] = deque()
        self._win_counts: Dict[str, Dict[str, TitleCounter]] = {}
        self._win_expo: Dict[str, Dict[str, List[float]]] = {}
        self._content_seen: set = set()
        self._stats: Dict[Tuple[str, str], _GroupStats] = {}
        self._alerting: Dict[Tuple[str, str], bool] = {}
        self._last_refresh: Optional[float] = None
        self.divergent: Deque[Dict] = deque(maxlen=keep_divergent)
        self.pairs_joined = 0
        self.pairs_divergent = 0

    # -- registration --------------------------------------------------------

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def begin_study(self) -> None:
        """Arm the monitor for a fresh study: all internal joins/
        accumulators reset (registry counters, being monotonic, keep their
        process totals — the gauges are overwritten by the new study's
        refreshes)."""
        self.__init__(window_s=self.window_s,
                      disparity_threshold=self.disparity_threshold,
                      min_group_n=self.min_group_n,
                      keep_divergent=self.divergent.maxlen,
                      clock=self._clock, registry=self._registry)
        self.active = True

    def register_request(self, key: str, groups: Dict[str, str]) -> None:
        """Declare a sweep request's group memberships, e.g.
        ``{"gender": "male", "age": "25-34"}``. Registered keys are
        expected to produce CONTENT (a parsed rec list via
        ``observe_output``), so their pairs wait for it."""
        self.active = True
        self._groups[key] = dict(groups)
        self._expect_content.add(key)

    def register_pair(self, pair_id: str, a: str, b: str,
                      attribute: str) -> None:
        """Watch one counterfactual pair (members differ only in
        ``attribute``). A key may belong to many pairs — the full IF pair
        grid registers here."""
        self.active = True
        if pair_id in self._pairs:
            return
        st = _PairState(pair_id=pair_id, a=a, b=b, attribute=attribute)
        self._pairs[pair_id] = st
        self._pairs_by_key.setdefault(a, []).append(pair_id)
        self._pairs_by_key.setdefault(b, []).append(pair_id)

    def request_tags(self, key: str) -> Optional[Tuple[str, str, Optional[str]]]:
        """Primary (attribute, group, pair_id) to stamp on a serving
        ``Request`` for ``key`` — the first registered attribute and the
        first pair containing the key. None when the key is untracked."""
        groups = self._groups.get(key)
        if not groups:
            return None
        attr = next(iter(groups))
        pids = self._pairs_by_key.get(key)
        return attr, groups[attr], (pids[0] if pids else None)

    # -- serving feed --------------------------------------------------------

    def note_event(self, key: str, event: str,
                   tagged: bool = False) -> None:
        """Attach one serving event ("requeued:device", "migrated:r1",
        ...) to a tracked request for pair/divergence attribution.
        ``tagged=True`` records even when the key has no registration yet
        — a direct-tagged request's pairs auto-register only at terminal
        time, which is AFTER its requeues/migrations happen (the caller
        holds the Request and knows it carries tags; the monitor, at this
        point, does not)."""
        if tagged or key in self._groups or key in self._pairs_by_key:
            self._events.setdefault(key, []).append(event)

    def observe_request(self, request, outcome: str,
                        queue_wait_s: Optional[float] = None,
                        ttft_s: Optional[float] = None,
                        text: str = "",
                        replica: Optional[str] = None,
                        rung: int = 0) -> None:
        """Terminal-outcome feed from the serving scheduler. ``request`` is
        a ``serving.Request``; its own ``group``/``attribute``/``pair_id``
        tags merge with any registered memberships."""
        key = request.id
        tagged_pairs = list(self._pairs_by_key.get(key, ()))
        req_pair = getattr(request, "pair_id", None)
        groups = dict(self._groups.get(key, ()))
        if getattr(request, "attribute", None) and \
                getattr(request, "group", None):
            groups.setdefault(request.attribute, request.group)
        if not groups and not tagged_pairs and req_pair is None:
            return  # untracked traffic: the common case, two dict misses
        if outcome == "preempted":
            return  # infrastructure scheduling, not treatment
        self.active = True
        if req_pair is not None and req_pair not in self._pairs:
            # Direct-serving pair: auto-register on the SECOND member (the
            # first member parks under a placeholder until its twin shows).
            half = self._pairs.get(f"__half__{req_pair}")
            if half is None:
                st = _PairState(pair_id=req_pair, a=key, b="",
                                attribute=(getattr(request, "attribute",
                                                   None) or "pair"))
                self._pairs[f"__half__{req_pair}"] = st
            elif key != half.a:
                # The twin: promote the placeholder to a real pair. (A
                # DUPLICATE terminal for the first member keeps the
                # placeholder parked instead — destroying it would orphan
                # the pair forever.)
                st = half
                del self._pairs[f"__half__{req_pair}"]
                st.b = key
                self._pairs[req_pair] = st
                self._pairs_by_key.setdefault(st.a, []).append(req_pair)
                self._pairs_by_key.setdefault(st.b, []).append(req_pair)
                tagged_pairs.append(req_pair)
        # Pop (not get): the request is terminal, so its event list must
        # not accumulate for the life of a long-running tagged service.
        events = self._events.pop(key, [])
        if request.retries and not any(e.startswith("requeued")
                                       for e in events):
            # Fallback when the requeue predates tracking (e.g. a resumed
            # journal request whose retries survived the drain).
            events = events + [f"requeued x{request.retries}"]
        info = {
            "outcome": outcome, "replica": replica, "rung": rung,
            "events": events,
        }
        impaired = outcome in IMPAIRED_OUTCOMES
        reg = self._reg()
        for attr, group in groups.items():
            reg.counter("fairness_requests_total", component="fairness",
                        attribute=attr, group=group, outcome=outcome).inc()
            if request.retries or events:
                reg.counter("fairness_faults_total", component="fairness",
                            attribute=attr, group=group).inc()
            st = self._stats.setdefault((attr, group), _GroupStats())
            st.n += 1
            st.impaired += impaired
            st.shed += outcome == "shed"
            st.expired += outcome == "expired"
            st.faulted += bool(request.retries or events)
            if ttft_s is not None:
                reg.histogram("fairness_ttft_s", component="fairness",
                              attribute=attr, group=group).observe(ttft_s)
                st.ttft_sum += ttft_s
                st.ttft_n += 1
            if queue_wait_s is not None:
                reg.histogram("fairness_queue_wait_s", component="fairness",
                              attribute=attr, group=group
                              ).observe(queue_wait_s)
                st.qw_sum += queue_wait_s
                st.qw_n += 1
            self._evaluate_disparity(attr)
        # Pair watch: record the outcome side for every pair this key is a
        # member of (plus any half-registered placeholder).
        for pid in tagged_pairs:
            ps = self._pairs.get(pid)
            if ps is None or ps.done or key not in (ps.a, ps.b):
                continue
            ps.outcome[key] = outcome
            ps.text[key] = text
            ps.prompt[key] = request.prompt
            ps.info[key] = info
            self._maybe_evaluate_pair(ps)
        half = self._pairs.get(f"__half__{req_pair}") if req_pair else None
        if half is not None and key == half.a:
            half.outcome[key] = outcome
            half.text[key] = text
            half.prompt[key] = request.prompt
            half.info[key] = info

    # -- content feed --------------------------------------------------------

    def observe_output(self, key: str, recommendations: Sequence[str],
                       error: bool = False) -> None:
        """Parsed-recommendation feed (``decode_sweep``, after parse).
        Idempotent per key — a resumed sweep's backfill pass re-offers
        already-streamed keys and they no-op, so the run-window
        accumulators always cover exactly the offline result set."""
        if key in self._content_seen:
            return
        groups = self._groups.get(key)
        in_pairs = key in self._pairs_by_key
        if not groups and not in_pairs:
            return
        self._content_seen.add(key)
        recs = [str(t) for t in recommendations]
        now = self._clock()
        for attr, group in (groups or {}).items():
            counts = self._counts.setdefault(attr, {}) \
                .setdefault(group, TitleCounter())
            counts.update(recs)
            expo = self._expo.setdefault(attr, {}).setdefault(group,
                                                             [0.0, 0])
            e = sum(1.0 / math.log2(p + 2.0) for p in range(len(recs)))
            expo[0] += e
            expo[1] += len(recs)
            # Sliding-window mirror (aged out in refresh()).
            self._window.append((now, attr, group, TitleCounter(recs), e,
                                 len(recs)))
            wc = self._win_counts.setdefault(attr, {}) \
                .setdefault(group, TitleCounter())
            wc.update(recs)
            we = self._win_expo.setdefault(attr, {}).setdefault(group,
                                                               [0.0, 0])
            we[0] += e
            we[1] += len(recs)
        for pid in self._pairs_by_key.get(key, ()):
            ps = self._pairs.get(pid)
            if ps is None or ps.done:
                continue
            ps.content[key] = recs
            ps.content_error[key] = bool(error)
            self._maybe_evaluate_pair(ps)

    # -- pair watch ----------------------------------------------------------

    def _maybe_evaluate_pair(self, ps: _PairState) -> None:
        keys = (ps.a, ps.b)
        expect_content = any(k in self._expect_content for k in keys)
        if expect_content:
            ready = all(k in ps.content for k in keys)
        else:
            ready = all(k in ps.outcome for k in keys)
        if not ready or ps.done:
            return
        ps.done = True
        self.pairs_joined += 1
        reg = self._reg()
        reg.counter("fairness_pairs_joined_total", component="fairness",
                    attribute=ps.attribute).inc()
        # Content for divergence: parsed recs when available, else the raw
        # text (whitespace-split so JS has a distribution to compare).
        def content_of(k: str) -> List[str]:
            if k in ps.content:
                return ps.content[k]
            return ps.text.get(k, "").split()

        ca, cb = content_of(ps.a), content_of(ps.b)
        js = _js_distance(ca, cb)
        reg.histogram("fairness_pair_js", component="fairness",
                      attribute=ps.attribute).observe(js)
        if all(k in ps.content for k in keys):
            sim = _jaccard(ca, cb)
            for bucket in (ps.attribute, "__all__"):
                acc = self._if.setdefault(bucket, [0.0, 0])
                acc[0] += sim
                acc[1] += 1
        # Divergence verdict: serving impaired a member's delivery, or a
        # byte-identical pair (same prompt) produced different bytes.
        impaired = {
            k: (ps.outcome.get(k) in IMPAIRED_OUTCOMES
                or ps.content_error.get(k, False))
            for k in keys
        }
        identical = (ps.a in ps.prompt and ps.b in ps.prompt
                     and ps.prompt[ps.a] == ps.prompt[ps.b])
        cause = None
        if any(impaired.values()):
            bad = next(k for k in keys if impaired[k])
            cause = ps.outcome.get(bad) or "decode_error"
        elif identical and (js > 1e-9 or ca != cb):
            cause = "content"
        if cause is None:
            return
        self.pairs_divergent += 1
        reg.counter("fairness_pair_divergence_total", component="fairness",
                    attribute=ps.attribute, cause=cause).inc()
        record = {
            "pair_id": ps.pair_id, "attribute": ps.attribute,
            "members": {
                k: {
                    "outcome": ps.outcome.get(k),
                    "error": ps.content_error.get(k, False),
                    **{f: v for f, v in (ps.info.get(k) or {}).items()
                       if f != "outcome"},
                }
                for k in keys
            },
            "js_distance": round(js, 6), "cause": cause,
        }
        self.divergent.append(record)
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        emit_event("fairness_pair_divergent", **record)
        # Incident engine (telemetry/incidents.py): a divergent
        # counterfactual pair is the paper's audit claim failing LIVE —
        # bundle the serving evidence (which replica, which requeues)
        # while the flight recorder still holds it. Deduped per attribute:
        # a biased-fault storm produces one bundle, with every divergent
        # pair already in the decision trail.
        from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger

        maybe_trigger(
            "pair_divergence",
            f"counterfactual pair {ps.pair_id} diverged ({cause})",
            scope=ps.attribute, pair_id=ps.pair_id, divergence_cause=cause,
        )

    # -- derived gauges ------------------------------------------------------

    def _dp_score(self, counts_by_group: Dict[str, TitleCounter]) -> float:
        """DP over the streamed per-group title counts through
        ``metrics/fairness.demographic_parity_kernel``: the same [G, V]
        reduction the offline wrapper feeds it, so the end-of-run values
        agree to float tolerance."""
        groups = list(counts_by_group)
        if not groups:
            return 1.0  # vacuous, the offline wrapper's convention
        import torch

        from fairness_llm_tpu_torch.metrics.fairness import demographic_parity_kernel

        vocab = sorted(set().union(*counts_by_group.values()))
        mat = np.zeros((len(groups), len(vocab)), np.float32)
        idx = {t: i for i, t in enumerate(vocab)}
        for gi, g in enumerate(groups):
            for t, c in counts_by_group[g].items():
                mat[gi, idx[t]] = c
        # On the CPU on purpose, as _js_distance: a refresh must not wait on
        # the device.
        score, _ = demographic_parity_kernel(torch.as_tensor(mat, device="cpu"))
        return float(score)

    def refresh(self) -> None:
        """Recompute every derived gauge from the accumulators: run-window
        and sliding-window DP/IF/exposure per attribute. Throttle with
        ``maybe_refresh`` on hot paths; call directly at end of sweep so
        the exported values cover everything."""
        if not self.active:
            return
        now = self._clock()
        self._last_refresh = now
        # Age the sliding window (subtract-on-evict keeps refresh O(evicted
        # + groups), not O(window)).
        cutoff = now - self.window_s
        while self._window and self._window[0][0] < cutoff:
            _, attr, group, counts, e, n = self._window.popleft()
            wc = self._win_counts[attr][group]
            wc.subtract(counts)
            for t in list(counts):
                if wc[t] <= 0:
                    del wc[t]
            we = self._win_expo[attr][group]
            we[0] -= e
            we[1] -= n
        reg = self._reg()
        for window, counts_src, expo_src in (
            ("run", self._counts, self._expo),
            ("recent", self._win_counts, self._win_expo),
        ):
            for attr in counts_src:
                live = {g: c for g, c in counts_src[attr].items() if c}
                reg.gauge("fairness_dp", component="fairness",
                          attribute=attr, window=window
                          ).set(self._dp_score(live))
                means = {
                    g: s / n
                    for g, (s, n) in expo_src.get(attr, {}).items() if n
                }
                mx = max(means.values()) if means else 0.0
                ratio = (min(means.values()) / mx) if mx > 0 else 1.0
                reg.gauge("fairness_exposure_ratio", component="fairness",
                          attribute=attr, window=window).set(ratio)
        for bucket, (s, n) in self._if.items():
            attr = "all" if bucket == "__all__" else bucket
            # No joined pairs -> 0.0, the offline wrapper's convention
            # (never NaN — the allow_nan=False contract).
            reg.gauge("fairness_if", component="fairness", attribute=attr,
                      window="run").set(s / n if n else 0.0)

    def maybe_refresh(self, min_interval_s: float = 1.0) -> None:
        if not self.active:
            return
        now = self._clock()
        if self._last_refresh is None or \
                now - self._last_refresh >= min_interval_s:
            self.refresh()

    # -- neutrality audit ----------------------------------------------------

    def _evaluate_disparity(self, attr: str) -> None:
        """Max-over-groups disparity per signal for one attribute, judged
        over groups with at least ``min_group_n`` observations (a single
        early request must not declare a disparity)."""
        stats = {g: st for (a, g), st in self._stats.items()
                 if a == attr and st.n >= self.min_group_n}
        if len(stats) < 2:
            return
        reg = self._reg()
        for signal, field in (("impaired_rate", "impaired"),
                              ("shed_rate", "shed"),
                              ("expired_rate", "expired"),
                              ("fault_rate", "faulted")):
            rates = [st.rate(field) for st in stats.values()]
            gap = max(rates) - min(rates)
            reg.gauge("fairness_disparity", component="fairness",
                      attribute=attr, signal=signal).set(gap)
            self._maybe_alert(attr, signal, gap)
        for signal, s_f, n_f in (("ttft_mean_ratio", "ttft_sum", "ttft_n"),
                                 ("queue_wait_mean_ratio", "qw_sum",
                                  "qw_n")):
            means = [getattr(st, s_f) / getattr(st, n_f)
                     for st in stats.values() if getattr(st, n_f)]
            if len(means) < 2 or max(means) <= 0:
                continue
            ratio = max(means) / max(min(means), 1e-9)
            # Gauge-only: queue position confounds per-group latency in a
            # batch sweep (groups submit in grid order).
            reg.gauge("fairness_disparity", component="fairness",
                      attribute=attr, signal=signal).set(ratio)

    def _maybe_alert(self, attr: str, signal: str, gap: float) -> None:
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        key = (attr, signal)
        was = self._alerting.get(key, False)
        if gap > self.disparity_threshold and not was:
            self._alerting[key] = True
            self._reg().counter("fairness_alerts_total",
                                component="fairness", attribute=attr,
                                signal=signal).inc()
            emit_event("fairness_alert", attribute=attr, signal=signal,
                       disparity=round(gap, 4),
                       threshold=self.disparity_threshold)
            from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger

            maybe_trigger(
                "fairness_alert",
                f"neutrality audit: {signal} disparity {gap:.3f} > "
                f"{self.disparity_threshold:g} on attribute {attr!r}",
                scope=attr, signal=signal, disparity=round(gap, 4),
            )
        elif gap <= self.disparity_threshold and was:
            self._alerting[key] = False
            emit_event("fairness_resolved", attribute=attr, signal=signal,
                       disparity=round(gap, 4))

    # -- summaries -----------------------------------------------------------

    def live_values(self) -> Dict:
        """The snapshot block phases record in result metadata: the
        run-window gauge values plus pair-watch totals (the live side of
        the live-vs-offline cross-check a study artifact carries)."""
        self.refresh()
        reg = self._reg()
        dp, expo = {}, {}
        for attr in self._counts:
            dp[attr] = reg.read_value("fairness_dp", component="fairness",
                                      attribute=attr, window="run")
            expo[attr] = reg.read_value("fairness_exposure_ratio",
                                        component="fairness",
                                        attribute=attr, window="run")
        acc = self._if.get("__all__", [0.0, 0])
        return {
            "dp": dp,
            "individual_fairness": acc[0] / acc[1] if acc[1] else 0.0,
            "exposure_ratio": expo,
            "pairs_joined": self.pairs_joined,
            "pairs_divergent": self.pairs_divergent,
            "alerts": sum(self._alerting.values()),
        }


def publish_offline_reference(dp: Dict[str, float],
                              if_score: Optional[float] = None,
                              exposure: Optional[Dict[str, float]] = None,
                              registry=None) -> None:
    """Publish a phase's OFFLINE fairness scores as ``fairness_offline_*``
    gauges, the offline side of the live-vs-offline check
    (``check_fairness``)."""
    reg = registry if registry is not None else get_registry()
    for attr, score in dp.items():
        reg.gauge("fairness_offline_dp", component="fairness",
                  attribute=attr).set(score)
    if if_score is not None:
        reg.gauge("fairness_offline_if", component="fairness",
                  attribute="all").set(if_score)
    for attr, score in (exposure or {}).items():
        reg.gauge("fairness_offline_exposure", component="fairness",
                  attribute=attr).set(score)


# -- report rendering ----------------------------------------------------------


def render_fairness_report(snap: Dict,
                           events: Optional[List[Dict]] = None,
                           width: int = 78) -> str:
    """Terminal fairness section from a telemetry snapshot (+ optional
    events.jsonl records for the divergent-pair attribution table) — the
    ``fairness-report`` CLI subcommand and the ``telemetry-report``
    fairness section."""
    gauges = [g for g in snap.get("gauges", [])
              if g.get("labels", {}).get("component") == "fairness"]
    counters = [c for c in snap.get("counters", [])
                if c.get("labels", {}).get("component") == "fairness"]
    lines = ["=" * width, "FAIRNESS SIGNALS", "=" * width]
    if not gauges and not counters:
        lines.append("(no fairness instruments in this snapshot — run with "
                     "--fairness-obs, or tag serving requests)")
        return "\n".join(lines)

    def val(name, **labels):
        for g in gauges:
            lg = g.get("labels", {})
            if g["name"] == name and all(lg.get(k) == v
                                         for k, v in labels.items()):
                return g["value"]
        return None

    attrs = sorted({g["labels"].get("attribute") for g in gauges
                    if g["name"] == "fairness_dp"} - {None})
    if attrs:
        lines.append(f"\n  {'metric':<22} {'attribute':<10} {'run':>8} "
                     f"{'recent':>8} {'offline':>8} {'delta':>9}")
        for attr in attrs:
            for metric, offline_name in (
                ("fairness_dp", "fairness_offline_dp"),
                ("fairness_exposure_ratio", "fairness_offline_exposure"),
            ):
                run = val(metric, attribute=attr, window="run")
                recent = val(metric, attribute=attr, window="recent")
                off = val(offline_name, attribute=attr)
                delta = (f"{abs(run - off):.2e}"
                         if run is not None and off is not None else "-")
                fmt = lambda x: f"{x:.4f}" if x is not None else "-"
                lines.append(f"  {metric[9:]:<22} {attr:<10} {fmt(run):>8} "
                             f"{fmt(recent):>8} {fmt(off):>8} {delta:>9}")
        run_if = val("fairness_if", attribute="all", window="run")
        off_if = val("fairness_offline_if", attribute="all")
        if run_if is not None:
            delta = f"{abs(run_if - off_if):.2e}" if off_if is not None \
                else "-"
            lines.append(f"  {'individual_fairness':<22} {'all':<10} "
                         f"{run_if:>8.4f} {'-':>8} "
                         f"{(f'{off_if:.4f}' if off_if is not None else '-'):>8}"
                         f" {delta:>9}")

    # Neutrality audit: per-group outcome table.
    by_group: Dict[Tuple[str, str], Dict[str, int]] = {}
    for c in counters:
        if c["name"] != "fairness_requests_total":
            continue
        lb = c.get("labels", {})
        key = (lb.get("attribute", "?"), lb.get("group", "?"))
        by_group.setdefault(key, {})[lb.get("outcome", "?")] = c["value"]
    if by_group:
        lines.append(f"\n  {'attribute':<10} {'group':<14} {'total':>6} "
                     f"{'outcomes'}")
        for (attr, group) in sorted(by_group):
            outs = by_group[(attr, group)]
            lines.append(f"  {attr:<10} {group:<14} "
                         f"{sum(outs.values()):>6} "
                         + ", ".join(f"{k}={v}"
                                     for k, v in sorted(outs.items())))

    disp = [g for g in gauges if g["name"] == "fairness_disparity"]
    alerts = {
        (c["labels"].get("attribute"), c["labels"].get("signal")): c["value"]
        for c in counters if c["name"] == "fairness_alerts_total"
    }
    if disp:
        lines.append(f"\n  {'disparity signal':<24} {'attribute':<10} "
                     f"{'value':>9} {'alerts':>7}")
        for g in sorted(disp, key=lambda g: (g["labels"].get("attribute", ""),
                                             g["labels"].get("signal", ""))):
            lb = g["labels"]
            n_alerts = int(alerts.get((lb.get("attribute"),
                                       lb.get("signal")), 0))
            lines.append(f"  {lb.get('signal', '?'):<24} "
                         f"{lb.get('attribute', '?'):<10} "
                         f"{g['value']:>9.4f} {n_alerts:>7}")

    joined = sum(c["value"] for c in counters
                 if c["name"] == "fairness_pairs_joined_total")
    diverged = sum(c["value"] for c in counters
                   if c["name"] == "fairness_pair_divergence_total")
    lines.append(f"\n  pair watch: {joined} joined, {diverged} divergent")
    div_events = [e for e in (events or [])
                  if e.get("kind") == "fairness_pair_divergent"]
    if div_events:
        lines.append(f"  {'pair':<18} {'attr':<8} {'cause':<16} "
                     f"{'js':>7}  members (outcome, events)")
        for e in div_events[-16:]:
            members = e.get("members", {})
            mstr = "; ".join(
                f"{k}: {v.get('outcome')}"
                + (f" [{', '.join(v.get('events') or [])}]"
                   if v.get("events") else "")
                + (f" @{v['replica']}" if v.get("replica") else "")
                for k, v in members.items()
            )
            lines.append(f"  {str(e.get('pair_id'))[:18]:<18} "
                         f"{str(e.get('attribute'))[:8]:<8} "
                         f"{str(e.get('cause')):<16} "
                         f"{e.get('js_distance', 0):>7.4f}  {mstr}")
    return "\n".join(lines)


# -- the process-wide monitor --------------------------------------------------

_monitor = FairnessMonitor()


def get_fairness_monitor() -> FairnessMonitor:
    """The process-wide monitor every hook writes to — resolved at write
    time (never cached), the ``get_registry``/``get_timeline`` contract."""
    return _monitor


def set_fairness_monitor(mon: FairnessMonitor) -> FairnessMonitor:
    global _monitor
    prev, _monitor = _monitor, mon
    return prev


class use_fairness_monitor:
    """Context manager: route fairness observation to a fresh (or given)
    monitor inside the block — test isolation, like ``use_registry``."""

    def __init__(self, mon: Optional[FairnessMonitor] = None):
        self.monitor = mon if mon is not None else FairnessMonitor()
        self._prev: Optional[FairnessMonitor] = None

    def __enter__(self) -> FairnessMonitor:
        self._prev = set_fairness_monitor(self.monitor)
        return self.monitor

    def __exit__(self, *exc) -> None:
        set_fairness_monitor(self._prev)


# -- the snapshot check ----------------------------------------------------------

# |live - offline| bound of the streaming-vs-offline check: the same kernels
# over equal count matrices, differing only in summation order (vocabulary
# order) and float32 against float64 means; observed deltas are ~1e-7.
FAIRNESS_TOLERANCE = 1e-4


def check_fairness(snap: Dict) -> List[str]:
    """The fairness gate of a fault-free study run's snapshot (the port's
    copy of the reference validator's ``--require-fairness`` check): the
    streaming group metrics populated and within ``FAIRNESS_TOLERANCE`` of
    the offline scores, the pair watch joined, and the run SILENT (no
    divergent pair, no neutrality alert). Returns the problems found."""
    problems = []
    counters = snap.get("counters", [])
    gauges = snap.get("gauges", [])

    def total(name):
        return sum(c["value"] for c in counters if c.get("name") == name)

    def gauge_rows(name, **want):
        out = []
        for g in gauges:
            lb = g.get("labels", {})
            if g.get("name") == name and all(lb.get(k) == v
                                             for k, v in want.items()):
                out.append(g)
        return out

    if not total("fairness_requests_total"):
        problems.append("fairness_requests_total is zero (no tagged "
                        "request ever finished — was --fairness-obs on?)")
    if not total("fairness_pairs_joined_total"):
        problems.append("fairness_pairs_joined_total is zero (the pair "
                        "watch never joined a counterfactual pair)")
    for name in ("fairness_dp", "fairness_if", "fairness_exposure_ratio"):
        rows = gauge_rows(name, window="run")
        if not rows:
            problems.append(f"no run-window {name} gauge (streaming "
                            "accumulators never refreshed)")
        for g in rows:
            if not 0.0 <= g["value"] <= 1.0:
                problems.append(f"{name} {g.get('labels', {})} = "
                                f"{g['value']:g} outside [0, 1]")
    # Live-vs-offline cross-check: every published offline reference must
    # have a streaming counterpart within tolerance.
    offline_of = {"fairness_offline_dp": "fairness_dp",
                  "fairness_offline_if": "fairness_if",
                  "fairness_offline_exposure": "fairness_exposure_ratio"}
    checked = 0
    for off_name, live_name in offline_of.items():
        for off in gauge_rows(off_name):
            attr = off.get("labels", {}).get("attribute")
            live = gauge_rows(live_name, attribute=attr, window="run")
            if not live:
                problems.append(f"{off_name}{{attribute={attr}}} has no "
                                f"run-window {live_name} counterpart")
                continue
            checked += 1
            delta = abs(live[0]["value"] - off["value"])
            if delta > FAIRNESS_TOLERANCE:
                problems.append(
                    f"{live_name}{{attribute={attr}}} = "
                    f"{live[0]['value']:.6f} vs offline {off['value']:.6f} "
                    f"(|delta| {delta:.2e} > {FAIRNESS_TOLERANCE:g}) — "
                    "streaming accumulation diverged from the batch metric"
                )
    if not checked:
        problems.append("no fairness_offline_* gauges (the phase never "
                        "published its offline reference scores)")
    # A fault-free run must be SILENT: serving treated every group equally
    # and no pair's delivery was impaired.
    if total("fairness_pair_divergence_total"):
        problems.append("fairness_pair_divergence_total is nonzero in a "
                        "fault-free run (serving impaired a pair member)")
    if total("fairness_alerts_total"):
        problems.append("fairness_alerts_total is nonzero in a fault-free "
                        "run (the neutrality audit saw group disparity)")
    return problems
