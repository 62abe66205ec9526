"""Device-memory ledger: per-pool accounting, reconciliation against the
allocator, per-program memory and the headroom signals (counterpart of
``fairness_llm_tpu/telemetry/memory.py``).

- **Pool ledger** (:class:`MemoryLedger`): every site that makes persistent
  device state registers its tensors under a closed pool name (``POOLS``):
  the engine's parameters, the slot pool's KV cache or the paged arena, the
  prefix-KV LRU's entries, the carried logits. The ledger sums their bytes
  (``tree_device_bytes``, each storage once) and publishes
  ``hbm_bytes{pool[, replica]}``. Re-registering a handle replaces its
  entry; releasing removes it, and a pool that drains publishes 0.
- **Reconciliation**: the ledger's total against what the device reports
  (``device_memory_stats``). On a CUDA card ``bytes_limit`` is the card's
  total memory and ``bytes_in_use`` the caching allocator's allocated
  bytes (``torch.cuda.memory_allocated()``), and the gauges carry
  ``reconciliation="measured"``; a delta beyond ``RECONCILE_TOL_FRAC`` of
  the limit counts ``hbm_reconciliation_alerts_total``. Neither number
  sees the CUDA context, cuBLAS's workspaces or the allocator's reserved but
  unallocated blocks, so the delta is tensors the ledger does not own
  (activations of a call in flight, a caller's own tensors). The CPU
  reports nothing: the gauges there are ``indicative``, and a limit can be
  injected (``set_analytic_limit``) to make the headroom arithmetic
  possible, not measured. Reading the allocator's counters is host-side:
  no register, release, refresh or headroom read synchronizes the device,
  and the card's limit is read once.
- **Per-program memory** (``program_memory_bytes{program, kind}``): the
  port's counterpart of XLA's ``memory_analysis()``, captured on the first
  armed call of each program (``costmodel.InstrumentedProgram``; armed by
  ``telemetry.configure`` or ``set_program_memory_capture``). ``argument``
  and ``output`` are the tensor bytes of the call's inputs and outputs.
  On the card ``temp`` and ``peak`` come from the allocator over that call
  (``ProgramMemoryProbe``): the call's high-water mark is the allocator's
  peak where the call raised it, else the largest allocated figure sampled
  after each operation of the call's walked part (its prefill and first
  step). The probe never calls ``torch.cuda.reset_peak_memory_stats``,
  which is process-wide: an enclosing peak measurement reads after the
  call exactly what it would have read without it. ``temp`` is that
  high-water mark above the larger of the call's start and end, ``peak``
  the arguments plus its rise over the start. On the CPU ``temp`` is 0 and
  there is no ``peak``, the reference's CPU branch.

The control plane reads the ledger softly: the paged scheduler prices a
deferred admission against the headroom and fires the ``memory_pressure``
incident, the autoscaler treats a headroom collapse as a hot signal, and
the overload ladder clamps batch budgets early. The arena allocator stays
the hard gate. ``set_attribution(False)`` silences the whole ledger, and
``set_memory_obs`` flips it alone. Single-threaded, like the scheduler loop
that drives it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import attribution_on

logger = logging.getLogger(__name__)

# Closed pool set: a mistyped pool at a call site fails, it does not open a
# new label.
POOLS = (
    "params",         # an engine's parameter tensors
    "kv_contiguous",  # a non-paged scheduler's slot KV cache
    "kv_paged",       # a paged scheduler's block arena
    "prefix_cache",   # the engine's prefix-KV LRU entries
    "logits_carry",   # a scheduler's carried next-token logits
    "other",          # anything a caller accounts that fits no pool above
)

# |device in use - ledger total| beyond this fraction of the limit counts an
# alert: generous, since the allocator also holds tensors no pool owns.
RECONCILE_TOL_FRAC = 0.2

# program_memory_bytes kinds every capture publishes; ``peak`` rides along
# where measured (the card).
PROGRAM_MEMORY_KINDS = ("argument", "output", "temp")


def _tensors(tree, out: list) -> None:
    import torch

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)


def tree_device_bytes(tree) -> int:
    """Bytes held by the tensors of ``tree`` (a tensor, or a nested
    dict/list/tuple/dataclass of them), each storage counted once: a view
    of another tensor of the tree adds nothing, and a view of part of a
    storage counts the whole storage, which is what it keeps alive."""
    seen = set()
    total = 0
    leaves: list = []
    _tensors(tree, leaves)
    for t in leaves:
        st = t.untyped_storage()
        key = (t.device, st.data_ptr(), st.nbytes())
        if key in seen:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


_card_limit: Dict[int, int] = {}


def device_memory_stats() -> Dict:
    """The current CUDA card's ``bytes_limit`` (its total memory, read once)
    and ``bytes_in_use`` (the allocator's allocated bytes); ``{}`` with no
    CUDA card, as the reference's CPU."""
    import torch

    if not torch.cuda.is_available():
        return {}
    idx = torch.cuda.current_device()
    if idx not in _card_limit:
        _card_limit[idx] = int(torch.cuda.mem_get_info(idx)[1])
    return {"bytes_limit": _card_limit[idx],
            "bytes_in_use": int(torch.cuda.memory_allocated(idx))}


class MemoryLedger:
    """Process-wide per-pool device-memory accounting.

    Entries are keyed ``(pool, name[, replica])``, ``name`` the caller's
    stable handle for one allocation site ("engine0", "sched2:arena", a
    prefix key): re-registering a handle replaces its entry, releasing
    removes it. The gauges always show the sum over live entries; a (pool,
    replica) that drains to zero publishes 0 instead of going stale.
    """

    def __init__(self):
        self.enabled = True
        self._entries: Dict[Tuple[str, str, str], int] = {}
        # Label sets ever published, so that a drained one reads 0.
        self._published: set = set()
        # Injected limit for a device that reports none (tests, drills); a
        # real device limit always wins.
        self._analytic_limit: Optional[int] = None
        self._pressure: Dict[str, bool] = {}

    def _on(self) -> bool:
        return self.enabled and attribution_on()

    def register(self, pool: str, name: str, tree, replica: Optional[str] = None) -> int:
        """Account ``tree``'s bytes under ``pool`` with handle ``name``;
        returns the bytes accounted (0 when the ledger is off)."""
        if pool not in POOLS:
            raise ValueError(f"unknown memory pool {pool!r} (choose from {POOLS})")
        if not self._on():
            return 0
        nbytes = tree_device_bytes(tree)
        self._entries[(pool, name, replica or "")] = nbytes
        self._record_ring("register", pool, name, nbytes, replica)
        self.refresh()
        return nbytes

    def release(self, pool: str, name: str, replica: Optional[str] = None) -> int:
        """Drop the entry of ``(pool, name)``; a missing entry is a no-op.
        Returns the bytes released."""
        if not self._on():
            return 0
        nbytes = self._entries.pop((pool, name, replica or ""), None)
        if nbytes is None:
            return 0
        self._record_ring("release", pool, name, nbytes, replica)
        self.refresh()
        return nbytes

    def release_matching(self, name_prefix: str, replica: Optional[str] = None) -> int:
        """Release every entry whose handle starts with ``name_prefix`` (and
        of ``replica`` when given): a retired scheduler's pools in one call.
        Returns the bytes released."""
        if not self._on():
            return 0
        victims = [k for k in self._entries
                   if k[1].startswith(name_prefix) and (replica is None or k[2] == replica)]
        freed = 0
        for k in victims:
            nbytes = self._entries.pop(k)
            freed += nbytes
            self._record_ring("release", k[0], k[1], nbytes, k[2] or None)
        if victims:
            self.refresh()
        return freed

    def entries(self, name_prefix: str = "") -> Dict[Tuple[str, str, str], int]:
        """The live entries whose handle starts with ``name_prefix``."""
        return {k: v for k, v in self._entries.items() if k[1].startswith(name_prefix)}

    def pool_bytes(self, pool: str, replica: Optional[str] = None) -> int:
        return sum(v for (p, _, r), v in self._entries.items()
                   if p == pool and (replica is None or r == (replica or "")))

    def total_bytes(self) -> int:
        return sum(self._entries.values())

    def set_analytic_limit(self, nbytes: Optional[int]) -> None:
        """Inject a byte budget for a device that reports none; the
        reconciliation stays ``indicative``."""
        self._analytic_limit = int(nbytes) if nbytes else None
        if self._on():
            self.refresh()

    def _limits(self) -> Tuple[Optional[int], Optional[int], str]:
        """(limit, bytes_in_use, mode): ``measured`` only where the device
        reported a limit."""
        stats = device_memory_stats()
        limit = stats.get("bytes_limit")
        in_use = stats.get("bytes_in_use")
        if limit:
            return int(limit), (int(in_use) if in_use is not None else None), "measured"
        return self._analytic_limit, None, "indicative"

    def reconcile(self) -> Dict:
        """Compare the ledger with the device's accounting and publish the
        limit, headroom and delta gauges. Returns the comparison."""
        limit, in_use, mode = self._limits()
        total = self.total_bytes()
        reg = get_registry()
        lbl = {"component": "memory", "reconciliation": mode}
        reg.gauge("hbm_bytes_total", **lbl).set(total)
        out = {"mode": mode, "ledger_bytes": total, "limit_bytes": limit,
               "bytes_in_use": in_use, "headroom_bytes": None, "delta_bytes": None,
               "alert": False}
        if limit is None:
            return out
        headroom = limit - max(total, in_use or 0)
        reg.gauge("hbm_bytes_limit", **lbl).set(limit)
        reg.gauge("hbm_headroom_bytes", **lbl).set(headroom)
        out["headroom_bytes"] = headroom
        if in_use is not None:
            delta = in_use - total
            reg.gauge("hbm_reconciliation_delta_bytes", **lbl).set(delta)
            out["delta_bytes"] = delta
            if abs(delta) > RECONCILE_TOL_FRAC * limit:
                # Counted, never raised: accounting must not take serving
                # down.
                out["alert"] = True
                reg.counter("hbm_reconciliation_alerts_total", component="memory").inc()
                logger.warning(
                    "hbm ledger reconciliation drift: device in_use %.1f MB vs ledger %.1f MB "
                    "(tolerance %d%% of %.1f GB limit)", in_use / 1e6, total / 1e6,
                    int(RECONCILE_TOL_FRAC * 100), limit / 1e9)
        return out

    def headroom_bytes(self) -> Optional[int]:
        limit, in_use, _ = self._limits()
        if limit is None:
            return None
        return limit - max(self.total_bytes(), in_use or 0)

    def headroom_frac(self) -> Optional[float]:
        """Headroom over the limit: the soft signal of the autoscaler and
        the overload ladder. None without a known limit: "no opinion",
        never pressure."""
        limit, in_use, _ = self._limits()
        if limit is None:
            return None
        return max(0.0, (limit - max(self.total_bytes(), in_use or 0)) / limit)

    def forecast(self, cost_bytes: int) -> Dict:
        """Would ``cost_bytes`` more device memory still fit? ``fits`` is
        None without a known limit; the caller's allocator decides either
        way."""
        limit, in_use, mode = self._limits()
        cost = max(int(cost_bytes), 0)
        if limit is None:
            return {"basis": None, "cost_bytes": cost, "headroom_bytes": None, "fits": None,
                    "headroom_after_frac": None}
        headroom = limit - max(self.total_bytes(), in_use or 0)
        return {"basis": mode, "cost_bytes": cost, "headroom_bytes": int(headroom),
                "fits": cost <= headroom,
                "headroom_after_frac": max(0.0, (headroom - cost) / limit)}

    def note_pressure(self, scope: str, on: bool) -> None:
        """Flip the per-scope ``memory_pressure_active`` gauge (1 while a
        scheduler defers admissions for blocks, 0 once one succeeds)."""
        if not self._on():
            return
        prev = self._pressure.get(scope, False)
        self._pressure[scope] = bool(on)
        lbl = {"component": "memory"}
        if scope:
            lbl["replica"] = scope
        get_registry().gauge("memory_pressure_active", **lbl).set(1.0 if on else 0.0)
        if on and not prev:
            self._record_ring("pressure", "kv_paged", scope or "serving",
                              self.pool_bytes("kv_paged"), scope or None)

    def refresh(self) -> None:
        """Re-publish every pool gauge from the live entries and reconcile."""
        if not self._on():
            return
        reg = get_registry()
        sums: Dict[Tuple[str, str], int] = {}
        for (pool, _, rep), nbytes in self._entries.items():
            sums[(pool, rep)] = sums.get((pool, rep), 0) + nbytes
        for key in self._published - set(sums):
            sums[key] = 0
        self._published |= set(sums)
        for (pool, rep), nbytes in sums.items():
            lbl = {"component": "memory", "pool": pool}
            if rep:
                lbl["replica"] = rep
            reg.gauge("hbm_bytes", **lbl).set(nbytes)
        self.reconcile()

    def _record_ring(self, event: str, pool: str, name: str, nbytes: int,
                     replica: Optional[str]) -> None:
        from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder  # lazy

        get_flight_recorder().record("memory", event=event, pool=pool, name=name,
                                     bytes=int(nbytes), total=int(self.total_bytes()),
                                     replica=replica)


_ledger = MemoryLedger()


def get_memory_ledger() -> MemoryLedger:
    return _ledger


def set_memory_ledger(ledger: MemoryLedger) -> MemoryLedger:
    global _ledger
    prev, _ledger = _ledger, ledger
    return prev


class use_memory_ledger:
    """Context manager: route accounting to a fresh (or given) ledger inside
    the block, as ``use_registry``."""

    def __init__(self, ledger: Optional[MemoryLedger] = None):
        self.ledger = ledger if ledger is not None else MemoryLedger()
        self._prev: Optional[MemoryLedger] = None

    def __enter__(self) -> MemoryLedger:
        self._prev = set_memory_ledger(self.ledger)
        return self.ledger

    def __exit__(self, *exc) -> None:
        set_memory_ledger(self._prev)


def set_memory_obs(on: bool) -> bool:
    """Flip the memory layer (pool ledger and program capture); returns the
    ledger's previous state."""
    global _program_capture
    ledger = get_memory_ledger()
    prev = ledger.enabled
    ledger.enabled = bool(on)
    _program_capture = bool(on)
    return prev


# -- per-program memory --------------------------------------------------------

# Armed with the exporters (telemetry.configure) or explicitly, as the
# reference arms its capture.
_program_capture = False


def set_program_memory_capture(on: bool) -> bool:
    global _program_capture
    prev, _program_capture = _program_capture, bool(on)
    return prev


def program_memory_capture_on() -> bool:
    return _program_capture and attribution_on() and get_memory_ledger().enabled


def publish_program_memory(program: str, argument: int, output: int, temp: int,
                           peak: Optional[int] = None) -> None:
    """``program_memory_bytes{program, kind}``, one gauge per kind."""
    reg = get_registry()
    rows = {"argument": argument, "output": output, "temp": temp}
    if peak is not None:
        rows["peak"] = peak
    for kind, val in rows.items():
        reg.gauge("program_memory_bytes", component="memory", program=program,
                  kind=kind).set(max(int(val), 0))


class ProgramMemoryProbe:
    """One call's device memory, without resetting the allocator's peak
    (see the module docstring). ``sample`` after each operation; ``publish``
    once the call returned."""

    def __init__(self, device):
        import torch

        self.cuda = device is not None and torch.device(device).type == "cuda"
        if self.cuda:
            self._torch = torch
            self.index = torch.device(device).index
            if self.index is None:
                self.index = torch.cuda.current_device()
            self.start = torch.cuda.memory_allocated(self.index)
            self.peak0 = torch.cuda.max_memory_allocated(self.index)
            self.high = self.start

    def sample(self) -> None:
        if self.cuda:
            # The allocator's nested counters, read without the flattening
            # ``memory_allocated`` does: this runs after every walked op.
            stats = self._torch.cuda.memory_stats_as_nested_dict(self.index)
            self.high = max(self.high, stats["allocated_bytes"]["all"]["current"])

    def publish(self, program: str, args, out) -> None:
        argument, output = tree_device_bytes(args), tree_device_bytes(out)
        if not self.cuda:
            publish_program_memory(program, argument=argument, output=output, temp=0)
            return
        cuda = self._torch.cuda
        end = cuda.memory_allocated(self.index)
        peak_after = cuda.max_memory_allocated(self.index)
        high = peak_after if peak_after > self.peak0 else max(self.high, end)
        publish_program_memory(program, argument=argument, output=output,
                               temp=max(0, high - max(self.start, end)),
                               peak=argument + max(0, high - self.start))


# -- snapshot reading / report ---------------------------------------------------


def has_memory_data(snap: Dict) -> bool:
    return any(g.get("name") == "hbm_bytes" for g in snap.get("gauges", []))


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{int(n)} B"


def render_memory_report(snap: Dict) -> str:
    """The ``memory-report`` section: per-pool residency, the reconciliation
    verdict and the per-program memory table. The text is the reference's
    (but for the empty snapshot's note), so one snapshot renders alike in
    both packages."""
    gauges = snap.get("gauges", [])
    lines: List[str] = ["HBM memory ledger", "=" * 17]

    def val(name) -> Optional[Dict]:
        for g in gauges:
            if g.get("name") == name:
                return g
        return None

    total = val("hbm_bytes_total")
    mode = (total or {}).get("labels", {}).get("reconciliation")
    limit = val("hbm_bytes_limit")
    headroom = val("hbm_headroom_bytes")
    delta = val("hbm_reconciliation_delta_bytes")
    alerts = sum(c.get("value", 0) for c in snap.get("counters", [])
                 if c.get("name") == "hbm_reconciliation_alerts_total")
    if total is None:
        lines.append("no hbm_bytes gauges in this snapshot (the ledger "
                     "never registered a pool — attribution off, or a run "
                     "that predates the ledger)")
        return "\n".join(lines)
    if mode == "measured":
        lines.append("reconciliation: measured (device reports "
                     "memory_stats; delta gauge is evidence)")
    else:
        lines.append("reconciliation: indicative (backend reports no "
                     "memory_stats — analytic accounting only)")
    lines.append(
        f"ledger total {_fmt_bytes(total.get('value'))}"
        + (f"  limit {_fmt_bytes(limit.get('value'))}" if limit else "")
        + (f"  headroom {_fmt_bytes(headroom.get('value'))}" if headroom else "")
        + (f"  delta vs device {_fmt_bytes(delta.get('value'))}" if delta else "")
    )
    if alerts:
        lines.append(f"RECONCILIATION ALERTS: {int(alerts)} (ledger vs "
                     "device drift beyond tolerance)")
    pool_rows = [g for g in gauges if g.get("name") == "hbm_bytes"]
    plain = [g for g in pool_rows if "shard" not in g.get("labels", {})]
    sharded = [g for g in pool_rows if "shard" in g.get("labels", {})]
    if plain:
        lines.append("")
        lines.append(f"{'pool':<14} {'replica':<12} {'bytes':>12}")
        for g in sorted(plain, key=lambda g: (g["labels"].get("pool", ""),
                                              g["labels"].get("replica", ""))):
            lb = g.get("labels", {})
            lines.append(f"{lb.get('pool', '?'):<14} {lb.get('replica', '-'):<12} "
                         f"{_fmt_bytes(g.get('value')):>12}")
    if any(g.get("value", 0) for g in sharded):
        lines.append("")
        lines.append(f"{'pool':<14} {'shard':<8} {'bytes':>12}")
        for g in sorted(sharded, key=lambda g: (g["labels"].get("pool", ""),
                                                g["labels"].get("shard", ""))):
            lb = g.get("labels", {})
            lines.append(f"{lb.get('pool', '?'):<14} {lb.get('shard', '?'):<8} "
                         f"{_fmt_bytes(g.get('value')):>12}")
    prog: Dict[str, Dict[str, float]] = {}
    for g in gauges:
        if g.get("name") != "program_memory_bytes":
            continue
        lb = g.get("labels", {})
        prog.setdefault(lb.get("program", "?"), {})[lb.get("kind", "?")] = \
            float(g.get("value", 0.0))
    if prog:
        lines.append("")
        lines.append("per-program AOT memory (compiled.memory_analysis, "
                     "per device)")
        lines.append(f"{'program':<26} {'argument':>10} {'output':>10} "
                     f"{'temp':>10} {'peak':>10}")
        for p in sorted(prog):
            k = prog[p]
            lines.append(f"{p:<26} {_fmt_bytes(k.get('argument')):>10} "
                         f"{_fmt_bytes(k.get('output')):>10} "
                         f"{_fmt_bytes(k.get('temp')):>10} "
                         f"{_fmt_bytes(k.get('peak')):>10}")
    pressure = [g for g in gauges
                if g.get("name") == "memory_pressure_active" and g.get("value", 0)]
    if pressure:
        scopes = ", ".join(g.get("labels", {}).get("replica", "serving") for g in pressure)
        lines.append("")
        lines.append(f"MEMORY PRESSURE ACTIVE: {scopes} (admissions "
                     "deferring on block exhaustion)")
    return "\n".join(lines)


def check_memory(snap: Dict) -> List[str]:
    """The memory gate of the reference's ``tools/validate_telemetry.py
    --require-memory`` (which imports the JAX package), the same problems
    for the same snapshot: the params pool and a KV pool are nonzero, the
    ledger reconciled and fits under the limit, and every program in
    ``compiles_total`` published its ``argument``/``output``/``temp``
    memory."""
    problems = []
    gauges = snap.get("gauges", [])
    pool_bytes: Dict[str, float] = {}
    for g in gauges:
        lb = g.get("labels", {})
        if g.get("name") != "hbm_bytes" or "shard" in lb:
            continue
        pool_bytes[lb.get("pool")] = pool_bytes.get(lb.get("pool"), 0.0) + float(
            g.get("value", 0.0))
    if pool_bytes.get("params", 0.0) <= 0:
        problems.append("hbm_bytes{pool=params} is zero or absent (no engine ever registered "
                        "its param tree)")
    if pool_bytes.get("kv_contiguous", 0.0) <= 0 and pool_bytes.get("kv_paged", 0.0) <= 0:
        problems.append("neither hbm_bytes{pool=kv_contiguous} nor {pool=kv_paged} is nonzero "
                        "(no scheduler ever registered its KV state)")
    total = sum(float(g.get("value", 0.0)) for g in gauges if g.get("name") == "hbm_bytes_total")
    limit = sum(float(g.get("value", 0.0)) for g in gauges if g.get("name") == "hbm_bytes_limit")
    if total <= 0:
        problems.append("hbm_bytes_total is zero or absent (the ledger never reconciled)")
    if limit > 0 and total > limit:
        problems.append(f"ledger total {total:.0f} B exceeds the HBM limit {limit:.0f} B (the "
                        "accounting claims more memory than the device has)")
    compiled = sorted({c.get("labels", {}).get("program") for c in snap.get("counters", [])
                       if c.get("name") == "compiles_total" and c.get("value")} - {None})
    if not compiled:
        problems.append("compiles_total is empty (no compiled program to require AOT memory "
                        "analysis for)")
    prog_kinds: Dict[str, set] = {}
    for g in gauges:
        if g.get("name") != "program_memory_bytes":
            continue
        lb = g.get("labels", {})
        prog_kinds.setdefault(lb.get("program"), set()).add(lb.get("kind"))
    for prog in compiled:
        missing = set(PROGRAM_MEMORY_KINDS) - prog_kinds.get(prog, set())
        if missing:
            problems.append(f"compiled program {prog!r} missing program_memory_bytes kinds "
                            f"{sorted(missing)} (AOT memory_analysis never captured for it)")
    return problems

