"""Program first-use accounting (counterpart of
``fairness_llm_tpu/telemetry/compilestats.py``).

The reference counts XLA compilations of its compiled-program caches. The
port runs eagerly, so on the card a "compile" is **the first use of a
program key** by an engine or a scheduler: the key the reference's cache
would have compiled (the program's shape bucket, chunk and fuse), which the
port also hands the watchdog's ``first_use``. Its seconds are that first
call's wall, the reference's own convention ("compile time plus one
execution"); here they also include any ``nvcc`` build and library load the
call triggered in ``ops/_build.py``, which is where the card's real
first-use stall comes from.

- ``compiles_total{program, reason}``: one count per program key's first
  use (reason ``shape``, or ``decode_chunk`` when the degradation ladder
  resized the chunk mid-run);
- ``compile_seconds{program}``: the first call's wall;
- ``compile_cache_hits_total`` / ``compile_cache_misses_total{program}``:
  one count per lookup of a program key;
- a ``cat="compile"`` span on the timeline and a ``compile`` JSONL event
  when a sink is installed.

Program labels are the reference's: ``prefix``, ``decode``,
``spec_decode``, ``serve_prefill``, ``serve_step`` (``_fused`` with
``fuse_steps`` > 1), ``paged_prefill``, ``paged_step``. Gated, like the
whole attribution layer, on ``timeline.attribution_on()``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import attribution_on, get_timeline


def note_lookup(program: str, hit: bool, labels: Optional[Dict[str, str]] = None) -> None:
    """Count one lookup of a program key."""
    if not attribution_on():
        return
    name = "compile_cache_hits_total" if hit else "compile_cache_misses_total"
    get_registry().counter(name, component="compile", program=program, **(labels or {})).inc()


def record_compile(program: str, reason: str, seconds: float, track: str = "engine", key=None,
                   labels: Optional[Dict[str, str]] = None,
                   t0: Optional[float] = None) -> None:
    """Record one program key's first use: the counter, the first-call
    wall histogram, a timeline span and a JSONL event. ``key`` is the
    program key for diagnostics; ``t0`` the monotonic start of the call
    (defaults to now - seconds)."""
    if not attribution_on():
        return
    lbl = labels or {}
    reg = get_registry()
    reg.counter("compiles_total", component="compile", program=program, reason=reason,
                **lbl).inc()
    reg.histogram("compile_seconds", component="compile", program=program).observe(seconds)
    start = (time.monotonic() - seconds) if t0 is None else t0
    get_timeline().record_span(f"compile:{program}", "compile", track, start, seconds,
                               reason=reason, key=repr(key))
    from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

    emit_event("compile", program=program, reason=reason, seconds=round(float(seconds), 4),
               key=repr(key), **lbl)
