"""Numerics guards: one reduced finite flag per chunk (the port's copy of
``fairness_llm_tpu/integrity/numerics.py``).

A NaN or Inf in the logits is the silent killer of a greedy sweep:
``argmax`` over a NaN row returns a fixed index, so a numerically poisoned
decode emits a plausible-looking stream of one token and the fairness
report downstream is garbage with no error anywhere.

The guard is shaped for the decode hot path:

- **Device-side AND-reduction.** The decode loops (``runtime/stepbuilder``)
  already fold ``masked_finite(logits, live)`` into one device bool across
  a chunk's steps (``LoopOut.finite``); the prefills compute one over their
  last logits. The host reads the flag once per chunk, after the chunk's
  tokens are back, so a guarded chunk adds no sync and no kernel per step.
- **Live-row masking.** Bucket-padding rows, finished rows and released
  slots carry whatever bytes they carry; only rows that are decoding can
  trip the flag.
- **Host-side classification.** ``check_finite`` turns a tripped flag into
  a :class:`~fairness_llm_tpu_torch.utils.failures.NumericsFault`, a
  ``DecodeFault``, so the scheduler's slot requeue, the pipeline's chunk
  retry and the circuit breakers absorb it as any other decode fault, plus
  a per-stage ``numerics_faults_total{component,stage}`` counter and an
  event.

The guard never touches the sampled token stream: greedy output with guards
on equals guards off, token for token.
"""

from __future__ import annotations

from typing import Optional

import torch

from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.utils.failures import NumericsFault


def masked_finite(values: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device bool: every element of ``values`` is finite, counting only the
    rows where ``live`` (a [B] mask over the leading axis) is True. A pure
    reduction: no host sync."""
    ok = torch.isfinite(values)
    if live is not None:
        ok = ok | ~live.reshape((-1,) + (1,) * (values.dim() - 1))
    return ok.all()


def check_finite(flag, component: str, stage: str) -> None:
    """Host-side classification of a chunk's finite flag (a bool or a
    device scalar: callers check after the chunk's tokens came back, so the
    read costs no extra wait). Raises :class:`NumericsFault` on a tripped
    flag; the message names the component and stage."""
    if bool(flag):
        return
    get_registry().counter("numerics_faults_total", component=component, stage=stage).inc()
    emit_event("numerics_fault", component=component, stage=stage)
    raise NumericsFault(
        f"non-finite logits in {component} {stage} chunk (numerics guard); "
        "discarding the chunk's tokens"
    )
