"""Integrity subsystem: silent-corruption detection end to end (the port's
copy of ``fairness_llm_tpu/integrity/``).

Three detectors, one per corruption shape:

- ``numerics`` — the finite flag every prefill and decode chunk already
  computes on the device, read once per chunk with its tokens; a tripped
  flag raises ``NumericsFault``, a ``DecodeFault``, so slot requeue, chunk
  retry and the breakers absorb it.
- ``manifest`` — sha256 manifests beside weights and results, verified on
  load: a bad digest refuses the artifact (weights) or falls back to an
  older one (results checkpoints), and triggers an ``integrity_fault``
  incident.
- ``canary`` — a periodic golden-prompt decode through the live serving
  scheduler, compared token for token against a reference recorded at the
  pool's own shape; a mismatch trips the decode breaker.
"""

from fairness_llm_tpu_torch.integrity.canary import DEFAULT_CANARY_PROMPT, CanaryProbe
from fairness_llm_tpu_torch.integrity.manifest import (
    MANIFEST_FILENAME,
    IntegrityError,
    maybe_verify_manifest,
    update_manifest_entry,
    verify_manifest,
    verify_manifest_entry,
)
from fairness_llm_tpu_torch.integrity.numerics import check_finite, masked_finite

__all__ = [
    "CanaryProbe",
    "check_finite",
    "DEFAULT_CANARY_PROMPT",
    "IntegrityError",
    "MANIFEST_FILENAME",
    "masked_finite",
    "maybe_verify_manifest",
    "update_manifest_entry",
    "verify_manifest",
    "verify_manifest_entry",
]
