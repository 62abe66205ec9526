"""Live roofline accounting: the bytes-per-step model as registry gauges
(counterpart of ``fairness_llm_tpu/telemetry/roofline.py``).

A decode step is memory-bound: its floor is (device bytes the step must
stream) / (bandwidth the card can sustain). Fed per decode call by the
engine and per decode chunk by the serving scheduler:

- ``decode_step_bytes{program, ...}``: device bytes one step streams
  (parameters at compute width, the pool's KV slots, the shared prefix KV,
  and the paged view's gather and scatter amortized over the chunk);
- ``achieved_hbm_gbps{program, ...}``: bytes x steps / wall of the last
  call, plus an ``achieved_hbm_gbps_dist`` histogram of the same;
- ``achieved_over_achievable{program, ...}``: that rate over the reference
  bandwidth below; and a ``roofline`` sample in the flight recorder.

The reference bandwidth, in order: the override (``set_achievable_gbps``,
which ``TelemetryConfig.achievable_gbps`` and the CLI's
``--achievable-gbps`` set), then the card's entry in ``CARDS`` (keyed by
``torch.cuda.get_device_name()``), then, with no CUDA card, the
reference's nominal ``CPU_NOMINAL_GBPS`` (indicative only). A CUDA card
missing from ``CARDS`` raises: its bandwidth is unknown, and the CPU figure
would make every fraction meaningless. The host wall of a call includes its
prefill and any first-use kernel build, so the fraction is a lower bound.

Gated, like the whole attribution layer, on ``timeline.attribution_on()``.
"""

from __future__ import annotations

from typing import Dict, Optional

from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import attribution_on

# Per-card references, keyed by torch.cuda.get_device_name(): the memory
# bandwidth and the dense bf16 tensor-core peak of the card's data sheet.
CARDS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_gflops": 989_000.0},
}
# Without a CUDA card: the reference's nominal DDR4-class streaming figure,
# so that the fraction stays defined on the CPU. Indicative only.
CPU_NOMINAL_GBPS = 16.0

_achievable_override: Optional[float] = None


def set_achievable_gbps(gbps: Optional[float]) -> None:
    """Install a measured bandwidth reference (None restores the card's
    default). ``TelemetryConfig.achievable_gbps`` routes here."""
    global _achievable_override
    _achievable_override = float(gbps) if gbps else None


def card_name() -> Optional[str]:
    """The CUDA card's name, or None without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def reference_achievable_gbps() -> float:
    """The denominator of ``achieved_over_achievable``: the override when
    installed, else the card's ``CARDS`` entry, else (no CUDA card) the CPU
    nominal. A CUDA card without an entry raises ``RuntimeError``."""
    if _achievable_override is not None:
        return _achievable_override
    name = card_name()
    if name is None:
        return CPU_NOMINAL_GBPS
    entry = CARDS.get(name)
    if entry is None:
        raise RuntimeError(
            f"no reference memory bandwidth for the card {name!r}: measure one and pass "
            "--achievable-gbps (TelemetryConfig.achievable_gbps, or "
            "telemetry.set_achievable_gbps)")
    return entry["hbm_gbps"]


def decode_step_bytes(config, stats) -> int:
    """Device bytes one decode step must stream: every parameter once, each
    row's KV cache (its remainder prompt and generated slots), and the
    shared prefix KV once for the whole batch. ``stats`` carries ``batch``,
    ``cache_slots`` and ``prefix_len`` (``GenerateOutput.stats``'s shape).

    With ``stats["paged_kv"]`` the serve step also gathers the pool's view
    from the block arena and scatters it back once a chunk: 4x the pool's
    KV (arena read, view write, view read, block write), amortized over
    ``stats["chunk_steps"]``, the steps the chunk ran.

    Parameters count at the compute width: int8 weights at one byte with
    the embedding at the model's width (the int8 kernels stream int8), the
    rest at 2 bytes for a bf16 config and 4 for f32. An int8 KV cache reads
    one byte a value plus its f32 scale per (slot, head); the shared prefix
    is read at the model's width either way (it is kept dequantized)."""
    model_item = 2 if config.dtype == "bfloat16" else 4
    if config.weight_quant == "int8":
        embed = config.vocab_size * config.d_model
        params = (config.approx_param_count - embed) * 1 + embed * model_item
    else:
        params = config.approx_param_count * model_item
    if config.kv_cache_quant:
        per_head_slot = config.head_dim * 1 + 4
    else:
        per_head_slot = config.head_dim * model_item
    per_slot = config.num_kv_heads * per_head_slot * 2 * config.num_layers
    kv = stats["batch"] * stats["cache_slots"] * per_slot
    prefix = stats["prefix_len"] * (
        config.num_kv_heads * config.head_dim * model_item * 2 * config.num_layers)
    paged = 0
    if stats.get("paged_kv"):
        chunk_steps = max(int(stats.get("chunk_steps", 1)), 1)
        paged = 4 * kv // chunk_steps
    return params + kv + prefix + paged


def observe_decode(config, stats: Dict, steps: int, wall_s: float, program: str,
                   labels: Optional[Dict[str, str]] = None) -> Optional[Dict]:
    """Fold one decode call into the roofline gauges. ``stats`` as in
    ``decode_step_bytes``; ``steps`` the steps the call ran; ``wall_s`` its
    host wall. Returns the computed numbers, or None when gated off or
    nothing ran."""
    if not attribution_on() or steps <= 0 or wall_s <= 0:
        return None
    lbl = labels or {}
    step_bytes = decode_step_bytes(config, stats)
    gbps = step_bytes * steps / wall_s / 1e9
    achievable = reference_achievable_gbps()
    frac = gbps / achievable if achievable > 0 else 0.0
    reg = get_registry()
    reg.gauge("decode_step_bytes", component="roofline", program=program, **lbl).set(step_bytes)
    reg.gauge("achieved_hbm_gbps", component="roofline", program=program, **lbl).set(gbps)
    reg.histogram("achieved_hbm_gbps_dist", component="roofline", program=program,
                  **lbl).observe(gbps)
    reg.gauge("achieved_over_achievable", component="roofline", program=program,
              **lbl).set(frac)
    from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder  # lazy

    get_flight_recorder().record("roofline", program=program, steps=steps, gbps=round(gbps, 3),
                                 fraction=round(frac, 4), replica=lbl.get("replica"))
    return {"step_bytes": step_bytes, "gbps": gbps, "achievable_gbps": achievable,
            "fraction": frac}
