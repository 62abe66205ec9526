"""Configuration (counterpart of ``fairness_llm_tpu/config.py``):
``ModelSettings``, ``SpeculationConfig``, ``IntegrityConfig`` and
``ResilienceConfig`` (fault containment), ``Config`` with the fields the
three phases read, ``ServingConfig`` (the continuous-batching core's
knobs), ``OverloadConfig`` (QoS queues and load shedding),
``TelemetryConfig`` (the fairness monitor, SLO targets, the trace copy),
``FleetConfig``, ``AutoscaleConfig`` and ``RolloutConfig`` (the replica
fleet, its autoscaler and the rolling upgrade), ``MeshConfig`` (the
``("dp", "tp", "sp")`` layout of the ranks), ``default_config`` with the
reference's ``FAIRNESS_TPU_*`` overrides, and ``create_directories``."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    """Per-model decode settings."""

    temperature: float = 0.7
    max_tokens: int = 500
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Prompt-lookup speculative decoding (``runtime/speculative.py``): each
    step drafts ``draft_len`` tokens by matching the last ``ngram_max``
    tokens against the row's prompt and output, then verifies all of them
    in one forward. Greedy only: with temperature > 0 the engine takes the
    plain sampled path."""

    enabled: bool = False
    ngram_max: int = 3  # longest suffix n-gram tried first (falls back to 1)
    draft_len: int = 8  # drafted tokens verified per step (k; step width k+1)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching server knobs (``serving/``): a fixed pool of
    ``num_slots`` KV slots, a row evicted the step it finishes, the freed
    slot backfilled from a bounded admission queue. Greedy decode through
    the server gives ``DecodeEngine.generate``'s tokens for prompts within
    ``max_prompt_len``; longer prompts are left-truncated to it, with a
    warning.

    ``paged_kv`` (CLI ``--paged-kv``) gives the slots block tables into one
    shared arena of ``kv_blocks`` blocks of ``kv_block_size`` tokens
    (``serving/paged.py``): admission reuses cached prompt prefixes and
    prefills only the unmatched suffix; greedy tokens stay those of the
    non-paged path. ``tp`` above 1 is the tensor-parallel width the served
    pool runs at: it must equal the tp axis of the engine's mesh, or the
    scheduler raises ``ValueError``."""

    enabled: bool = False
    num_slots: int = 8  # concurrent KV slots = decode-step batch rows
    queue_capacity: int = 128  # bounded admission queue (backpressure past this)
    max_prompt_len: int = 512  # per-request prompt budget (left-truncated over)
    max_new_tokens: int = 256  # hard per-request decode cap (requests clamp to it)
    prefill_group: int = 8  # max admissions prefilled in one forward
    # Decode steps per scheduler call: eviction and backfill happen at the
    # end of decode_chunk x fuse_steps steps (or sooner, once every live row
    # is done). The tokens are the same at any setting.
    decode_chunk: int = 8
    fuse_steps: int = 1
    # Admission rate limit (RateLimiter.try_acquire at submit); None = none.
    admission_per_minute: Optional[int] = None
    paged_kv: bool = False
    kv_block_size: int = 16  # tokens per KV block (the sharing granularity)
    # Total arena blocks; None = 2x the all-slots-private worst case, so a
    # full pool still leaves an equal reserve working as prefix cache.
    kv_blocks: Optional[int] = None
    # Tensor-parallel serving: the engine's tp mesh must match (the
    # scheduler checks); 1 = a single device.
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Overload-control knobs (``serving/overload.py``).

    ``enabled`` turns the serving front door from one FIFO into the QoS
    model: per-class bounded sub-queues (``interactive``, ``batch``,
    ``probe``) with strict-priority-with-aging dequeue, per-class rate
    quotas, deadline-feasibility admission (a request that provably cannot
    meet its deadline is refused with a retry-after hint instead of
    spending a prefill), and a shed controller that walks a brownout ladder
    under sustained overload:

        0 healthy -> 1 shed batch admissions -> 2 also cap batch
        max_new_tokens -> 3 interactive-only

    Escalation reads the fast-window SLO burn rates and the admission
    queue's depth; each step down needs ``healthy_window_s`` of sustained
    health. With ``enabled=False`` (the default) serving is unchanged.
    """

    enabled: bool = False
    # Per-class sub-queue bounds (each inside ServingConfig.queue_capacity).
    interactive_capacity: int = 64
    batch_capacity: int = 64
    probe_capacity: int = 8
    # Per-class admission quotas; None = none (the shared quota still applies).
    interactive_per_minute: Optional[int] = None
    batch_per_minute: Optional[int] = None
    probe_per_minute: Optional[int] = None
    # A lower-class head waiting this long competes on age (oldest first);
    # <= 0 is pure strict priority.
    aging_s: float = 5.0
    # Refuse when the remaining deadline is below feasibility_safety x the
    # estimated earliest first token; 0 disables the check.
    deadline_admission: bool = True
    feasibility_safety: float = 0.5
    # Shed-controller signals: the queue depth reached queue_frac_threshold
    # of capacity within queue_window_s, or (only while interactive traffic
    # was seen within interactive_presence_s) a fast-window burn rate at or
    # over burn_threshold.
    burn_threshold: float = 2.0
    interactive_presence_s: float = 60.0
    queue_frac_threshold: float = 0.9
    queue_window_s: float = 2.0  # depth-sample memory (a self-decaying maximum)
    healthy_window_s: float = 5.0  # sustained health per step down
    eval_interval_s: float = 0.25  # least seconds between controller steps
    # Rung 2: batch requests' max_new_tokens clamp.
    batch_token_cap: int = 32
    retry_after_s: float = 1.0  # base retry-after hint of a class shed
    # Opt-in (> 0): the rung-2 batch clamp also engages before rung 2 while
    # the memory ledger's device headroom fraction is at or under this
    # (telemetry/memory.py); 0 keeps the ladder purely load-driven.
    headroom_cap_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Replica-fleet knobs (``serving/fleet.py``).

    ``replicas`` > 1 puts a ``ReplicaSet`` behind the serving backend: N
    replicas, each with its own KV slot pool, scheduler, breakers, watchdog
    and rejoin canary, fed from one bounded admission queue by a
    health-aware router (``serving/router.py``). A replica whose ladder
    climbs to ``fence_ladder_level``, whose open breakers reach
    ``fence_open_breakers``, whose stall probe fires, or that takes an
    injected replica_crash/replica_hang is FENCED: drained with zero grace,
    its unfinished requests re-routed with their original ids, settings and
    row seeds, and let back in only after a canary probe passes, no sooner
    than ``fence_cooldown_s`` (and not before its open breakers can
    half-open).
    """

    replicas: int = 1  # 1 = single engine, no fleet layer
    # Ladder level at which the router fences a replica (2 =
    # reduced_footprint); 0 disables ladder-driven fencing.
    fence_ladder_level: int = 2
    # Open stage breakers that fence regardless of the ladder.
    fence_open_breakers: int = 2
    fence_cooldown_s: float = 1.0  # fenced -> first rejoin-probe delay


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Elastic-fleet knobs (``serving/autoscaler.py``).

    ``enabled`` puts an ``Autoscaler`` on the ``ReplicaSet``'s tick. It
    reads the replicas' fast-window SLO burn, the fleet's overload rung and
    the fleet-held queue depth: a hot signal held for ``up_window_s`` adds a
    canary-gated standby replica; every signal cold for ``down_window_s``
    retires the lowest-load replica through the zero-grace drain and
    migration path. At most one change per ``cooldown_s``; membership stays
    in [``min_replicas``, ``max_replicas``].

    ``up_headroom_frac`` > 0 makes device-memory headroom a hot signal:
    the memory ledger's headroom fraction (``telemetry/memory.py``) at or
    under it; with no known limit the signal has no opinion.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    # Scale-up signals: the hottest replica's fast-window burn at or over
    # up_burn_threshold, the fleet-held queue at or over up_queue_frac of
    # capacity, or the ladder at or past up_overload_level (0 disables it).
    up_burn_threshold: float = 2.0
    up_queue_frac: float = 0.8
    up_overload_level: int = 1
    up_headroom_frac: float = 0.0
    up_window_s: float = 1.0  # sustained hot before a scale-up
    # Scale-down: burn, queue and per-replica slot load all under these,
    # sustained for down_window_s.
    down_burn_threshold: float = 0.5
    down_queue_frac: float = 0.1
    down_load_frac: float = 0.5
    down_window_s: float = 5.0
    cooldown_s: float = 2.0  # least seconds between membership changes
    eval_interval_s: float = 0.25  # least seconds between controller steps


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rolling-upgrade knobs (``serving/rollout.py``).

    A ``RolloutController`` walks a ``ReplicaSet`` to a new version a wave
    at a time: a canary-gated standby at the new version, the traffic share
    moved onto it in ``traffic_steps`` steps each watched for
    ``canary_window_s``, then one old replica retired. Requests keep the
    version that admitted them. A gate firing on a new-version replica
    (canary mismatch, fence, open breaker, fast-window burn at or over
    ``gate_burn_threshold``, with ``abort_on_fairness_alert`` a fairness
    alert or a divergent pair served there) or a manifest refusal of the new
    weights rolls the fleet back.
    """

    enabled: bool = False
    canary_window_s: float = 1.0  # gate-watch seconds per traffic step
    traffic_steps: int = 2  # traffic increments per wave
    gate_burn_threshold: float = 2.0
    abort_on_fairness_alert: bool = True


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry knobs: the fairness monitor, the SLO objectives the burn
    rates judge against, and the timeline's trace copy.

    ``trace_out`` writes the timeline as Chrome-trace JSON at the end of a
    run; with a telemetry dir, ``<dir>/trace.json`` is written anyway and
    this adds a copy at ``trace_out``. ``fairness_obs`` arms the fairness
    monitor (``telemetry/fairness.py``): the phases register their profile
    grid and counterfactual pairs, sweep requests carry study tags, and the
    streaming DP/IF/exposure gauges, the pair watch and the
    serving-neutrality audit record live. ``achievable_gbps`` is the
    roofline's reference bandwidth (``telemetry/roofline.py``): a measured
    figure in place of the card's data-sheet one.
    """

    trace_out: Optional[str] = None
    fairness_obs: bool = False
    slo_ttft_p95_s: float = 2.0
    slo_e2e_p99_s: float = 30.0
    slo_error_rate: float = 0.01
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    achievable_gbps: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Watchdog, circuit-breaker and graceful-drain knobs (``resilience/``).

    ``enabled`` arms the step watchdog and the per-stage breakers in the
    serving scheduler (and the engine's speculate breaker). In a fault-free
    run they change nothing but a few host-side timestamps: the watchdog
    only classifies steps slower than ``max_step_seconds``, and a breaker
    only acts after ``breaker_threshold`` consecutive faults.

    ``journal_dir`` turns on the crash-safe serving journal: accepted
    requests are ledgered to ``<dir>/journal.jsonl``, and a drained or
    preempted run's unfinished work is re-served by ``resume-serving
    <dir>``.
    """

    enabled: bool = False
    # Watchdog: a step slower than this is classified hung and raised as a
    # containable HangFault. 0 disables classification (the step_wall_s
    # histogram still records, so that a threshold can be chosen from data).
    max_step_seconds: float = 0.0
    breaker_threshold: int = 3  # consecutive faults per stage -> open
    breaker_cooldown_s: float = 5.0  # open -> half-open probe delay
    # Drain: how long live slots may keep decoding after SIGTERM/SIGINT
    # before being journaled as unfinished.
    drain_grace_s: float = 5.0
    journal_dir: Optional[str] = None
    journal_rotate_every: int = 256  # terminal records between compactions


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """Silent-corruption detection knobs (``integrity/``).

    ``numerics_guards`` has every prefill and decode chunk read its logits'
    finite flag (one AND-reduced flag a chunk, read with the chunk's tokens;
    no sync or kernel per step); a tripped flag is contained as a
    ``NumericsFault``. The tokens are the same either way.

    ``verify_manifests`` (default on) checks the sha256 ``manifest.json``
    beside a weight checkpoint at load, where there is one; a corrupt file
    is refused with an error naming it.

    ``canary_every_n`` > 0 arms the serving canary: every N backend
    ``generate`` calls a golden prompt decodes through the live scheduler
    and is compared token for token against a reference recorded in a pool
    of the live pool's shape (``integrity/canary.py``); a mismatch trips the
    decode breaker.
    """

    numerics_guards: bool = False
    verify_manifests: bool = True
    canary_every_n: int = 0  # 0 = canary off
    canary_max_tokens: int = 16


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The layout of the ranks, in the reference's axis order:

    - ``dp``: data parallel, the profile sweep split by rows over ranks;
    - ``tp``: tensor parallel, heads and the MLP's hidden width split;
    - ``sp``: sequence parallel, ring attention over the sequence.

    The port runs one process a rank (``torchrun``); ``parallel/`` builds
    the ``torch.distributed`` device mesh from this."""

    dp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "tp", "sp")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.tp, self.sp)

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.sp


@dataclasses.dataclass(frozen=True)
class Config:
    """The study's configuration: the reference's fields that the three
    phases read."""

    random_seed: int = 42
    results_dir: str = "results"
    data_dir: str = "data/ml-1m"
    # The counterfactual attribute grid; occupation is held constant.
    genders: Tuple[str, ...] = ("male", "female", "non-binary")
    age_groups: Tuple[str, ...] = ("18-24", "25-34", "35-44", "45-54", "55+")
    occupation: str = "professional"
    profiles_per_combo: int = 3
    conformal_alpha: float = 0.1  # phase 3's conformal miscoverage
    bias_reduction_target: float = 50.0  # percent
    accuracy_preservation_min: float = 70.0  # percent
    # 'simulated' is the deterministic fake backend; a real model name needs
    # weights_dir (or allow_random in backend_for). Phase 2 compares a list.
    default_model_phase1: str = "simulated"
    default_models_phase2: Tuple[str, ...] = ("simulated",)
    default_model_phase3: str = "simulated"
    model_settings: Tuple[Tuple[str, ModelSettings], ...] = (
        ("tiny-test", ModelSettings(temperature=0.7, max_tokens=128)),
        ("tiny-gpt2", ModelSettings(temperature=0.7, max_tokens=128)),
        ("tiny-llama-study", ModelSettings(temperature=0.7, max_tokens=64)),
        ("tiny-gpt2-study", ModelSettings(temperature=0.7, max_tokens=64)),
        ("gpt2-small", ModelSettings(temperature=0.7, max_tokens=256)),
        ("llama32-1b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("llama32-3b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("llama3-8b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("llama3-70b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("mistral-7b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("gemma-7b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("qwen2-0.5b", ModelSettings(temperature=0.7, max_tokens=500)),
        ("qwen2-7b", ModelSettings(temperature=0.7, max_tokens=500)),
    )
    decode_batch_size: int = 16
    max_prompt_len: int = 512
    # Global cap on decode length: settings_for() clamps each model's
    # max_tokens to it.
    max_new_tokens: int = 512
    weights_dir: Optional[str] = None  # directory of HF safetensors checkpoints
    # None keeps each model config's own weight_quant; "none"/"int8"
    # override it either way.
    weight_quant: Optional[str] = None
    checkpoint_every: int = 20  # profiles between sweep checkpoints
    # The ranks' mesh (--mesh dp=N, under torchrun).
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # One torch.profiler capture per phase under this directory (--trace-dir).
    profile_trace_dir: Optional[str] = None
    # Telemetry exports (--telemetry-dir, or FAIRNESS_TPU_TELEMETRY_DIR):
    # events.jsonl streamed, the snapshot and trace.json at the end.
    telemetry_dir: Optional[str] = None
    # Prompt-lookup speculation for greedy sweeps (sampled settings take the
    # plain path).
    speculation: SpeculationConfig = dataclasses.field(default_factory=SpeculationConfig)
    integrity: IntegrityConfig = dataclasses.field(default_factory=IntegrityConfig)
    # Watchdog, breakers, drain and the serving journal (resilience/).
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    # Continuous-batching serving (--continuous): backend_for returns a
    # ServingBackend when enabled.
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    # Overload control at the serving front door (--overload, with
    # --continuous).
    overload: OverloadConfig = dataclasses.field(default_factory=OverloadConfig)
    # The fairness monitor, SLO targets and the trace copy (--fairness-obs,
    # --slo-*, --trace-out).
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    # The replica fleet (--replicas N, with --continuous), its autoscaler
    # (--autoscale) and the rolling upgrade (the rollout subcommand).
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    autoscale: AutoscaleConfig = dataclasses.field(default_factory=AutoscaleConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)

    def settings_for(self, model_name: str) -> ModelSettings:
        for name, settings in self.model_settings:
            if name == model_name:
                if settings.max_tokens > self.max_new_tokens:
                    settings = dataclasses.replace(settings, max_tokens=self.max_new_tokens)
                return settings
        raise KeyError(
            f"no decode settings for model '{model_name}'; "
            f"known: {sorted(n for n, _ in self.model_settings)}"
        )


def default_config() -> Config:
    """A ``Config`` with the environment's overrides:
    ``FAIRNESS_TPU_RESULTS_DIR``, ``FAIRNESS_TPU_DATA_DIR``,
    ``FAIRNESS_TPU_SEED`` and ``FAIRNESS_TPU_TELEMETRY_DIR``."""
    kwargs = {}
    if os.environ.get("FAIRNESS_TPU_RESULTS_DIR"):
        kwargs["results_dir"] = os.environ["FAIRNESS_TPU_RESULTS_DIR"]
    if os.environ.get("FAIRNESS_TPU_DATA_DIR"):
        kwargs["data_dir"] = os.environ["FAIRNESS_TPU_DATA_DIR"]
    if os.environ.get("FAIRNESS_TPU_SEED"):
        kwargs["random_seed"] = int(os.environ["FAIRNESS_TPU_SEED"])
    if os.environ.get("FAIRNESS_TPU_TELEMETRY_DIR"):
        kwargs["telemetry_dir"] = os.environ["FAIRNESS_TPU_TELEMETRY_DIR"]
    return Config(**kwargs)


def create_directories(config: Config) -> None:
    """Make the results directory and its per-phase subdirectories."""
    for sub in ("", "phase1", "phase2", "phase3"):
        os.makedirs(os.path.join(config.results_dir, sub), exist_ok=True)
