"""Command line for the port: ``python -m fairness_llm_tpu_torch.cli.main``
(counterpart of ``fairness_llm_tpu/cli/main.py``): the three-phase study,
``--all`` or one ``--phase``.

    python -m fairness_llm_tpu_torch.cli.main --all --quick \\
        --model tiny-llama-study --weights-dir checkpoints [--device cpu]

The flags keep the reference's meaning and checks. ``--device`` (default
``cuda``) is the port's counterpart of the reference's ``JAX_PLATFORMS``.
Phase 1 also writes its text report; each phase writes its figures under
``<results-dir>/visualizations`` where matplotlib is installed (the CLI
logs that they were skipped where it is not). ``--continuous`` serves engine backends
through the continuous-batching scheduler (``--slots``, ``--fuse-steps``,
and ``--paged-kv`` with ``--kv-block-size``/``--kv-blocks`` for the paged
KV cache with prefix reuse). ``--telemetry-dir`` streams ``events.jsonl``
there and writes the registry snapshot (``telemetry_snapshot.json``,
``metrics.prom``) and the timeline (``trace.json``) at the end.

Fault containment (``resilience/``, ``integrity/``), with the reference's
flags and checks: ``--max-step-seconds`` (the step watchdog),
``--breaker-threshold``/``--breaker-cooldown`` (the per-stage breakers),
``--serving-journal DIR``/``--drain-grace`` (the crash-safe journal and the
SIGTERM/SIGINT drain, with ``--continuous``), ``--numerics-guards``,
``--canary-every N`` (with ``--continuous``) and ``--incidents`` (postmortem
bundles under ``<telemetry-dir>/incidents``, with ``--telemetry-dir``).

Overload control (``serving/overload.py``, with ``--continuous``):
``--overload`` arms the QoS queues, deadline-feasibility admission and the
shed controller's brownout ladder, tuned by ``--shed-burn-threshold``,
``--shed-healthy-window`` and ``--batch-token-cap``. Telemetry:
``--fairness-obs`` arms the fairness monitor (``telemetry/fairness.py``),
``--slo-ttft-p95``/``--slo-e2e-p99``/``--slo-error-rate`` set the SLO
targets the burn rates judge against, and ``--trace-out PATH`` writes a copy
of the timeline there.

The replica fleet (``serving/fleet.py``, with ``--continuous``):
``--replicas N`` serves through N replicas behind the health router
(``--fence-level``, ``--fence-cooldown``), and ``--autoscale`` makes their
number a control loop (``--min-replicas``, ``--max-replicas``).

The device-facing telemetry (``telemetry/memory.py``, ``roofline.py``,
``costmodel.py``, ``compilestats.py``) records with every run;
``--achievable-gbps`` sets the roofline's reference bandwidth (default: the
card's data-sheet figure, ``roofline.CARDS``).

Subcommands: ``telemetry-report <dir>`` (``--validate``, ``--timeline``,
``--require-fleet``, ``--require-autoscale``, ``--require-rollout``,
``--require-costmodel``, ``--require-memory``), ``perf-report <dir>`` and
``memory-report <dir>`` (``--require-ledger``), ``slo-report <dir>``
(``--fail-on-burn``) and ``fairness-report <dir>`` (``--fail-on-alert``,
``--validate``) render a snapshot;
``incident-report <dir>`` renders bundles; ``resume-serving <journal-dir>
--model NAME`` re-serves a drained run's unfinished requests; ``rollout
--model NAME --weights-dir DIR --to-checkpoint DIR`` walks a fleet to a new
version under live traffic (exit 0 complete, 2 rolled back, 1 requests
lost).

Data parallelism: ``--mesh dp=N`` under ``torchrun`` (one process a
rank; ``parallel/multihost.initialize_distributed`` joins the group from
the launcher's environment) splits every decode and scoring call's rows
over the N ranks and reduces phase 1's metric counts over them; rank 0
alone writes the records, reports, figures and telemetry.

    torchrun --nproc-per-node 2 -m fairness_llm_tpu_torch.cli.main \
        --phase 1 --mesh dp=2 --model tiny-llama-study --weights-dir checkpoints

Tensor and sequence parallelism, under ``torchrun`` with as many ranks:
``--continuous --tp N`` serves over an N-rank tp mesh (each rank holds its
shard of the weights; the reference's checks, with the world size for
its device count), and ``--mesh tp=N`` runs the engine over one;
``--mesh sp=N`` splits the scoring forward's sequence over N ranks
(ring attention). Ranks that share a card join over gloo.

    torchrun --nproc-per-node 2 -m fairness_llm_tpu_torch.cli.main \
        --phase 1 --continuous --tp 2 --model tiny-llama-study --weights-dir checkpoints

``--trace-dir DIR`` captures each phase with ``torch.profiler`` (one
Chrome-trace JSON a phase and rank under DIR) and prints the captures'
top device ops at the end (the host ops where no card ran).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import logging
import os
import sys
from typing import Dict, Optional

from fairness_llm_tpu_torch.config import (
    AutoscaleConfig,
    Config,
    FleetConfig,
    IntegrityConfig,
    MeshConfig,
    OverloadConfig,
    ResilienceConfig,
    ServingConfig,
    SpeculationConfig,
    TelemetryConfig,
    create_directories,
    default_config,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fairness_llm_tpu_torch",
        description="Three-phase LLM recommendation-fairness study on the PyTorch/CUDA port",
    )
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--all", action="store_true", help="run phases 1 -> 2 -> 3")
    g.add_argument("--phase", type=int, choices=(1, 2, 3), help="run one phase")
    p.add_argument("--quick", action="store_true",
                   help="demo mode: 1 profile/combo, fewer items/comparisons")
    p.add_argument("--model", default=None, help="model for phases 1/3 (or 'simulated')")
    p.add_argument("--models", nargs="+", default=None, help="models for phase 2")
    p.add_argument("--profiles", type=int, default=None, help="profiles per demographic combo")
    p.add_argument("--num-items", type=int, default=20, help="phase-2 ranking corpus size")
    p.add_argument("--corpus", default="synthetic", choices=("synthetic", "movielens"),
                   help="phase-2 corpus: the reference study's synthetic documents, or "
                        "MovieLens titles with genre-derived groups")
    p.add_argument("--num-queries", type=int, default=1,
                   help="phase-2 listwise queries, decoded as one batch")
    p.add_argument("--num-comparisons", type=int, default=30, help="phase-2 pairwise budget")
    p.add_argument("--variant", default="conformal", choices=("conformal", "smart", "aggressive"),
                   help="phase-3 mitigation variant")
    p.add_argument("--strategy", default="demographic_parity",
                   choices=("demographic_parity", "equal_opportunity", "individual_fairness"))
    p.add_argument("--calibration", default="simulated",
                   choices=("simulated", "model", "model-conditional"),
                   help="phase-3 conformal confidences: the reference study's simulated "
                        "curve, the model's own unconditional title likelihoods, or "
                        "likelihoods given the profile's watch history")
    p.add_argument("--confidence-mapping", default="percentile",
                   choices=("percentile", "probability"),
                   help="with --calibration model or model-conditional: how likelihoods "
                        "map onto the conformal scale (pipeline.facter.model_confidences)")
    p.add_argument("--confidence-temperature", type=float, default=1.0,
                   help="temperature for --confidence-mapping probability")
    p.add_argument("--max-new-tokens", type=int, default=None,
                   help="global decode-length cap: clamps every model's max_tokens")
    p.add_argument("--speculate", action="store_true",
                   help="prompt-lookup speculative decoding for engine backends "
                        "(greedy decode only; sampled settings use the plain path)")
    p.add_argument("--draft-len", type=int, default=None,
                   help="with --speculate: drafted tokens verified per step")
    p.add_argument("--ngram-max", type=int, default=None,
                   help="with --speculate: longest lookup n-gram tried first")
    p.add_argument("--weights-dir", default=None, help="directory of HF safetensors checkpoints")
    p.add_argument("--weight-quant", default=None, choices=("none", "int8"),
                   help="weight-only quantization for served models: int8 stores the "
                        "projection kernels as int8 with f32 per-channel scales")
    p.add_argument("--data-dir", default=None, help="MovieLens-1M directory")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true", help="resume the sweep from checkpoints")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--no-verify-manifests", action="store_true",
                   help="skip sha256 manifest verification of weight checkpoints at load")
    p.add_argument("--device", default="cuda",
                   help="torch device for engine backends (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--continuous", action="store_true",
                   help="serve engine backends through the continuous-batching scheduler: "
                        "a fixed KV slot pool, eviction and backfill from a bounded "
                        "admission queue; greedy output equals the engine's for prompts "
                        "within the serving budget")
    p.add_argument("--slots", type=int, default=None,
                   help="with --continuous: concurrent KV slots (decode-step batch rows)")
    p.add_argument("--fuse-steps", type=int, default=None, metavar="K",
                   help="with --continuous: decode chunks run per scheduler call before "
                        "eviction and backfill (the tokens do not change); not with "
                        "--speculate")
    p.add_argument("--paged-kv", action="store_true",
                   help="with --continuous: paged KV cache with radix-tree prefix reuse: "
                        "slots hold block tables into one shared arena, admission matches "
                        "the longest cached prompt prefix (refcounted, copy-on-write at the "
                        "divergence) and prefills only the unmatched suffix; greedy output "
                        "equals the non-paged path's")
    p.add_argument("--kv-block-size", type=int, default=None, metavar="B",
                   help="with --paged-kv: tokens per KV block, the prefix-sharing "
                        "granularity (default 16)")
    p.add_argument("--kv-blocks", type=int, default=None, metavar="N",
                   help="with --paged-kv: total arena blocks (default 2x the all-slots-"
                        "private worst case, so a full pool still leaves an equal "
                        "prefix-cache reserve)")
    p.add_argument("--overload", action="store_true",
                   help="with --continuous: arm overload control: QoS classes (interactive/"
                        "batch/probe) with per-class bounded sub-queues and strict-priority-"
                        "with-aging dequeue, deadline-feasibility admission (a provably "
                        "doomed request sheds with finish_reason=shed and a retry-after "
                        "instead of spending a prefill), and a shed controller walking a "
                        "brownout ladder: shed batch -> cap batch tokens -> interactive-only")
    p.add_argument("--shed-burn-threshold", type=float, default=None, metavar="B",
                   help="with --overload: fast-window SLO burn rate at which the shed "
                        "controller escalates one rung (default 2.0)")
    p.add_argument("--shed-healthy-window", type=float, default=None, metavar="S",
                   help="with --overload: seconds of sustained health required per "
                        "de-escalation rung (default 5)")
    p.add_argument("--batch-token-cap", type=int, default=None, metavar="T",
                   help="with --overload: max_new_tokens clamp of batch-class requests at "
                        "brownout rung 2 and above (default 32)")
    p.add_argument("--telemetry-dir", default=None,
                   help="export telemetry here: streamed events.jsonl, and at the end of "
                        "the run the registry snapshot (telemetry_snapshot.json, "
                        "metrics.prom) and the host-clock timeline (trace.json, open at "
                        "https://ui.perfetto.dev); render with `telemetry-report <dir>`")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the host-clock timeline as Chrome-trace JSON at PATH too "
                        "(with --telemetry-dir, <telemetry-dir>/trace.json is written "
                        "anyway)")
    p.add_argument("--fairness-obs", action="store_true",
                   help="fairness observability: the phases register their profile grid "
                        "with the fairness monitor, sweep requests carry group/attribute/"
                        "pair_id tags, and the run records streaming per-group DP/IF/"
                        "exposure gauges, a counterfactual pair watch and a serving-"
                        "neutrality audit (fairness_alerts_total); render with "
                        "`fairness-report <telemetry-dir>`")
    p.add_argument("--slo-ttft-p95", type=float, default=None, metavar="S",
                   help="SLO target: p95 time to first token in seconds (default 2.0); "
                        "burn rates are slo_burn_rate gauges, rendered by `slo-report`")
    p.add_argument("--slo-e2e-p99", type=float, default=None, metavar="S",
                   help="SLO target: p99 end-to-end request latency in seconds (default 30)")
    p.add_argument("--slo-error-rate", type=float, default=None, metavar="F",
                   help="SLO target: allowed failed or expired fraction (default 0.01)")
    p.add_argument("--max-step-seconds", type=float, default=None,
                   help="resilience watchdog: a prefill/decode step slower than this is "
                        "classified hung and contained as a fault (requeue once / chunk "
                        "retry); implies the per-stage circuit breakers")
    p.add_argument("--breaker-threshold", type=int, default=None,
                   help="resilience: consecutive faults per stage before that stage's "
                        "circuit breaker opens (default 3); implies the breakers")
    p.add_argument("--breaker-cooldown", type=float, default=None,
                   help="resilience: seconds an open breaker waits before half-opening "
                        "for a probe (default 5)")
    p.add_argument("--serving-journal", default=None, metavar="DIR",
                   help="with --continuous: crash-safe request journal under DIR "
                        "(journal.jsonl) and a SIGTERM/SIGINT graceful drain; a drained "
                        "run's unfinished requests are re-served by `resume-serving DIR`")
    p.add_argument("--drain-grace", type=float, default=None,
                   help="with --serving-journal: seconds live slots may keep decoding "
                        "after a drain signal before being journaled as unfinished "
                        "(default 5)")
    p.add_argument("--numerics-guards", action="store_true",
                   help="integrity: read each prefill and decode chunk's finite flag of "
                        "its logits (one flag a chunk, no sync per step); NaN/Inf chunks "
                        "are contained as NumericsFault. The tokens are the same either "
                        "way")
    p.add_argument("--canary-every", type=int, default=None, metavar="N",
                   help="with --continuous: every N backend calls, decode a golden prompt "
                        "through the live scheduler and compare it token for token with a "
                        "reference recorded at the pool's shape; a mismatch trips the "
                        "breaker degradation ladder")
    p.add_argument("--incidents", action="store_true",
                   help="arm the incident engine: trigger conditions (breaker open, hang, "
                        "numerics fault, canary mismatch, error-budget burn, heartbeat "
                        "gap, a fatal device error) dump postmortem bundles under "
                        "<telemetry-dir>/incidents; render them with `incident-report "
                        "<dir>`. Requires --telemetry-dir")
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="with --continuous: serve through N replicas behind a health-aware "
                        "router (serving/fleet.py), each with its own KV slot pool, breakers, "
                        "watchdog and rejoin canary; a sick replica is fenced and drained, its "
                        "requests migrate to healthy replicas with their ids, settings and row "
                        "seeds (greedy rows unchanged), and it rejoins after a canary probe")
    p.add_argument("--fence-level", type=int, default=None,
                   help="with --replicas: degradation-ladder level at which the router fences "
                        "a replica (default 2; 0 disables ladder-driven fencing, crash, hang "
                        "and stall still fence)")
    p.add_argument("--fence-cooldown", type=float, default=None,
                   help="with --replicas: seconds a fenced replica waits before its first "
                        "rejoin probe (default 1; the probe also waits for its open breakers "
                        "to half-open)")
    p.add_argument("--autoscale", action="store_true",
                   help="with --continuous: replica membership as a control loop "
                        "(serving/autoscaler.py) over the fast-window SLO burn, the overload "
                        "rung and the queue depth: scale-up adds a canary-gated standby, "
                        "scale-down retires the lowest-load replica through the drain and "
                        "migration path; a fleet even at --replicas 1")
    p.add_argument("--min-replicas", type=int, default=None, metavar="N",
                   help="with --autoscale: lower membership bound (default 1)")
    p.add_argument("--max-replicas", type=int, default=None, metavar="N",
                   help="with --autoscale: upper membership bound (default 4)")
    p.add_argument("--tp", type=int, default=None, metavar="N",
                   help="with --continuous: tensor-parallel serving over an N-rank tp mesh "
                        "(torchrun --nproc-per-node N): each rank holds its shard of the "
                        "weights and its kv heads of the slot cache or block arena, with "
                        "explicit all-reduces over the tp group. N must divide the model's "
                        "q and kv heads and the world size; --tp 1 is no flag. Not with "
                        "--mesh")
    p.add_argument("--mesh", default=None,
                   help="rank mesh, e.g. 'dp=2', 'tp=2' or 'dp=2,sp=2', under torchrun with "
                        "that many ranks")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler capture per phase to this directory and "
                        "print its top device ops at the end")
    p.add_argument("--achievable-gbps", type=float, default=None,
                   help="measured achievable device-memory bandwidth (GB/s) for the live "
                        "achieved_over_achievable roofline gauges (default: the card's "
                        "data-sheet figure, 3,350 on an H100 80GB HBM3; a nominal 16 on the "
                        "CPU, indicative only)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


#: Flags the reference has and the port refuses: none.
NOT_PORTED = ()


def parse_mesh(spec: Optional[str]) -> MeshConfig:
    """'dp=2,tp=4' -> MeshConfig(dp=2, tp=4)."""
    if not spec:
        return MeshConfig()
    kwargs = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k.strip() not in ("dp", "tp", "sp"):
            raise SystemExit(f"unknown mesh axis '{k}' (use dp/tp/sp)")
        try:
            kwargs[k.strip()] = int(v)
        except ValueError:
            raise SystemExit(f"bad mesh spec '{part}' (use e.g. dp=2,tp=4)") from None
    return MeshConfig(**kwargs)


def check_setup(config: Config) -> None:
    """The reference's environment probes: the ranks against the mesh, the
    corpus."""
    from fairness_llm_tpu_torch.parallel.multihost import world_size

    world = world_size()
    print(f"ranks: {world}")
    need = config.mesh.num_devices
    if need > world:
        print(f"WARNING: mesh {config.mesh.shape} wants {need} ranks, found {world} "
              f"(launch with torchrun --nproc-per-node {need})")
    if not os.path.exists(os.path.join(config.data_dir, "movies.dat")):
        print(f"WARNING: MovieLens not found at {config.data_dir}; "
              "synthetic fallback will be used")


def config_from_args(args: argparse.Namespace) -> Config:
    config = default_config()
    updates: Dict = {}
    if args.mesh:
        updates["mesh"] = parse_mesh(args.mesh)
    if args.trace_dir:
        updates["profile_trace_dir"] = args.trace_dir
    if args.telemetry_dir:
        updates["telemetry_dir"] = args.telemetry_dir
    attribution_flags = (args.slo_ttft_p95, args.slo_e2e_p99, args.slo_error_rate,
                         args.achievable_gbps)
    if args.fairness_obs or args.trace_out or any(v is not None for v in attribution_flags):
        tel_kwargs: Dict = {}
        if args.fairness_obs:
            tel_kwargs["fairness_obs"] = True
        if args.trace_out:
            tel_kwargs["trace_out"] = args.trace_out
        if args.achievable_gbps is not None:
            if args.achievable_gbps <= 0:
                raise SystemExit("--achievable-gbps must be > 0")
            tel_kwargs["achievable_gbps"] = args.achievable_gbps
        for val, field, flag in ((args.slo_ttft_p95, "slo_ttft_p95_s", "--slo-ttft-p95"),
                                 (args.slo_e2e_p99, "slo_e2e_p99_s", "--slo-e2e-p99"),
                                 (args.slo_error_rate, "slo_error_rate", "--slo-error-rate")):
            if val is not None:
                if val <= 0:
                    raise SystemExit(f"{flag} must be > 0")
                tel_kwargs[field] = val
        updates["telemetry"] = TelemetryConfig(**tel_kwargs)
    if args.weights_dir:
        updates["weights_dir"] = args.weights_dir
    if args.weight_quant is not None:
        updates["weight_quant"] = args.weight_quant
    if args.data_dir:
        updates["data_dir"] = args.data_dir
    if args.results_dir:
        updates["results_dir"] = args.results_dir
    if args.seed is not None:
        updates["random_seed"] = args.seed
    if args.max_new_tokens is not None:
        if args.max_new_tokens < 1:
            raise SystemExit("--max-new-tokens must be >= 1")
        updates["max_new_tokens"] = args.max_new_tokens
    if args.quick:
        updates["profiles_per_combo"] = 1
    if args.speculate or args.draft_len is not None or args.ngram_max is not None:
        if not args.speculate:
            raise SystemExit("--draft-len/--ngram-max require --speculate")
        spec_kwargs = {"enabled": True}
        if args.draft_len is not None:
            if args.draft_len < 1:
                raise SystemExit("--draft-len must be >= 1")
            spec_kwargs["draft_len"] = args.draft_len
        if args.ngram_max is not None:
            if args.ngram_max < 1:
                raise SystemExit("--ngram-max must be >= 1")
            spec_kwargs["ngram_max"] = args.ngram_max
        updates["speculation"] = SpeculationConfig(**spec_kwargs)
    if args.continuous or args.slots is not None or args.paged_kv \
            or args.kv_block_size is not None or args.kv_blocks is not None \
            or args.fuse_steps is not None or args.tp is not None:
        if not args.paged_kv and (args.kv_block_size is not None
                                  or args.kv_blocks is not None):
            raise SystemExit("--kv-block-size/--kv-blocks require --paged-kv")
        if not args.continuous:
            raise SystemExit("--slots/--paged-kv/--fuse-steps/--tp require --continuous")
        serve_kwargs = {"enabled": True}
        if args.tp is not None:
            # The reference's parse-time checks, the world size standing
            # for its device count.
            if args.tp < 1:
                raise SystemExit("--tp must be >= 1")
            if args.mesh:
                raise SystemExit(
                    "--tp cannot combine with --mesh: --tp N builds the tp-only serving "
                    "mesh itself (use --mesh for the static-engine dp/sp paths)")
            if args.tp > 1:
                if args.model and args.model not in (
                        "simulated", "simulated-fair", "simulated-biased"):
                    from fairness_llm_tpu_torch.models.configs import get_model_config

                    try:
                        mc = get_model_config(args.model)
                    except KeyError:
                        mc = None
                    if mc is not None and (mc.num_heads % args.tp != 0
                                           or mc.num_kv_heads % args.tp != 0):
                        raise SystemExit(
                            f"--tp {args.tp} must divide {args.model}'s attention heads "
                            f"({mc.num_heads} q / {mc.num_kv_heads} kv)")
                from fairness_llm_tpu_torch.parallel.multihost import world_size

                if world_size() % args.tp != 0:
                    raise SystemExit(
                        f"--tp {args.tp} must divide the world size ({world_size()}); "
                        f"launch with torchrun --nproc-per-node {args.tp}")
                serve_kwargs["tp"] = args.tp
                updates["mesh"] = MeshConfig(tp=args.tp)
        if args.slots is not None:
            if args.slots < 1:
                raise SystemExit("--slots must be >= 1")
            serve_kwargs["num_slots"] = args.slots
        if args.fuse_steps is not None:
            if args.fuse_steps < 1:
                raise SystemExit("--fuse-steps must be >= 1")
            if args.fuse_steps > 1 and args.speculate:
                raise SystemExit(
                    "--fuse-steps cannot combine with --speculate: the speculative verify "
                    "window is already multi-token")
            serve_kwargs["fuse_steps"] = args.fuse_steps
        if args.paged_kv:
            serve_kwargs["paged_kv"] = True
            if args.kv_block_size is not None:
                if args.kv_block_size < 1:
                    raise SystemExit("--kv-block-size must be >= 1")
                serve_kwargs["kv_block_size"] = args.kv_block_size
            if args.kv_blocks is not None:
                if args.kv_blocks < 1:
                    raise SystemExit("--kv-blocks must be >= 1")
                serve_kwargs["kv_blocks"] = args.kv_blocks
        updates["serving"] = ServingConfig(**serve_kwargs)
    overload_flags = (args.shed_burn_threshold, args.shed_healthy_window, args.batch_token_cap)
    if args.overload or any(v is not None for v in overload_flags):
        if not args.overload:
            raise SystemExit("--shed-burn-threshold/--shed-healthy-window/--batch-token-cap "
                             "require --overload")
        if not args.continuous:
            raise SystemExit("--overload requires --continuous (overload control gates the "
                             "serving admission queue)")
        ov_kwargs: Dict = {"enabled": True}
        if args.shed_burn_threshold is not None:
            if args.shed_burn_threshold <= 0:
                raise SystemExit("--shed-burn-threshold must be > 0")
            ov_kwargs["burn_threshold"] = args.shed_burn_threshold
        if args.shed_healthy_window is not None:
            if args.shed_healthy_window < 0:
                raise SystemExit("--shed-healthy-window must be >= 0")
            ov_kwargs["healthy_window_s"] = args.shed_healthy_window
        if args.batch_token_cap is not None:
            if args.batch_token_cap < 1:
                raise SystemExit("--batch-token-cap must be >= 1")
            ov_kwargs["batch_token_cap"] = args.batch_token_cap
        updates["overload"] = OverloadConfig(**ov_kwargs)
    if any(v is not None for v in (args.replicas, args.fence_level, args.fence_cooldown)):
        if not args.continuous:
            raise SystemExit("--replicas/--fence-level/--fence-cooldown require --continuous "
                             "(the fleet routes over serving schedulers)")
        fleet_kwargs: Dict = {}
        if args.replicas is not None:
            if args.replicas < 1:
                raise SystemExit("--replicas must be >= 1")
            fleet_kwargs["replicas"] = args.replicas
        if args.fence_level is not None:
            if args.fence_level < 0:
                raise SystemExit("--fence-level must be >= 0")
            fleet_kwargs["fence_ladder_level"] = args.fence_level
        if args.fence_cooldown is not None:
            if args.fence_cooldown < 0:
                raise SystemExit("--fence-cooldown must be >= 0")
            fleet_kwargs["fence_cooldown_s"] = args.fence_cooldown
        updates["fleet"] = FleetConfig(**fleet_kwargs)
    if args.autoscale or args.min_replicas is not None or args.max_replicas is not None:
        if not args.autoscale:
            raise SystemExit("--min-replicas/--max-replicas require --autoscale")
        if not args.continuous:
            raise SystemExit("--autoscale requires --continuous (the autoscaler drives fleet "
                             "membership over serving schedulers)")
        as_kwargs: Dict = {"enabled": True}
        if args.min_replicas is not None:
            if args.min_replicas < 1:
                raise SystemExit("--min-replicas must be >= 1")
            as_kwargs["min_replicas"] = args.min_replicas
        if args.max_replicas is not None:
            if args.max_replicas < (args.min_replicas or 1):
                raise SystemExit("--max-replicas must be >= --min-replicas")
            as_kwargs["max_replicas"] = args.max_replicas
        elif args.min_replicas is not None and args.min_replicas > AutoscaleConfig.max_replicas:
            raise SystemExit(f"--min-replicas {args.min_replicas} exceeds the default "
                             f"--max-replicas ({AutoscaleConfig.max_replicas}); pass "
                             "--max-replicas explicitly")
        updates["autoscale"] = AutoscaleConfig(**as_kwargs)
    resilience_flags = (args.max_step_seconds, args.breaker_threshold, args.breaker_cooldown,
                        args.serving_journal, args.drain_grace)
    if any(v is not None for v in resilience_flags):
        if (args.serving_journal or args.drain_grace is not None) and not args.continuous:
            raise SystemExit("--serving-journal/--drain-grace require --continuous (the "
                             "journal ledgers serving requests)")
        res_kwargs: Dict = {"enabled": True}
        if args.max_step_seconds is not None:
            if args.max_step_seconds <= 0:
                raise SystemExit("--max-step-seconds must be > 0")
            res_kwargs["max_step_seconds"] = args.max_step_seconds
        if args.breaker_threshold is not None:
            if args.breaker_threshold < 1:
                raise SystemExit("--breaker-threshold must be >= 1")
            res_kwargs["breaker_threshold"] = args.breaker_threshold
        if args.breaker_cooldown is not None:
            if args.breaker_cooldown < 0:
                raise SystemExit("--breaker-cooldown must be >= 0")
            res_kwargs["breaker_cooldown_s"] = args.breaker_cooldown
        if args.serving_journal:
            res_kwargs["journal_dir"] = args.serving_journal
        if args.drain_grace is not None:
            if args.drain_grace < 0:
                raise SystemExit("--drain-grace must be >= 0")
            res_kwargs["drain_grace_s"] = args.drain_grace
        updates["resilience"] = ResilienceConfig(**res_kwargs)
    if args.numerics_guards or args.canary_every is not None or args.no_verify_manifests:
        integ_kwargs: Dict = {}
        if args.numerics_guards:
            integ_kwargs["numerics_guards"] = True
        if args.canary_every is not None:
            if not args.continuous:
                raise SystemExit("--canary-every requires --continuous (the canary probes "
                                 "the serving scheduler)")
            if args.canary_every < 1:
                raise SystemExit("--canary-every must be >= 1")
            integ_kwargs["canary_every_n"] = args.canary_every
        if args.no_verify_manifests:
            integ_kwargs["verify_manifests"] = False
        updates["integrity"] = IntegrityConfig(**integ_kwargs)
    if updates:
        config = dataclasses.replace(config, **updates)
    return config


def telemetry_report(argv) -> int:
    """``telemetry-report <dir | snapshot.json>``: render a telemetry
    snapshot in the terminal, with the fairness section when the run
    recorded fairness instruments and the rollout section when it drove a
    rollout. ``--validate`` first checks the snapshot's schema and
    percentiles and exits 1 on problems; ``--require-fleet``,
    ``--require-autoscale``, ``--require-rollout``, ``--require-costmodel``
    and ``--require-memory`` add the reference validator's failover,
    elastic-cycle, rollout, cost-ledger and memory gates (``check_fleet``,
    ``check_autoscale``, ``check_rollout``, ``check_costmodel``,
    ``check_memory``) and imply ``--validate``. The cost-ledger and memory
    sections ride along when the run recorded them; ``--timeline`` also
    summarizes the ``trace.json`` beside it."""
    import json

    from fairness_llm_tpu_torch.serving.autoscaler import check_autoscale
    from fairness_llm_tpu_torch.serving.fleet import check_fleet
    from fairness_llm_tpu_torch.serving.rollout import check_rollout, render_rollout_report

    from fairness_llm_tpu_torch.telemetry import (
        TRACE_FILENAME,
        check_costmodel,
        check_memory,
        has_cost_data,
        has_memory_data,
        load_snapshot,
        render_cost_report,
        render_fairness_report,
        render_memory_report,
        render_report,
        summarize_chrome_trace,
        validate_snapshot,
    )

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch telemetry-report",
                                 description="Render (and optionally validate) a telemetry "
                                             "snapshot")
    ap.add_argument("path", help="telemetry dir (uses telemetry_snapshot.json inside) or a "
                                 "snapshot file")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the snapshot; non-zero exit on problems")
    ap.add_argument("--timeline", action="store_true",
                    help="also summarize the trace.json timeline beside the snapshot: top "
                         "programs by wall, largest step gaps, request outcomes")
    ap.add_argument("--require-fleet", action="store_true",
                    help="with --validate: a replica was fenced, every migrated request "
                         "recovered, and every fleet ended whole")
    ap.add_argument("--require-autoscale", action="store_true",
                    help="with --validate: a scale-up and a scale-down, every accepted replay "
                         "request terminal, migrated equal to recovered, every fleet whole")
    ap.add_argument("--require-rollout", action="store_true",
                    help="with --validate: a rollout completed and one rolled back through a "
                         "named gate, every rollout terminal, migration balanced")
    ap.add_argument("--require-costmodel", action="store_true",
                    help="with --validate: every program in compiles_total published a "
                         "nonzero cost ledger, and the gap attribution has a wall and a floor")
    ap.add_argument("--require-memory", action="store_true",
                    help="with --validate: the params pool and a KV pool are accounted, the "
                         "ledger fits its limit, and every program published its memory")
    a = ap.parse_args(argv)
    a.validate = (a.validate or a.require_fleet or a.require_autoscale or a.require_rollout
                  or a.require_costmodel or a.require_memory)
    snap = load_snapshot(a.path)
    if a.validate:
        # Before rendering: the renderer assumes a well-formed snapshot.
        problems = validate_snapshot(snap)
        for wanted, check in ((a.require_fleet, check_fleet),
                              (a.require_autoscale, check_autoscale),
                              (a.require_rollout, check_rollout),
                              (a.require_costmodel, check_costmodel),
                              (a.require_memory, check_memory)):
            if wanted:
                problems = problems + check(snap)
        if problems:
            print("SNAPSHOT INVALID:")
            for p in problems:
                print(f"  - {p}")
            return 1
    print(render_report(snap))
    if has_cost_data(snap):
        print("\n" + render_cost_report(snap))
    if has_memory_data(snap):
        print("\n" + render_memory_report(snap))
    if any(row.get("labels", {}).get("component") == "fairness"
           for section in ("counters", "gauges") for row in snap.get(section, [])):
        print("\n" + render_fairness_report(snap))
    rollout_section = render_rollout_report(snap)
    if rollout_section:
        print("\n" + rollout_section)
    if a.timeline:
        trace_dir = a.path if os.path.isdir(a.path) else os.path.dirname(a.path)
        trace_path = os.path.join(trace_dir, TRACE_FILENAME)
        if os.path.exists(trace_path):
            with open(trace_path, encoding="utf-8") as f:
                print("\n" + summarize_chrome_trace(json.load(f)))
        else:
            print(f"\n(no {TRACE_FILENAME} beside the snapshot — run with --trace-out or "
                  "--telemetry-dir to produce one)")
    if a.validate:
        print("\nsnapshot schema: OK")
    return 0


def perf_report(argv) -> int:
    """``perf-report <dir | snapshot.json>``: the decode cost ledger and the
    per-program gap attribution a run recorded (``telemetry/costmodel.py``):
    each program's bytes and FLOPs per component, its floor, and ``measured
    wall + host gap = floor + dispatch + compile + unattributed + host
    gap`` with the top gap contributor. ``--require-ledger`` exits 1 when
    the snapshot holds no ledger."""
    from fairness_llm_tpu_torch.telemetry import has_cost_data, load_snapshot, render_cost_report

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch perf-report",
                                 description="Render the decode cost ledger / gap attribution "
                                             "from a telemetry snapshot")
    ap.add_argument("path", help="telemetry dir (uses telemetry_snapshot.json inside) or a "
                                 "snapshot file")
    ap.add_argument("--require-ledger", action="store_true",
                    help="exit non-zero when the snapshot has no cost-ledger data")
    a = ap.parse_args(argv)
    snap = load_snapshot(a.path)
    print(render_cost_report(snap))
    return 1 if a.require_ledger and not has_cost_data(snap) else 0


def memory_report(argv) -> int:
    """``memory-report <dir | snapshot.json>``: the device-memory ledger a
    run recorded (``telemetry/memory.py``): bytes by pool (params, KV slot
    pool or paged arena, prefix cache, carried logits, other), the
    reconciliation against the allocator (``measured`` on the card,
    ``indicative`` on the CPU), the headroom, and each program's memory.
    ``--require-ledger`` exits 1 when the snapshot holds no ledger."""
    from fairness_llm_tpu_torch.telemetry import (
        has_memory_data,
        load_snapshot,
        render_memory_report,
    )

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch memory-report",
                                 description="Render the device-memory ledger from a telemetry "
                                             "snapshot")
    ap.add_argument("path", help="telemetry dir (uses telemetry_snapshot.json inside) or a "
                                 "snapshot file")
    ap.add_argument("--require-ledger", action="store_true",
                    help="exit non-zero when the snapshot has no memory-ledger data")
    a = ap.parse_args(argv)
    snap = load_snapshot(a.path)
    print(render_memory_report(snap))
    return 1 if a.require_ledger and not has_memory_data(snap) else 0


def slo_report(argv) -> int:
    """``slo-report <dir | snapshot.json>``: the SLO burn rates a run
    recorded, per (objective, window), with alert counts. ``--fail-on-burn``
    exits 1 when a run-window burn rate exceeds 1.0."""
    from fairness_llm_tpu_torch.telemetry import load_snapshot, render_slo_report

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch slo-report",
                                 description="Render SLO burn rates from a telemetry snapshot")
    ap.add_argument("path", help="telemetry dir (uses telemetry_snapshot.json inside) or a "
                                 "snapshot file")
    ap.add_argument("--fail-on-burn", action="store_true",
                    help="exit non-zero when any run-window burn rate exceeds 1.0")
    a = ap.parse_args(argv)
    snap = load_snapshot(a.path)
    print(render_slo_report(snap))
    if a.fail_on_burn:
        burning = [g for g in snap.get("gauges", [])
                   if g.get("name") == "slo_burn_rate"
                   and g.get("labels", {}).get("window") == "run" and g.get("value", 0.0) > 1.0]
        if burning:
            print(f"\n{len(burning)} SLO(s) burning over the whole run")
            return 1
    return 0


def fairness_report(argv) -> int:
    """``fairness-report <dir | snapshot.json>``: the fairness signals a run
    recorded: streaming against offline DP/IF/exposure, the per-group
    neutrality audit, disparity gauges with alert counts, and the
    divergent-pair table (joined from ``events.jsonl`` in a telemetry dir).
    ``--fail-on-alert`` exits 1 on any alert or divergent pair;
    ``--validate`` exits 1 when ``check_fairness`` finds a problem (live
    within ``FAIRNESS_TOLERANCE`` of offline, pairs joined, a fault-free
    run silent)."""
    from fairness_llm_tpu_torch.telemetry import (
        check_fairness,
        load_snapshot,
        read_events,
        render_fairness_report,
    )

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch fairness-report",
                                 description="Render fairness observability from a telemetry "
                                             "snapshot")
    ap.add_argument("path", help="telemetry dir (uses telemetry_snapshot.json and events.jsonl "
                                 "inside) or a snapshot file")
    ap.add_argument("--fail-on-alert", action="store_true",
                    help="exit non-zero when any fairness_alerts_total is nonzero or any pair "
                         "diverged")
    ap.add_argument("--validate", action="store_true",
                    help="hold a fault-free study run's snapshot to the fairness check; "
                         "non-zero exit on problems")
    a = ap.parse_args(argv)
    snap = load_snapshot(a.path)
    events = None
    ev_dir = a.path if os.path.isdir(a.path) else os.path.dirname(a.path)
    ev_path = os.path.join(ev_dir, "events.jsonl")
    if os.path.exists(ev_path):
        events = read_events(ev_path)
    print(render_fairness_report(snap, events=events))
    rc = 0
    if a.fail_on_alert:
        alerts = sum(c["value"] for c in snap.get("counters", [])
                     if c.get("name") == "fairness_alerts_total")
        diverged = sum(c["value"] for c in snap.get("counters", [])
                       if c.get("name") == "fairness_pair_divergence_total")
        if alerts or diverged:
            print(f"\n{int(alerts)} fairness alert(s), {int(diverged)} divergent pair(s)")
            rc = 1
    if a.validate:
        problems = check_fairness(snap)
        print("\nfairness check: " + ("OK" if not problems else "FAILED"))
        for p in problems:
            print(f"  - {p}")
        rc = rc or int(bool(problems))
    return rc


def incident_report(argv) -> int:
    """``incident-report <bundle-dir | incidents-dir | telemetry-dir>``:
    render postmortem bundles (manifest, the causal chain derived from the
    decision trail, flight-recorder ring depths, the implicated decision
    tail); every bundle of an incidents or telemetry dir, or one bundle."""
    import json

    from fairness_llm_tpu_torch.telemetry import list_bundles, render_incident_report
    from fairness_llm_tpu_torch.telemetry.incidents import (
        INCIDENTS_DIRNAME,
        MANIFEST_FILENAME,
        _read_jsonl,
        causal_chain,
    )

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch incident-report",
                                 description="Render incident postmortem bundles")
    ap.add_argument("path", help="one bundle dir, an incidents/ dir, or a telemetry dir "
                                 "containing incidents/")
    ap.add_argument("--chain-only", action="store_true",
                    help="print only the one-line causal chain per bundle")
    a = ap.parse_args(argv)
    path = a.path.rstrip("/")
    if os.path.isfile(os.path.join(path, MANIFEST_FILENAME)):
        bundles = [path]
    else:
        inc_dir = path
        if os.path.isdir(os.path.join(path, INCIDENTS_DIRNAME)):
            inc_dir = os.path.join(path, INCIDENTS_DIRNAME)
        bundles = [m["path"] for m in list_bundles(inc_dir)]
        if not bundles:
            print(f"no incident bundles under {inc_dir}: a clean run, or the engine was "
                  "never armed (--incidents)")
            return 0
    for i, b in enumerate(bundles):
        if a.chain_only:
            with open(os.path.join(b, MANIFEST_FILENAME), encoding="utf-8") as f:
                manifest = json.load(f)
            trail = _read_jsonl(os.path.join(b, "decisions.jsonl"))
            implicated = _read_jsonl(os.path.join(b, "decisions_implicated.jsonl"))
            print(f"{os.path.basename(b)}: " + causal_chain(manifest, trail, implicated))
        else:
            if i:
                print()
            print(render_incident_report(b))
    return 0


def resume_serving_cmd(argv) -> int:
    """``resume-serving <journal-dir> --model NAME``: re-serve every request
    of a drained ``--continuous`` run's journal that has no terminal record,
    with its original id, sampler settings and row seed (greedy survivors
    decode the tokens an uninterrupted run would) and its deadline reduced
    by the wall time already spent. Exits 1 while requests stay unfinished
    (drained again)."""
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.resilience import GracefulDrain, ServingJournal, resume_serving

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch resume-serving",
                                 description="Re-serve a drained run's journaled unfinished "
                                             "requests")
    ap.add_argument("journal_dir", help="directory holding journal.jsonl (the "
                                        "--serving-journal DIR)")
    ap.add_argument("--model", required=True, help="engine model name (the drained run's)")
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--allow-random", action="store_true",
                    help="serve with random weights (smoke runs and drills only)")
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=None,
                    help="serving decode cap (default: the serving default, clamped to fit "
                         "the model's position budget)")
    ap.add_argument("--max-step-seconds", type=float, default=None)
    ap.add_argument("--breaker-threshold", type=int, default=None)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true")
    a = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    res_kwargs: Dict = {"enabled": True, "journal_dir": a.journal_dir}
    if a.max_step_seconds is not None:
        res_kwargs["max_step_seconds"] = a.max_step_seconds
    if a.breaker_threshold is not None:
        res_kwargs["breaker_threshold"] = a.breaker_threshold
    serve_kwargs: Dict = {"enabled": True}
    if a.slots is not None:
        serve_kwargs["num_slots"] = a.slots
    # A slot holds the prompt bucket and the decode cap, so the default cap
    # is clamped to the model's position budget; an explicit one is taken
    # as given and fails loudly if it cannot fit.
    model_seq = get_model_config(a.model).max_seq_len
    serve_kwargs["max_new_tokens"] = (a.max_new_tokens if a.max_new_tokens is not None
                                      else min(ServingConfig().max_new_tokens, model_seq // 2))
    config = dataclasses.replace(default_config(), weights_dir=a.weights_dir,
                                 serving=ServingConfig(**serve_kwargs),
                                 resilience=ResilienceConfig(**res_kwargs))
    sink = T.configure(a.telemetry_dir) if a.telemetry_dir else None
    # The backend's journal is the ledger resumed from, so completions
    # append terminal records and a second drain re-journals the tail.
    backend = backend_for(a.model, config, allow_random=a.allow_random, device=a.device)
    journal = backend.journal or ServingJournal(a.journal_dir)
    with GracefulDrain():
        results = resume_serving(backend.engine, journal, serving=backend.serving,
                                 resilience=config.resilience)
    outcomes: Dict[str, int] = {}
    for res in results.values():
        outcomes[res.finish_reason] = outcomes.get(res.finish_reason, 0) + 1
    print(f"resumed {len(results)} request(s): "
          + (", ".join(f"{k}={v}" for k, v in sorted(outcomes.items())) or "nothing to do"))
    still = journal.unfinished()
    if still:
        print(f"{len(still)} request(s) remain unfinished (drained again?): re-run "
              f"resume-serving {a.journal_dir}")
    if a.telemetry_dir:
        print(f"telemetry snapshot: {T.write_snapshot(T.get_registry(), a.telemetry_dir)}")
        T.install_event_sink(None)
        sink.close()
    return 1 if still else 0


def rollout_cmd(argv) -> int:
    """``rollout``: a zero-downtime rolling upgrade under live traffic.

    Builds a ``ReplicaSet`` on the current model and weights and walks it to
    a new version with a ``RolloutController`` while synthetic requests
    stream through it: a canary-gated standby a wave, the traffic moved in
    steps, each old replica retired, and a rollback on any gate (the
    manifest refusing ``--to-checkpoint``, a canary mismatch, SLO burn, a
    fairness alert or pair divergence on the new version, a fence or open
    breaker). Requests keep the version that first served them.

    Exit status: 0 = complete; 2 = rolled back (the gate and cause are
    printed, and with ``--telemetry-dir`` bundled under incidents/); 1 =
    requests lost.
    """
    import time

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import ModelSettings, RolloutConfig
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.pipeline.backends import engine_for
    from fairness_llm_tpu_torch.serving import ReplicaSet, Request, RolloutController
    from fairness_llm_tpu_torch.serving.replay import DEFAULT_PROMPTS
    from fairness_llm_tpu_torch.telemetry.incidents import INCIDENTS_DIRNAME

    ap = argparse.ArgumentParser(prog="fairness_llm_tpu_torch rollout",
                                 description="Drive a canary-gated rolling upgrade across a "
                                             "replica fleet under live traffic")
    ap.add_argument("--model", required=True, help="engine model name of the CURRENT version")
    ap.add_argument("--weights-dir", default=None,
                    help="HF safetensors checkpoint directory of the current version")
    ap.add_argument("--to-checkpoint", default=None, metavar="DIR",
                    help="HF safetensors checkpoint directory of the NEW version (verified "
                         "against its manifest while preparing; a refused checkpoint rolls "
                         "back before any replica joins)")
    ap.add_argument("--to-config", default=None, metavar="MODEL",
                    help="model config name of the new version (default: --model)")
    ap.add_argument("--to-version", default=None, metavar="ID",
                    help="immutable version id of the new fleet (default: the current one "
                         "bumped, v0 -> v1)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--canary-window", type=float, default=None, metavar="S",
                    help="gate-watch seconds per traffic step")
    ap.add_argument("--traffic-steps", type=int, default=None, metavar="N",
                    help="traffic-shift steps per wave")
    ap.add_argument("--abort-on-fairness-alert", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="roll back on a fairness alert or a counterfactual pair divergence "
                         "served on the new version (default: on)")
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic requests streamed during the rollout")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slo-ttft-p95", type=float, default=None, metavar="S",
                    help="TTFT p95 target behind the rollout's SLO burn gate (default: the "
                         "stack's)")
    ap.add_argument("--slo-e2e-p99", type=float, default=None, metavar="S")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--allow-random", action="store_true",
                    help="run with random weights (smoke runs and drills only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true")
    a = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if not a.weights_dir and not a.allow_random:
        raise SystemExit("rollout needs --weights-dir (or --allow-random for smoke runs)")
    sink = None
    if a.telemetry_dir:
        sink = T.configure(a.telemetry_dir)
        T.arm_incidents(os.path.join(a.telemetry_dir, INCIDENTS_DIRNAME))
    prev_targets = None
    if a.slo_ttft_p95 is not None or a.slo_e2e_p99 is not None:
        slo_kwargs = {}
        if a.slo_ttft_p95 is not None:
            slo_kwargs["ttft_p95_s"] = a.slo_ttft_p95
        if a.slo_e2e_p99 is not None:
            slo_kwargs["e2e_p99_s"] = a.slo_e2e_p99
        prev_targets = T.set_slo_targets(T.SLOTargets(**slo_kwargs))
    try:
        cfg = get_model_config(a.model)
        to_cfg = get_model_config(a.to_config) if a.to_config else cfg
        base = dataclasses.replace(default_config(), random_seed=a.seed)
        engine = engine_for(a.model, base, ckpt=a.weights_dir, device=a.device)

        def new_engine():
            # Built while PREPARING, so that a manifest refusal of
            # --to-checkpoint is a rollback gate, not a traceback.
            return engine_for(a.to_config or a.model, base, ckpt=a.to_checkpoint,
                              device=a.device)

        serving = ServingConfig(enabled=True, num_slots=2, queue_capacity=max(16, a.requests),
                                max_new_tokens=min(a.max_new_tokens, cfg.max_seq_len // 2,
                                                   to_cfg.max_seq_len // 2))
        fleet = ReplicaSet(engine, serving,
                           settings=ModelSettings(temperature=0.0,
                                                  max_tokens=serving.max_new_tokens),
                           fleet=FleetConfig(replicas=a.replicas),
                           resilience=ResilienceConfig(enabled=True),
                           integrity=IntegrityConfig())
        ro_kwargs: Dict = {}
        if a.canary_window is not None:
            ro_kwargs["canary_window_s"] = a.canary_window
        if a.traffic_steps is not None:
            ro_kwargs["traffic_steps"] = a.traffic_steps
        to_version = a.to_version or f"v{int(fleet.version.lstrip('v') or 0) + 1}"
        ro = RolloutController(fleet, to_version, engine_fn=new_engine,
                               config=RolloutConfig(
                                   enabled=True,
                                   abort_on_fairness_alert=a.abort_on_fairness_alert,
                                   **ro_kwargs))
        from_version = fleet.version
        ro.start()
        pending = [Request(prompt=DEFAULT_PROMPTS[i % len(DEFAULT_PROMPTS)], id=f"ro_{i}",
                           settings=fleet.settings) for i in range(a.requests)]
        results: Dict[str, object] = {}
        outstanding: list = []
        t0 = time.monotonic()
        while ro.active or pending or outstanding or fleet.has_work:
            if time.monotonic() - t0 > 600.0:
                print("rollout wall guard tripped (600 s) — aborting")
                break
            if pending and fleet.submit(pending[0]):
                outstanding.append(pending.pop(0).id)
            fleet.tick()
            for rid in list(outstanding):
                res = fleet.take_result(rid)
                if res is not None:
                    results[rid] = res
                    outstanding.remove(rid)
        pins: Dict[str, int] = {}
        for rid in results:
            ver = fleet.request_version(rid) or "?"
            pins[ver] = pins.get(ver, 0) + 1
        lost = a.requests - len(results)
        print(f"rollout {from_version} -> {to_version}: state={ro.state}"
              + (f" cause={ro.cause}" if ro.cause else ""))
        print(f"served {len(results)}/{a.requests} request(s), pinned "
              + (", ".join(f"{k}={v}" for k, v in sorted(pins.items())) or "none"))
        if a.telemetry_dir:
            print(f"telemetry snapshot: {T.write_snapshot(T.get_registry(), a.telemetry_dir)}")
    finally:
        if prev_targets is not None:
            T.set_slo_targets(prev_targets)
        if sink is not None:
            T.install_event_sink(None)
            sink.close()
    if lost:
        print(f"LOST {lost} request(s)")
        return 1
    return 0 if ro.state == "complete" else 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # Subcommands go ahead of the study parser (whose --all/--phase group is
    # required and would refuse them).
    if argv and argv[0] == "telemetry-report":
        return telemetry_report(argv[1:])
    if argv and argv[0] == "perf-report":
        return perf_report(argv[1:])
    if argv and argv[0] == "memory-report":
        return memory_report(argv[1:])
    if argv and argv[0] == "slo-report":
        return slo_report(argv[1:])
    if argv and argv[0] == "fairness-report":
        return fairness_report(argv[1:])
    if argv and argv[0] == "incident-report":
        return incident_report(argv[1:])
    if argv and argv[0] == "resume-serving":
        return resume_serving_cmd(argv[1:])
    if argv and argv[0] == "rollout":
        return rollout_cmd(argv[1:])
    from fairness_llm_tpu_torch.pipeline.phase1 import print_phase1_summary, run_phase1
    from fairness_llm_tpu_torch.pipeline.phase2 import print_phase2_summary, run_phase2
    from fairness_llm_tpu_torch.pipeline.phase3 import print_phase3_summary, run_phase3
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.reports.figures import (
        generate_phase1_figures,
        generate_phase2_figure,
        generate_phase3_figure,
    )
    from fairness_llm_tpu_torch.reports.report import generate_summary_report
    from fairness_llm_tpu_torch.resilience import GracefulDrain
    from fairness_llm_tpu_torch.parallel.multihost import initialize_distributed, is_primary
    from fairness_llm_tpu_torch.telemetry.incidents import INCIDENTS_DIRNAME
    from fairness_llm_tpu_torch.utils.profiling import maybe_trace, phase_timer, summarize_trace

    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    config = config_from_args(args)
    # A no-op in one process; under torchrun, this rank joins the group.
    initialize_distributed()
    create_directories(config)
    check_setup(config)
    if args.quick:
        args.num_items = min(args.num_items, 10)
        args.num_comparisons = min(args.num_comparisons, 6)
    # Under a process group, rank 0 alone writes files; the phases apply
    # the same rule to their records.
    primary = is_primary()
    save = not args.no_save and primary
    telemetry_dir = config.telemetry_dir if primary else None
    if args.incidents and not config.telemetry_dir:
        raise SystemExit("--incidents requires --telemetry-dir (bundles dump under "
                         "<telemetry-dir>/incidents)")
    telemetry_sink = None
    if telemetry_dir:
        # configure arms the per-program memory capture: for this run only.
        prev_capture = T.set_program_memory_capture(True)
        telemetry_sink = T.configure(telemetry_dir)
    if args.incidents and telemetry_dir:
        T.arm_incidents(os.path.join(telemetry_dir, INCIDENTS_DIRNAME))

    drain_handler = None
    if config.resilience.enabled and config.serving.enabled:
        # SIGTERM/SIGINT drain: the scheduler polls the handler's flag each
        # loop iteration, stops admission, finishes what it can within
        # --drain-grace and journals the rest (with --serving-journal) for
        # `resume-serving`. A second signal kills as usual.
        drain_handler = GracefulDrain().install()

    phases = [1, 2, 3] if args.all else [args.phase]
    timings: Dict[str, float] = {}
    p1 = None
    # The SLO targets before any scheduler exists, so that every evaluator
    # judges against them from its first request; the process's own come
    # back at the end.
    tc = config.telemetry
    prev_targets = T.set_slo_targets(T.SLOTargets(
        ttft_p95_s=tc.slo_ttft_p95_s, e2e_p99_s=tc.slo_e2e_p99_s, error_rate=tc.slo_error_rate,
        fast_window_s=tc.slo_fast_window_s, slow_window_s=tc.slo_slow_window_s))
    # The roofline's reference bandwidth, for this run only.
    if tc.achievable_gbps:
        T.set_achievable_gbps(tc.achievable_gbps)
    figures = save and importlib.util.find_spec("matplotlib") is not None
    try:
        for phase in phases:
            if drain_handler is not None and drain_handler.requested:
                # The drain already preempted that phase's serving work; the
                # remaining phases would only produce preempted results.
                print(f"\ndrain requested: skipping phase {phase} and beyond")
                break
            with phase_timer(f"phase {phase}", timings), \
                    maybe_trace(config.profile_trace_dir, f"phase{phase}"):
                if phase == 1:
                    p1 = run_phase1(config, args.model, args.profiles, save=save,
                                    resume=args.resume, device=args.device)
                    print_phase1_summary(p1)
                    if save:
                        generate_summary_report(
                            p1, f"{config.results_dir}/phase1/phase1_summary_report.txt")
                    if figures:
                        generate_phase1_figures(p1, f"{config.results_dir}/visualizations")
                elif phase == 2:
                    p2 = run_phase2(config,
                                    args.models or ([args.model] if args.model else None),
                                    args.num_items, args.num_comparisons, save=save,
                                    corpus=args.corpus, num_queries=args.num_queries,
                                    device=args.device)
                    print_phase2_summary(p2)
                    if figures:
                        generate_phase2_figure(p2, f"{config.results_dir}/visualizations")
                else:
                    p3 = run_phase3(config, phase1_results=p1, model_name=args.model,
                                    num_profiles=args.profiles, variant=args.variant,
                                    strategy=args.strategy, save=save,
                                    calibration=args.calibration,
                                    confidence_mapping=args.confidence_mapping,
                                    confidence_temperature=args.confidence_temperature,
                                    device=args.device)
                    print_phase3_summary(p3)
                    if figures:
                        generate_phase3_figure(p3, f"{config.results_dir}/visualizations")
                if save and not figures:
                    logger.info("phase %d figures skipped: matplotlib is not installed", phase)
    finally:
        T.set_slo_targets(prev_targets)
        if tc.achievable_gbps:
            T.set_achievable_gbps(None)
        if drain_handler is not None:
            drain_handler.uninstall()
        if telemetry_sink is not None:
            T.install_event_sink(None)
            telemetry_sink.close()
            T.set_program_memory_capture(prev_capture)
    if drain_handler is not None and drain_handler.requested:
        print("\nNOTE: the run was drained by a signal; unfinished serving requests (with "
              "--serving-journal) finish with: resume-serving <journal-dir> --model NAME")

    if config.profile_trace_dir:
        # The captures' top device ops (the host ops where no card ran).
        # Diagnostics: a summary that fails warns and the run goes on.
        try:
            summaries = summarize_trace(config.profile_trace_dir, top_k=8, device_filter="")
            cuda = [sm for sm in summaries if sm.device.endswith(": cuda")]
            for summary in cuda or summaries:
                print("\n" + summary.format())
        except (OSError, ValueError, KeyError) as e:
            logger.warning("trace summary unavailable: %s", e)

    if telemetry_dir:
        # The end-of-run registry snapshot (JSON and Prometheus text), its
        # report, and the host-clock timeline beside it.
        path = T.write_snapshot(T.get_registry(), telemetry_dir)
        print("\n" + T.render_report(T.snapshot(T.get_registry())))
        print(f"\ntelemetry snapshot: {path}")
    # The timeline: <telemetry-dir>/trace.json, and a copy at --trace-out.
    trace_paths = [os.path.join(telemetry_dir, T.TRACE_FILENAME)] if telemetry_dir else []
    if tc.trace_out and primary and tc.trace_out not in trace_paths:
        trace_paths.append(tc.trace_out)
    for path in trace_paths:
        trace = T.get_timeline().export(path)
        print(f"device-step timeline: {trace} (open at https://ui.perfetto.dev)")

    print("\n" + "=" * 60)
    print("RUN COMPLETE")
    for name, dt in timings.items():
        print(f"  {name}: {dt:.1f}s")
    print(f"results under: {config.results_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
