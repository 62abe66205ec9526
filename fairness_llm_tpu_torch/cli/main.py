"""Command line for the port: ``python -m fairness_llm_tpu_torch.cli.main``
(counterpart of ``fairness_llm_tpu/cli/main.py``): the three-phase study,
``--all`` or one ``--phase``.

    python -m fairness_llm_tpu_torch.cli.main --all --quick \\
        --model tiny-llama-study --weights-dir checkpoints [--device cpu]

The flags keep the reference's meaning and checks. ``--device`` (default
``cuda``) is the port's counterpart of the reference's ``JAX_PLATFORMS``.
Phase 1 also writes its text report; the reference's matplotlib figures
are not ported (the CLI logs so). ``--continuous`` serves engine backends
through the continuous-batching scheduler (``--slots``, ``--fuse-steps``,
and ``--paged-kv`` with ``--kv-block-size``/``--kv-blocks`` for the paged
KV cache with prefix reuse). ``--telemetry-dir`` streams ``events.jsonl``
there and writes the registry snapshot (``telemetry_snapshot.json``,
``metrics.prom``) and the timeline (``trace.json``) at the end. The flags
of the serving slices still to come (``--tp``, ``--overload``,
``--replicas``, ``--autoscale``, ``--serving-journal``), device meshes and
resilience raise ``NotImplementedError`` (ROADMAP A5).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Dict

from fairness_llm_tpu_torch.config import (
    Config,
    ServingConfig,
    SpeculationConfig,
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
    p.add_argument("--telemetry-dir", default=None,
                   help="export telemetry here: streamed events.jsonl, and at the end of "
                        "the run the registry snapshot (telemetry_snapshot.json, "
                        "metrics.prom) and the host-clock timeline (trace.json, open at "
                        "https://ui.perfetto.dev)")
    # Not ported yet: refused, never ignored.
    for flag, kw in (("--tp", dict(type=int)),
                     ("--overload", dict(action="store_true")),
                     ("--replicas", dict(type=int)), ("--autoscale", dict(action="store_true")),
                     ("--serving-journal", dict(default=None)), ("--mesh", dict(default=None)),
                     ("--max-step-seconds", dict(type=float))):
        p.add_argument(flag, help="not ported yet (ROADMAP A5)", **kw)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


NOT_PORTED = ("--tp", "--overload", "--replicas", "--autoscale", "--serving-journal",
              "--mesh", "--max-step-seconds")


def config_from_args(args: argparse.Namespace) -> Config:
    for flag in NOT_PORTED:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{flag}: tensor-parallel serving, overload control, the replica fleet, "
                "the serving journal, device meshes and resilience are not ported yet "
                "(ROADMAP A5)")
    config = default_config()
    updates: Dict = {}
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
            or args.fuse_steps is not None:
        if not args.paged_kv and (args.kv_block_size is not None
                                  or args.kv_blocks is not None):
            raise SystemExit("--kv-block-size/--kv-blocks require --paged-kv")
        if not args.continuous:
            raise SystemExit("--slots/--paged-kv/--fuse-steps require --continuous")
        serve_kwargs = {"enabled": True}
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
    if args.no_verify_manifests:
        updates["integrity"] = dataclasses.replace(config.integrity, verify_manifests=False)
    if updates:
        config = dataclasses.replace(config, **updates)
    return config


def main(argv=None) -> int:
    from fairness_llm_tpu_torch.pipeline.phase1 import print_phase1_summary, run_phase1
    from fairness_llm_tpu_torch.pipeline.phase2 import print_phase2_summary, run_phase2
    from fairness_llm_tpu_torch.pipeline.phase3 import print_phase3_summary, run_phase3
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.reports.report import generate_summary_report
    from fairness_llm_tpu_torch.utils.profiling import phase_timer

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    config = config_from_args(args)
    create_directories(config)
    if not os.path.exists(os.path.join(config.data_dir, "movies.dat")):
        print(f"WARNING: MovieLens not found at {config.data_dir}; "
              "synthetic fallback will be used")
    if args.quick:
        args.num_items = min(args.num_items, 10)
        args.num_comparisons = min(args.num_comparisons, 6)
    save = not args.no_save
    telemetry_sink = T.configure(args.telemetry_dir) if args.telemetry_dir else None

    phases = [1, 2, 3] if args.all else [args.phase]
    timings: Dict[str, float] = {}
    p1 = None
    try:
        for phase in phases:
            with phase_timer(f"phase {phase}", timings):
                if phase == 1:
                    p1 = run_phase1(config, args.model, args.profiles, save=save,
                                    resume=args.resume, device=args.device)
                    print_phase1_summary(p1)
                    if save:
                        generate_summary_report(
                            p1, f"{config.results_dir}/phase1/phase1_summary_report.txt")
                elif phase == 2:
                    p2 = run_phase2(config,
                                    args.models or ([args.model] if args.model else None),
                                    args.num_items, args.num_comparisons, save=save,
                                    corpus=args.corpus, num_queries=args.num_queries,
                                    device=args.device)
                    print_phase2_summary(p2)
                else:
                    p3 = run_phase3(config, phase1_results=p1, model_name=args.model,
                                    num_profiles=args.profiles, variant=args.variant,
                                    strategy=args.strategy, save=save,
                                    calibration=args.calibration,
                                    confidence_mapping=args.confidence_mapping,
                                    confidence_temperature=args.confidence_temperature,
                                    device=args.device)
                    print_phase3_summary(p3)
                if save:
                    logger.info("phase %d figures are not ported (the card's machine has "
                                "no matplotlib; ROADMAP A6)", phase)
    finally:
        if telemetry_sink is not None:
            T.install_event_sink(None)
            telemetry_sink.close()

    if args.telemetry_dir:
        # The end-of-run registry snapshot (JSON and Prometheus text), its
        # report, and the host-clock timeline beside it.
        path = T.write_snapshot(T.get_registry(), args.telemetry_dir)
        print("\n" + T.render_report(T.snapshot(T.get_registry())))
        print(f"\ntelemetry snapshot: {path}")
        trace = T.get_timeline().export(os.path.join(args.telemetry_dir, T.TRACE_FILENAME))
        print(f"device-step timeline: {trace} (open at https://ui.perfetto.dev)")

    print("\n" + "=" * 60)
    print("RUN COMPLETE")
    for name, dt in timings.items():
        print(f"  {name}: {dt:.1f}s")
    print(f"results under: {config.results_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
