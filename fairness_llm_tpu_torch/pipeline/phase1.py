"""Phase 1: the bias-detection sweep (counterpart of
``fairness_llm_tpu/pipeline/phase1.py``).

MovieLens -> base preferences -> counterfactual profile grid -> batched
decode of every profile prompt (chunks of ``decode_batch_size``, one
``generate`` call each, a sweep-wide shared prefix) -> parse -> group ->
fairness metrics -> the JSON record.

Checkpoints are written every ``checkpoint_every`` profiles and read back
with ``resume=True``. Equal opportunity matches canonicalised titles, and
SNSR/SNSV compare each group against a neutral (demographics withheld)
decode.

``decode_sweep`` wraps ``generate`` in ``with_failure_containment``, as the
reference does: a failed chunk is retried once, then its rows become error
entries (``"error": "decode_failed"``, kept out of resume checkpoints, so
that ``--resume`` retries them). A fatal CUDA error is not contained: it
raises out of ``run_phase1`` and no record is written
(``utils/failures.is_fatal_device_error``). Phase 3 inherits both through
``decode_sweep``.

Telemetry, as the reference's: ``decode_sweep`` pulses a heartbeat and,
with the fairness monitor armed, streams each parsed result into it (the
content side of the pair watch and the per-group accumulators), refreshing
the derived gauges; ``run_phase1`` arms the monitor under
``config.telemetry.fairness_obs`` (``register_fairness_study``), publishes
the offline scores as ``fairness_offline_*`` gauges beside the streaming
ones, and records both in the record's ``fairness`` block (``live`` and
``offline``; None with the monitor off), and the phase's registry counters
(``phase_wall_s``, ``phase_runs_total``, ``profiles_decoded_total``,
``decode_failures_total``). The record's ``serving`` holds a
``ServingBackend``'s counters for the sweep (``--continuous``), None for
other backends.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from fairness_llm_tpu_torch.config import Config, default_config
from fairness_llm_tpu_torch.data.movielens import load_movielens
from fairness_llm_tpu_torch.data.profiles import (
    Profile,
    create_base_preferences,
    create_profile_grid,
    profile_pairs,
)
from fairness_llm_tpu_torch.metrics import fairness as M
from fairness_llm_tpu_torch.metrics.sharded import mesh_group_counts_fn
from fairness_llm_tpu_torch.parallel.multihost import is_primary
from fairness_llm_tpu_torch.parallel.sharding import axis_size
from fairness_llm_tpu_torch.pipeline import results as R
from fairness_llm_tpu_torch.pipeline.backends import DecodeBackend, backend_for, shared_prefix_ids
from fairness_llm_tpu_torch.pipeline.parsing import canonicalize, parse_numbered_list
from fairness_llm_tpu_torch.pipeline.prompts import check_late_divergence, recommendation_prompt
from fairness_llm_tpu_torch.telemetry import (
    Heartbeat,
    get_fairness_monitor,
    get_registry,
    group_exposure,
    publish_offline_reference,
)
from fairness_llm_tpu_torch.utils.failures import with_failure_containment
from fairness_llm_tpu_torch.utils.progress import print_progress

logger = logging.getLogger(__name__)


def decode_sweep(
    backend: DecodeBackend,
    prompts: Sequence[str],
    keys: Sequence[str],
    config: Config,
    phase: str,
    done: Optional[Dict[str, Dict]] = None,
    settings=None,
    parse=parse_numbered_list,
    save_checkpoints: bool = True,
) -> Dict[str, Dict]:
    """Chunked batched decode with checkpointing. Returns {key:
    {recommendations, raw_response}} in input order, reusing the entries
    already in ``done`` (the resume path)."""
    generate = with_failure_containment(backend.generate)
    # The prefix is computed over the full sweep, not per chunk, so resumed
    # and uninterrupted runs split attention identically.
    prefix_ids = shared_prefix_ids(backend, list(prompts))
    done = dict(done or {})
    chunk = max(config.decode_batch_size, 1)
    # A terminal gets the live bar (and the per-chunk line drops to DEBUG so
    # it cannot splice into the bar); piped runs keep the INFO lines.
    interactive = getattr(sys.stderr, "isatty", lambda: False)()
    last_drawn = -1
    # A liveness pulse for long sweeps (at most one line and event an
    # interval), where the per-chunk lines scroll away or drop to DEBUG.
    heartbeat = Heartbeat(interval_s=30.0, name=phase)
    # Chunks cover absolute positions in the full prompt list, so each
    # chunk's seed is the same whether or not the run was resumed.
    for start in range(0, len(keys), chunk):
        batch = [
            (k, p)
            for k, p in zip(keys[start : start + chunk], prompts[start : start + chunk])
            if k not in done
        ]
        if not batch:
            continue
        texts = generate(
            [p for _, p in batch],
            settings,
            seed=config.random_seed + start,
            keys=[k for k, _ in batch],
            prefix_ids=prefix_ids,
        )
        mon = get_fairness_monitor()
        for (k, _), text in zip(batch, texts):
            if text is None:  # a contained decode failure (utils/failures.py)
                done[k] = {"recommendations": [], "raw_response": "", "error": "decode_failed"}
            else:
                done[k] = {"recommendations": parse(text), "raw_response": text}
            if mon.active:
                # The fairness monitor's content side; error rows stream too,
                # as the offline metrics count their empty lists.
                mon.observe_output(k, done[k]["recommendations"], error="error" in done[k])
        if mon.active:
            mon.maybe_refresh()
        completed = len(done)
        if save_checkpoints and config.checkpoint_every and (
            completed % config.checkpoint_every < chunk or start + chunk >= len(keys)
        ):
            # Failed entries stay out of checkpoints, so that a resume
            # retries them.
            ok = {k: v for k, v in done.items() if "error" not in v}
            R.save_checkpoint(ok, config.results_dir, phase, completed)
        if interactive:
            logger.debug("%s sweep: %d/%d decoded", phase, completed, len(keys))
            print_progress(completed, len(keys), prefix=f"{phase} ")
            last_drawn = completed
        else:
            logger.info("%s sweep: %d/%d decoded", phase, completed, len(keys))
        heartbeat.poke(completed=completed, total=len(keys))
    if 0 <= last_drawn < len(keys):
        # a resume whose tail chunks were cached leaves the bar mid-line
        print_progress(len(keys), len(keys), prefix=f"{phase} ")
    mon = get_fairness_monitor()
    if mon.active:
        # Backfill what the stream never saw (a resume's checkpointed rows;
        # observe_output ignores keys it has), so that the run window covers
        # exactly the returned results, then refresh the gauges.
        for k in keys:
            if k in done:
                mon.observe_output(k, done[k]["recommendations"], error="error" in done[k])
        mon.refresh()
    return {k: done[k] for k in keys if k in done}


def group_by(profiles: Sequence[Profile], recs: Dict[str, Dict], attr: str) -> Dict[str, List[List[str]]]:
    out: Dict[str, List[List[str]]] = defaultdict(list)
    for p in profiles:
        if p.id in recs:
            out[getattr(p, attr)].append(recs[p.id]["recommendations"])
    return dict(out)


def measure_demographic_parity(
    recommendations_by_group: Dict[str, List[List[str]]],
    group_counts_fn=None,
) -> Tuple[float, Dict]:
    """``group_counts_fn`` replaces the count reduction (the dp study's
    ``metrics.sharded.mesh_group_counts_fn``)."""
    return M.demographic_parity(recommendations_by_group, group_counts_fn)


def measure_individual_fairness(
    profiles: Sequence[Profile], recommendations: Dict[str, List[str]]
) -> Tuple[float, List[float]]:
    """Mean Jaccard over counterfactual pairs that differ in one attribute."""
    return M.individual_fairness(profile_pairs(profiles), recommendations)


def measure_equal_opportunity(
    recommendations_by_group: Dict[str, List[List[str]]],
    qualified: Set[str],
    group_counts_fn=None,
) -> Tuple[float, Dict[str, float]]:
    """Equal opportunity over canonicalised titles (raw-string matching is
    vacuously 1.0); ``group_counts_fn`` as in
    ``measure_demographic_parity``."""
    canon_groups = {
        g: [canonicalize(r) for r in lists]
        for g, lists in recommendations_by_group.items()
    }
    return M.equal_opportunity(canon_groups, set(canonicalize(sorted(qualified))),
                               group_counts_fn)


def register_fairness_study(profiles: Sequence[Profile]):
    """Arm the fairness monitor for one sweep: every profile's groups and
    the full counterfactual pair grid. ``ServingBackend`` then stamps the
    tags on its requests, the scheduler's terminal paths feed the
    neutrality audit, and ``decode_sweep`` feeds the streaming
    accumulators, whose end-of-run values the offline metrics check.
    Returns the monitor."""
    mon = get_fairness_monitor()
    mon.begin_study()
    by_id = {p.id: p for p in profiles}
    for p in profiles:
        mon.register_request(p.id, {"gender": p.gender, "age": p.age})
    for a, b in profile_pairs(profiles):
        pa, pb = by_id[a], by_id[b]
        attr = next(x for x in ("gender", "age", "occupation") if getattr(pa, x) != getattr(pb, x))
        mon.register_pair(f"{a}|{b}", a, b, attr)
    return mon


def qualified_movies(data, top_n: int = 10, seed: int = 42) -> List[str]:
    """The 'qualified' set for equal opportunity: the corpus's top-rated
    popular movies."""
    return create_base_preferences(data, num_movies=top_n, seed=seed)["watched_movies"]


def run_phase1(
    config: Optional[Config] = None,
    model_name: Optional[str] = None,
    num_profiles: Optional[int] = None,
    save: bool = True,
    backend: Optional[DecodeBackend] = None,
    resume: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """The full bias-detection sweep; returns the results record. Without
    ``backend``, ``backend_for(model_name, config, device=device)`` makes
    one (None means CUDA). Under a process group only rank 0 writes the
    checkpoints and the record; every rank returns the same record."""
    config = config or default_config()
    save = save and is_primary()
    model_name = model_name or config.default_model_phase1
    t0 = time.time()

    data = load_movielens(config.data_dir, seed=config.random_seed)
    base_prefs = create_base_preferences(data, seed=config.random_seed)
    profiles = create_profile_grid(base_prefs, config, num_profiles)

    if backend is None:
        backend = backend_for(model_name, config, catalog=data.titles, device=device)
    settings = config.settings_for(model_name) if model_name != "simulated" else None

    # the sweep: demographic prompts plus one neutral prompt set for SNSR/SNSV
    prompts = [recommendation_prompt(p) for p in profiles]
    keys = [p.id for p in profiles]
    prompt_by_key = dict(zip(keys, prompts))
    divergence = check_late_divergence(
        [(prompt_by_key[a], prompt_by_key[b]) for a, b in profile_pairs(profiles)],
        phase="phase1",
    )
    per_combo = num_profiles or config.profiles_per_combo
    neutral_keys = [f"neutral_{i:04d}" for i in range(per_combo)]
    neutral_profiles = [
        Profile(
            id=k, gender="", age="", occupation=config.occupation,
            watched_movies=base_prefs["watched_movies"],
            favorite_genres=base_prefs["favorite_genres"],
        )
        for k in neutral_keys
    ]
    neutral_prompts = [recommendation_prompt(p, anonymize=True) for p in neutral_profiles]
    mon = register_fairness_study(profiles) if config.telemetry.fairness_obs else None

    if hasattr(backend, "spec_totals"):
        # a reused backend may carry counters of earlier runs
        backend.spec_totals = None
    if hasattr(backend, "serve_totals"):
        backend.serve_totals = None  # the same for the serving counters
    done = R.load_latest_checkpoint(config.results_dir, "phase1") if resume else {}
    recs = decode_sweep(
        backend,
        list(prompts) + neutral_prompts,
        list(keys) + neutral_keys,
        config,
        "phase1",
        done=done,
        settings=settings,
        save_checkpoints=save,
    )
    neutral_recs = [recs.pop(k) for k in neutral_keys if k in recs]

    by_gender = group_by(profiles, recs, "gender")
    by_age = group_by(profiles, recs, "age")
    # A dp-sharded sweep reduces the metric counts on the mesh too: each
    # rank sums its shard of the [N, V] rows on its device and all-reduces
    # over dp; only the [G, V] result and the scores reach the host.
    engine = getattr(backend, "engine", None)
    mesh = getattr(engine, "mesh", None)
    counts_fn = None
    if axis_size(mesh, "dp") > 1:
        counts_fn = mesh_group_counts_fn(mesh, engine.device)
    qualified = set(qualified_movies(data, seed=config.random_seed))
    dp_gender, dp_gender_detail = measure_demographic_parity(by_gender, counts_fn)
    dp_age, dp_age_detail = measure_demographic_parity(by_age, counts_fn)
    eo_score, eo_rates = measure_equal_opportunity(by_gender, qualified, counts_fn)
    eo_age, eo_age_rates = measure_equal_opportunity(by_age, qualified, counts_fn)

    flat_recs = {pid: r["recommendations"] for pid, r in recs.items()}
    if_score, if_sims = measure_individual_fairness(profiles, flat_recs)

    neutral_flat = [t for r in neutral_recs for t in r["recommendations"]]
    recs_by_gender_flat = {g: [t for lst in lists for t in lst] for g, lists in by_gender.items()}
    snsr, snsv, sns_sims = M.snsr_snsv(neutral_flat, recs_by_gender_flat)
    recs_by_age_flat = {a: [t for lst in lists for t in lst] for a, lists in by_age.items()}
    snsr_age, snsv_age, sns_sims_age = M.snsr_snsv(neutral_flat, recs_by_age_flat)

    # The offline scores as fairness_offline_* gauges beside the streaming
    # ones, and both sides in the record.
    fairness_block = None
    if mon is not None and mon.active:
        expo_gender, _ = group_exposure(by_gender)
        expo_age, _ = group_exposure(by_age)
        publish_offline_reference({"gender": dp_gender, "age": dp_age}, if_score=if_score,
                                  exposure={"gender": expo_gender, "age": expo_age})
        fairness_block = {
            "live": mon.live_values(),
            "offline": {
                "dp": {"gender": dp_gender, "age": dp_age},
                "individual_fairness": if_score,
                "exposure_ratio": {"gender": expo_gender, "age": expo_age},
            },
        }

    elapsed = time.time() - t0
    reg = get_registry()
    reg.histogram("phase_wall_s", component="phase1").observe(elapsed)
    reg.counter("phase_runs_total", component="phase1").inc()
    reg.counter("profiles_decoded_total", component="phase1").inc(len(recs))
    reg.counter("decode_failures_total", component="phase1").inc(
        sum(1 for r in recs.values() if "error" in r))
    results = {
        "metadata": {
            "phase": 1,
            "model": backend.name,
            "num_profiles": len(profiles),
            "timestamp": time.time(),
            "elapsed_seconds": elapsed,
            "notes": (
                "equal_opportunity uses canonicalized titles (reference's raw-string "
                "matching yields vacuous 1.0); snsr/snsv are net-new vs reference"
            ),
            # the count reduction: over the dp mesh, or on the host
            "metric_reduction": "dp-psum" if counts_fn is not None else "host",
            # the engine's weight mode; None for non-engine backends
            "weight_quant": getattr(
                getattr(getattr(backend, "engine", None), "config", None),
                "weight_quant", None,
            ),
            "corpus": data.provenance(),
            "speculation": (
                backend.spec_totals.as_dict()
                if getattr(backend, "spec_totals", None) is not None else None
            ),
            # the continuous-batching counters of the whole sweep
            "serving": (
                backend.serve_totals.as_dict()
                if getattr(backend, "serve_totals", None) is not None else None
            ),
            "fairness": fairness_block,
            "prompt_divergence": divergence,
        },
        "profiles": [p.to_dict() for p in profiles],
        "recommendations": {
            pid: {**r, "profile_id": pid, "model": backend.name} for pid, r in recs.items()
        },
        "neutral_recommendations": [r["recommendations"] for r in neutral_recs],
        "metrics": {
            "demographic_parity_gender": {"score": dp_gender, **dp_gender_detail},
            "demographic_parity_age": {"score": dp_age, **dp_age_detail},
            "individual_fairness": {"score": if_score, "num_pairs": len(if_sims)},
            "equal_opportunity": {"score": eo_score, "group_scores": eo_rates},
            "equal_opportunity_age": {"score": eo_age, "group_scores": eo_age_rates},
            "snsr_snsv": {"snsr": snsr, "snsv": snsv, "group_similarities": sns_sims},
            "snsr_snsv_age": {
                "snsr": snsr_age, "snsv": snsv_age, "group_similarities": sns_sims_age,
            },
        },
    }
    if save:
        R.save_results(results, f"{config.results_dir}/phase1/phase1_results.json")
    logger.info(
        "phase1 done in %.1fs: DP(gender)=%.4f DP(age)=%.4f IF=%.4f EO=%.4f SNSR=%.4f",
        elapsed, dp_gender, dp_age, if_score, eo_score, snsr,
    )
    return results


def print_phase1_summary(results: Dict) -> None:
    m = results["metrics"]
    print("\n" + "=" * 60)
    print("PHASE 1 SUMMARY — bias detection")
    print("=" * 60)
    print(f"model: {results['metadata']['model']}   profiles: {results['metadata']['num_profiles']}")
    print(f"demographic parity (gender): {m['demographic_parity_gender']['score']:.4f}")
    print(f"demographic parity (age):    {m['demographic_parity_age']['score']:.4f}")
    print(f"individual fairness:         {m['individual_fairness']['score']:.4f}")
    print(f"equal opportunity:           {m['equal_opportunity']['score']:.4f}")
    if "equal_opportunity_age" in m:
        print(f"equal opportunity (age):     {m['equal_opportunity_age']['score']:.4f}")
    print(f"SNSR/SNSV (gender): {m['snsr_snsv']['snsr']:.4f} / {m['snsr_snsv']['snsv']:.4f}")
    if "snsr_snsv_age" in m:
        print(f"SNSR/SNSV (age):    {m['snsr_snsv_age']['snsr']:.4f} / {m['snsr_snsv_age']['snsv']:.4f}")
    for name, score in (
        ("gender parity", m["demographic_parity_gender"]["score"]),
        ("age parity", m["demographic_parity_age"]["score"]),
    ):
        level = "fair" if score >= 0.8 else ("moderate" if score >= 0.7 else "biased")
        print(f"  -> {name}: {level}")
