"""Phase 3: FACTER mitigation (counterpart of
``fairness_llm_tpu/pipeline/phase3.py``).

Phase 1's record (in memory, saved, or run now) -> fairness-aware
re-prompting of every profile (``decode_sweep``, batched) -> conformal
calibration, per-gender thresholds and filtering, or the balanced re-rank of
the smart and aggressive variants (``pipeline/facter.py``) -> bias and
quality before and after.

The ``model`` and ``model-conditional`` calibrations score the mitigated
titles with the backend's own model (``runtime/scoring.py``), so they need
an engine backend.

With ``config.telemetry.fairness_obs`` the mitigated sweep's requests
carry study tags for the fairness monitor, armed here only when no study is
live (in an ``--all`` run phase 1 armed it). The phase's registry counters
(``phase_wall_s``, ``phase_runs_total``, ``profiles_mitigated_total``) are
the reference's. A failed decode or scoring forward raises out of
``run_phase3``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from fairness_llm_tpu_torch.config import Config, default_config
from fairness_llm_tpu_torch.data.profiles import Profile, profile_pairs
from fairness_llm_tpu_torch.metrics import fairness as M
from fairness_llm_tpu_torch.parallel.multihost import is_primary
from fairness_llm_tpu_torch.pipeline import results as R
from fairness_llm_tpu_torch.pipeline.backends import DecodeBackend, backend_for
from fairness_llm_tpu_torch.pipeline.facter import (
    blended_group_fairness,
    conformal_filter_mask,
    conformal_keep_counts,
    conformal_thresholds_kernel,
    model_confidences,
    nonconformity_from_confidence,
    simulate_calibration,
    smart_balance,
)
from fairness_llm_tpu_torch.pipeline.parsing import parse_comma_list, parse_numbered_list
from fairness_llm_tpu_torch.pipeline.phase1 import (
    decode_sweep,
    register_fairness_study,
    run_phase1,
)
from fairness_llm_tpu_torch.pipeline.prompts import (
    calibration_context,
    check_late_divergence,
    fairness_aware_prompt,
    recommendation_prompt,
)
from fairness_llm_tpu_torch.telemetry import get_fairness_monitor, get_registry

logger = logging.getLogger(__name__)

VARIANTS = ("conformal", "smart", "aggressive")
CALIBRATIONS = ("simulated", "model", "model-conditional")


def _profiles_from_dicts(dicts: List[Dict]) -> List[Profile]:
    out = []
    for d in dicts:
        prefs = d.get("preferences", {})
        out.append(
            Profile(
                id=d["id"], gender=d.get("gender", ""), age=d.get("age", ""),
                occupation=d.get("occupation", ""),
                watched_movies=list(prefs.get("watched_movies", [])),
                favorite_genres=list(prefs.get("favorite_genres", [])),
                avg_rating=prefs.get("avg_rating", 4.5),
            )
        )
    return out


def _check_calibration(calibration: str) -> None:
    if calibration not in CALIBRATIONS:
        # an unknown name would run the simulated curve under its own label
        raise ValueError(
            f"unknown calibration {calibration!r} "
            "(simulated | model | model-conditional)"
        )


def apply_facter(
    profiles: List[Profile],
    backend: DecodeBackend,
    config: Config,
    strategy: str = "demographic_parity",
    variant: str = "conformal",
    settings=None,
    save_checkpoints: bool = True,
    calibration: str = "simulated",
    confidence_mapping: str = "percentile",
    confidence_temperature: float = 1.0,
) -> Dict[str, List[str]]:
    """Fair re-prompting, then conformal filtering -> {pid: mitigated list}.

    ``calibration``: "simulated" is the reference study's rank-decreasing
    confidence ``1 - 0.05*rank``; "model" takes each title's unconditional
    likelihood under the backend's model; "model-conditional" its likelihood
    given the profile's watch history (``prompts.calibration_context``, no
    demographics). ``confidence_mapping`` and ``confidence_temperature`` go
    to ``facter.model_confidences``."""
    _check_calibration(calibration)
    anonymize = variant in ("smart", "aggressive")
    prompts = [
        fairness_aware_prompt(
            recommendation_prompt(p, anonymize=anonymize),
            strategy if variant == "conformal" else "individual_fairness",
            aggressive=(variant == "aggressive"),
        )
        for p in profiles
    ]
    # The mitigation sweep's counterfactual pairs must diverge late too, for
    # the shared prefix.
    prompt_of = dict(zip((p.id for p in profiles), prompts))
    check_late_divergence(
        [(prompt_of[a], prompt_of[b]) for a, b in profile_pairs(profiles)],
        phase="phase3",
    )
    if variant == "aggressive" and settings is not None:
        # near-greedy decode, as the reference's aggressive variant
        settings = dataclasses.replace(settings, temperature=0.1)
    parse = parse_numbered_list if variant == "conformal" else _parse_any
    fair = decode_sweep(
        backend, prompts, [p.id for p in profiles], config, "phase3",
        settings=settings, parse=parse, save_checkpoints=save_checkpoints,
    )
    fair_lists = {pid: r["recommendations"] for pid, r in fair.items()}

    if variant != "conformal":
        return fair_lists

    # conformal calibration, per-gender thresholds, filtering
    pids = [p.id for p in profiles if p.id in fair_lists]
    genders = sorted({p.gender for p in profiles})
    gidx = {g: i for i, g in enumerate(genders)}
    gender_of = {p.id: p.gender for p in profiles}
    lengths = np.array([len(fair_lists[pid]) for pid in pids], dtype=np.int64)

    if calibration in ("model", "model-conditional"):
        engine = getattr(backend, "engine", None)
        if engine is None:
            raise ValueError(f"calibration={calibration!r} needs an EngineBackend")

        all_titles = [t for pid in pids for t in fair_lists[pid]]
        if not all_titles:
            lp_flat = np.zeros(0, np.float64)
        elif calibration == "model":
            # one score per distinct title
            from fairness_llm_tpu_torch.runtime.scoring import score_texts

            unique_titles = sorted(set(all_titles))
            sc = score_texts(engine, unique_titles)
            lp_of = dict(zip(unique_titles, sc.mean_logprobs))
            lp_flat = np.array([lp_of[t] for t in all_titles], np.float64)
        else:
            # log p(title | the user's watch history), one scoring sweep
            from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations

            prof_of = {p.id: p for p in profiles}
            ctx = [
                calibration_context(prof_of[pid])
                for pid in pids
                for _ in fair_lists[pid]
            ]
            sc = score_prompted_continuations(engine, ctx, all_titles)
            lp_flat = np.asarray(sc.mean_logprobs, np.float64)
        conf = model_confidences(
            lp_flat, mapping=confidence_mapping, temperature=confidence_temperature
        )
        conf_rows = np.split(conf, np.cumsum(lengths)[:-1]) if len(pids) else []
        nonconf = nonconformity_from_confidence(conf, config.random_seed)
    else:
        conf, nonconf = simulate_calibration(lengths, seed=config.random_seed)

    record_groups = np.concatenate(
        [np.full(n, gidx[gender_of[pid]], dtype=np.int32) for pid, n in zip(pids, lengths)]
    ) if len(pids) else np.zeros(0, np.int32)
    thresholds = conformal_thresholds_kernel(
        torch.from_numpy(np.asarray(nonconf, np.float32)), torch.from_numpy(record_groups),
        len(genders), alpha=config.conformal_alpha,
    ).numpy()
    per_profile_thresh = np.array([thresholds[gidx[gender_of[pid]]] for pid in pids],
                                  dtype=np.float32)

    if calibration in ("model", "model-conditional"):
        k_max = int(lengths.max()) if len(lengths) else 1
        conf_mat = np.full((len(pids), max(k_max, 1)), np.nan, np.float32)
        for i, row in enumerate(conf_rows):
            conf_mat[i, : len(row)] = row
        mask = conformal_filter_mask(
            torch.from_numpy(conf_mat), torch.from_numpy(per_profile_thresh)).numpy()
        return {
            pid: [t for j, t in enumerate(fair_lists[pid]) if mask[i, j]]
            for i, pid in enumerate(pids)
        }

    # simulated: the confidence falls with rank, so the filter keeps a prefix
    keep = conformal_keep_counts(lengths, per_profile_thresh)
    return {pid: fair_lists[pid][: int(k)] for pid, k in zip(pids, keep)}


def _parse_any(text: str, max_items: int = 10) -> List[str]:
    items = parse_numbered_list(text, max_items)
    return items if items else parse_comma_list(text, max_items)


def measure_bias_reduction(
    original: Dict[str, List[str]], mitigated: Dict[str, List[str]], profiles: List[Profile]
) -> Dict:
    """Demographic parity before and after: bias = 1 - parity, reduction =
    (bias_orig - bias_mit) / bias_orig * 100."""
    gender_of = {p.id: p.gender for p in profiles}

    def by_gender(recs: Dict[str, List[str]]) -> Dict[str, List[List[str]]]:
        out = defaultdict(list)
        for pid, lst in recs.items():
            if pid in gender_of:
                out[gender_of[pid]].append(lst)
        return dict(out)

    dp_orig, _ = M.demographic_parity(by_gender(original))
    dp_mit, _ = M.demographic_parity(by_gender(mitigated))
    bias_orig, bias_mit = 1 - dp_orig, 1 - dp_mit
    rate = (bias_orig - bias_mit) / bias_orig * 100 if bias_orig > 0 else 0.0
    return {
        "original_fairness": dp_orig,
        "mitigated_fairness": dp_mit,
        "original_bias": bias_orig,
        "mitigated_bias": bias_mit,
        "bias_reduction_rate": rate,
    }


def measure_quality_preservation(
    original: Dict[str, List[str]], mitigated: Dict[str, List[str]]
) -> Dict:
    """Mean Jaccard overlap of the original and mitigated top 10, and as a
    percentage."""
    overlaps = []
    for pid, orig in original.items():
        if pid not in mitigated:
            continue
        a, b = set(orig[:10]), set(mitigated[pid][:10])
        if not a and not b:
            overlaps.append(1.0)
        else:
            u = len(a | b)
            overlaps.append(len(a & b) / u if u else 0.0)
    avg = float(np.mean(overlaps)) if overlaps else 0.0
    return {
        "average_overlap": avg,
        "quality_preservation_pct": avg * 100,
        "num_comparisons": len(overlaps),
    }


def run_phase3(
    config: Optional[Config] = None,
    phase1_results: Optional[Dict] = None,
    model_name: Optional[str] = None,
    num_profiles: Optional[int] = None,
    variant: str = "conformal",
    strategy: str = "demographic_parity",
    save: bool = True,
    backend: Optional[DecodeBackend] = None,
    calibration: str = "simulated",
    confidence_mapping: str = "percentile",
    confidence_temperature: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Phase 3 on ``phase1_results``, else on the saved phase-1 record, else
    on a phase-1 run made now. Without ``backend``, ``backend_for(model_name,
    config, device=device)`` makes one (None means CUDA)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    # before the phase-1 load or run, which may take long
    _check_calibration(calibration)
    if calibration != "simulated" and variant != "conformal":
        # smart and aggressive do not filter: a model calibration would go
        # unused while the record names it
        raise ValueError("model calibration applies only to variant='conformal'")
    config = config or default_config()
    save = save and is_primary()  # rank 0 alone writes under a process group
    model_name = model_name or config.default_model_phase3
    t0 = time.time()

    if phase1_results is None:
        phase1_results = R.load_results(f"{config.results_dir}/phase1/phase1_results.json")
    if phase1_results is None:
        logger.info("phase3: no phase-1 results; running phase 1 first")
        phase1_results = run_phase1(config, model_name, save=save, backend=backend,
                                    device=device)

    profiles = _profiles_from_dicts(phase1_results["profiles"])
    if num_profiles:
        # The first num_profiles of each (gender, age) combination: the grid
        # is gender-major, so a plain prefix would keep one gender only.
        taken: Dict[tuple, int] = defaultdict(int)
        kept = []
        for p in profiles:
            combo = (p.gender, p.age)
            if taken[combo] < num_profiles:
                taken[combo] += 1
                kept.append(p)
        profiles = kept
    wanted = {p.id for p in profiles}
    original = {
        pid: r.get("recommendations", [])
        for pid, r in phase1_results["recommendations"].items()
        if pid in wanted
    }

    if backend is None:
        catalog = sorted({t for lst in original.values() for t in lst}) or ["placeholder"]
        backend = backend_for(model_name, config, catalog=catalog, device=device)
    settings = config.settings_for(model_name) if model_name != "simulated" else None
    if hasattr(backend, "serve_totals"):
        # A reused ServingBackend then holds this phase's serving counters;
        # the record leaves them out, as the reference's does.
        backend.serve_totals = None
    if config.telemetry.fairness_obs and not get_fairness_monitor().active:
        # Only when no study is live: in an --all run phase 1 armed the
        # monitor and published its offline gauges, and registering again
        # would overwrite the run-window gauges with the mitigated sweep's
        # values beside phase 1's stale offline ones, failing the
        # live-vs-offline check on a healthy run. Phase 3 reuses phase 1's
        # profile ids, so that registration keeps tagging its requests, and
        # the content dedup keeps the accumulators on phase 1's results.
        register_fairness_study(profiles)

    mitigated = apply_facter(
        profiles, backend, config, strategy, variant, settings,
        save_checkpoints=save, calibration=calibration,
        confidence_mapping=confidence_mapping,
        confidence_temperature=confidence_temperature,
    )

    if variant in ("smart", "aggressive"):
        gender_of = {p.id: p.gender for p in profiles}
        by_gender: Dict[str, List[List[str]]] = defaultdict(list)
        order: Dict[str, List[str]] = defaultdict(list)
        for pid, lst in mitigated.items():
            g = gender_of.get(pid, "")
            by_gender[g].append(lst)
            order[g].append(pid)
        balanced = smart_balance(dict(by_gender), aggressive=(variant == "aggressive"))
        mitigated = {
            pid: lst
            for g, pids in order.items()
            for pid, lst in zip(pids, balanced[g])
        }

    bias = measure_bias_reduction(original, mitigated, profiles)
    quality = measure_quality_preservation(original, mitigated)
    gender_of = {p.id: p.gender for p in profiles}
    mit_by_gender: Dict[str, List[List[str]]] = defaultdict(list)
    for pid, lst in mitigated.items():
        mit_by_gender[gender_of.get(pid, "")].append(lst)
    blended = blended_group_fairness(dict(mit_by_gender))
    reg = get_registry()
    reg.histogram("phase_wall_s", component="phase3").observe(time.time() - t0)
    reg.counter("phase_runs_total", component="phase3").inc()
    reg.counter("profiles_mitigated_total", component="phase3").inc(len(mitigated))

    results = {
        "metadata": {
            "phase": 3,
            "variant": variant,
            "strategy": strategy,
            "calibration": calibration,
            "confidence_mapping": confidence_mapping if calibration != "simulated" else None,
            "model": backend.name,
            "num_profiles": len(profiles),
            "timestamp": time.time(),
            "elapsed_seconds": time.time() - t0,
        },
        "mitigated_recommendations": mitigated,
        "bias_reduction": bias,
        "quality_preservation": quality,
        "blended_fairness": blended,
        "success_criteria": {
            "bias_reduction_target_pct": config.bias_reduction_target,
            "bias_reduction_met": bias["bias_reduction_rate"] >= config.bias_reduction_target,
            "quality_min_pct": config.accuracy_preservation_min,
            "quality_met": quality["quality_preservation_pct"] >= config.accuracy_preservation_min,
        },
    }
    if save:
        suffix = "" if variant == "conformal" else f"_{variant}"
        R.save_results(results, f"{config.results_dir}/phase3/phase3{suffix}_results.json")
    logger.info(
        "phase3(%s) done in %.1fs: bias reduction %.2f%%, quality %.2f%%",
        variant, time.time() - t0, bias["bias_reduction_rate"],
        quality["quality_preservation_pct"],
    )
    return results


def print_phase3_summary(results: Dict) -> None:
    b, q, s = results["bias_reduction"], results["quality_preservation"], results["success_criteria"]
    print("\n" + "=" * 60)
    print(f"PHASE 3 SUMMARY — FACTER mitigation ({results['metadata']['variant']})")
    print("=" * 60)
    print(f"fairness: {b['original_fairness']:.4f} -> {b['mitigated_fairness']:.4f}")
    print(f"bias reduction: {b['bias_reduction_rate']:.2f}%  (target {s['bias_reduction_target_pct']:.0f}%: {'MET' if s['bias_reduction_met'] else 'not met'})")
    print(f"quality preservation: {q['quality_preservation_pct']:.2f}%  (min {s['quality_min_pct']:.0f}%: {'MET' if s['quality_met'] else 'not met'})")
    print(f"blended group fairness: {results['blended_fairness']:.4f}")
