"""Phase 2: cross-model ranking-fairness evaluation (counterpart of
``fairness_llm_tpu/pipeline/phase2.py``).

For each model: rank a corpus of items tagged with a protected group,
listwise (all listwise queries decoded as one batch) and pairwise (all pair
prompts decoded as one batch), and, for an engine backend, by the model's
own likelihood of each item given the query (one chunked scoring sweep);
then exposure ratio, per-group NDCG and pairwise win rates, compared across
models and methods. Parse failures are counted, not hidden. The phase's
registry counters (``phase_wall_s``, ``phase_runs_total``,
``models_evaluated_total``) are the reference's. A failed decode or scoring
forward raises out of ``run_phase2``.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fairness_llm_tpu_torch.config import Config, default_config
from fairness_llm_tpu_torch.data.movielens import load_movielens
from fairness_llm_tpu_torch.data.ranking import (
    RankingItem,
    create_synthetic_ranking_data,
    movielens_ranking_corpus,
)
from fairness_llm_tpu_torch.metrics.fairness import exposure_ratio
from fairness_llm_tpu_torch.metrics.ranking import ndcg
from fairness_llm_tpu_torch.parallel.multihost import is_primary
from fairness_llm_tpu_torch.pipeline import results as R
from fairness_llm_tpu_torch.pipeline.backends import DecodeBackend, backend_for
from fairness_llm_tpu_torch.pipeline.parsing import (
    parse_pairwise_answer_full,
    parse_ranking_indices_with_count,
)
from fairness_llm_tpu_torch.pipeline.prompts import listwise_prompt, pairwise_prompt
from fairness_llm_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)


def listwise_evaluation(
    backend: DecodeBackend, items: Sequence[RankingItem], settings=None, seed: int = 0
) -> List[int]:
    """One ranking prompt over all items -> item-id ranking (unranked appended)."""
    return listwise_evaluation_batch(backend, items, [None], settings, seed)[0][0]


# Phrasings of derived listwise queries: each (theme, template) pair is a
# distinct prompt, so the pool never repeats a query.
_QUERY_TEMPLATES = (
    "the best {} movies",
    "top-rated {} movies",
    "{} movies worth watching tonight",
)
_TOPIC_TEMPLATES = (
    "documents about topic {}",
    "the most useful documents on topic {}",
    "documents a reader researching topic {} should see first",
)


def make_queries(items: Sequence[RankingItem], num_queries: int) -> List[Optional[str]]:
    """Up to ``num_queries`` distinct listwise queries: ``None`` (the default
    relevance query) first, then the corpus's most common genres (MovieLens)
    or topics (synthetic) in several phrasings. Capped, and the cap logged,
    where the corpus has too few; never padded with repeats."""
    queries: List[Optional[str]] = [None]
    if num_queries <= 1:
        return queries
    genre_counts: Counter = Counter()
    for it in items:
        genre_counts.update(it.genres)
    if genre_counts:
        themes = [g for g, _ in genre_counts.most_common()]
        templates = _QUERY_TEMPLATES
    else:
        themes = sorted({it.text.split("topic ")[-1] for it in items if "topic " in it.text})
        templates = _TOPIC_TEMPLATES
    pool = [t.format(theme) for t in templates for theme in themes]
    queries.extend(pool[: num_queries - 1])
    if len(queries) < num_queries:
        logger.warning(
            "make_queries: corpus supports only %d distinct queries (asked for %d)",
            len(queries), num_queries,
        )
    return queries


def listwise_evaluation_batch(
    backend: DecodeBackend,
    items: Sequence[RankingItem],
    queries: Sequence[Optional[str]],
    settings=None,
    seed: int = 0,
) -> Tuple[List[List[int]], List[int]]:
    """All listwise query prompts as one batch -> (per-query item-id
    rankings, per-query parsed-index counts; 0 means the identity order
    stood in)."""
    prompts = [listwise_prompt(items, query=q) for q in queries]
    keys = [f"listwise::{q}" for q in queries]
    texts = backend.generate(prompts, settings, seed=seed, keys=keys)
    rankings, parsed_counts = [], []
    for text in texts:
        order, parsed = parse_ranking_indices_with_count(text, len(items))
        rankings.append([items[i].id for i in order])
        parsed_counts.append(parsed)
    return rankings, parsed_counts


def scored_ranking_prompt(query: Optional[str]) -> str:
    """The conditioning prefix for likelihood-based ranking."""
    q = query or "most relevant and high-quality documents"
    return f"Query: {q}\nA highly relevant result: "


def scored_evaluation(
    backend: DecodeBackend,
    items: Sequence[RankingItem],
    queries: Sequence[Optional[str]],
) -> List[List[int]]:
    """Rank items by the model's mean log p(item | query): every (query,
    item) pair in one scoring sweep; no parsing. Needs an engine backend."""
    from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations

    engine = backend.engine  # type: ignore[attr-defined]
    n = len(items)
    row_prompts = [scored_ranking_prompt(q) for q in queries for _ in items]
    row_conts = [it.text for _ in queries for it in items]
    sc = score_prompted_continuations(engine, row_prompts, row_conts)
    per_query_scores = sc.mean_logprobs.reshape(len(queries), n)
    rankings = []
    for qi in range(len(queries)):
        order = np.argsort(-per_query_scores[qi], kind="stable")
        rankings.append([items[int(i)].id for i in order])
    return rankings


def pairwise_evaluation(
    backend: DecodeBackend,
    items: Sequence[RankingItem],
    num_comparisons: int = 30,
    settings=None,
    seed: int = 0,
) -> Tuple[List[int], List[Dict]]:
    """``num_comparisons`` seeded random pairs decoded as one batch; the
    ranking is by win count."""
    rng = np.random.default_rng(seed)
    n = len(items)
    pairs = [tuple(rng.choice(n, size=2, replace=False)) for _ in range(num_comparisons)]
    prompts = [pairwise_prompt(items[a], items[b]) for a, b in pairs]
    texts = backend.generate(prompts, settings, seed=seed)

    comparisons = []
    wins: Dict[int, int] = {}
    for (a, b), text in zip(pairs, texts):
        winner, parsed = parse_pairwise_answer_full(text)
        comparisons.append(
            {
                "item_a": items[a].id,
                "item_b": items[b].id,
                "item_a_attr": items[a].protected_attribute,
                "item_b_attr": items[b].protected_attribute,
                "winner": winner,
                "parsed": parsed,
            }
        )
        if winner == "A":
            wins[items[a].id] = wins.get(items[a].id, 0) + 1
        elif winner == "B":
            wins[items[b].id] = wins.get(items[b].id, 0) + 1
    ranked = sorted(wins, key=lambda i: wins[i], reverse=True)
    ranked += [it.id for it in items if it.id not in wins]
    return ranked, comparisons


def pairwise_preference_ratio(comparisons: Sequence[Dict]) -> Dict[str, float]:
    """Per-group win rate over the comparisons the group took part in."""
    wins: Dict[str, int] = {}
    totals: Dict[str, int] = {}
    for c in comparisons:
        if c["winner"] == "A":
            wins[c["item_a_attr"]] = wins.get(c["item_a_attr"], 0) + 1
        elif c["winner"] == "B":
            wins[c["item_b_attr"]] = wins.get(c["item_b_attr"], 0) + 1
        for attr in (c["item_a_attr"], c["item_b_attr"]):
            totals[attr] = totals.get(attr, 0) + 1
    return {g: wins.get(g, 0) / t if t else 0.0 for g, t in totals.items()}


def ndcg_per_group(ranked_ids: Sequence[int], items: Sequence[RankingItem], k: int = 10) -> Dict[str, float]:
    by_group: Dict[str, Dict[int, float]] = {}
    for it in items:
        by_group.setdefault(it.protected_attribute, {})[it.id] = it.relevance
    out = {}
    for group, truth in by_group.items():
        group_ranking = [i for i in ranked_ids if i in truth]
        out[group] = ndcg([str(i) for i in group_ranking], {str(i): r for i, r in truth.items()}, k)
    return out


def _exposure(ranked_ids: Sequence[int], items: Sequence[RankingItem]) -> Tuple[float, Dict[str, float]]:
    attr = {it.id: it.protected_attribute for it in items}
    return exposure_ratio([attr[i] for i in ranked_ids])


def _per_query_entry(query: Optional[str], ranked: List[int], items) -> Dict:
    er, exposure = _exposure(ranked, items)
    return {
        "query": query or "default",
        "ranking": ranked,
        "exposure_ratio": er,
        "group_exposure": exposure,
        "ndcg_per_group": ndcg_per_group(ranked, items),
    }


def _aggregate_queries(per_query: List[Dict]) -> Dict:
    """Means over queries: the exposure ratio and the per-group dicts (a
    group missing from one query counts 0.0 there); "ranking" is query 0's."""

    def mean_per_group(key: str) -> Dict[str, float]:
        groups = sorted({g for q in per_query for g in q[key]})
        return {
            g: float(np.mean([q[key].get(g, 0.0) for q in per_query])) for g in groups
        }

    return {
        "ranking": per_query[0]["ranking"],
        "exposure_ratio": float(np.mean([q["exposure_ratio"] for q in per_query])),
        "group_exposure": mean_per_group("group_exposure"),
        "ndcg_per_group": mean_per_group("ndcg_per_group"),
        "num_queries": len(per_query),
        "per_query": per_query,
    }


def evaluate_model(
    backend: DecodeBackend,
    items: Sequence[RankingItem],
    num_comparisons: int,
    settings=None,
    seed: int = 0,
    num_queries: int = 1,
) -> Dict:
    queries = make_queries(items, num_queries)
    rankings, parsed_counts = listwise_evaluation_batch(backend, items, queries, settings, seed)

    per_query = []
    for q, ranked, parsed in zip(queries, rankings, parsed_counts):
        entry = _per_query_entry(q, ranked, items)
        entry["indices_parsed"] = parsed
        entry["parse_failed"] = parsed == 0
        per_query.append(entry)

    pw_ranked, comparisons = pairwise_evaluation(backend, items, num_comparisons, settings, seed)
    pw_er, pw_exposure = _exposure(pw_ranked, items)
    pw_unparsed = sum(1 for c in comparisons if not c["parsed"])

    extras: Dict = {}
    engine = getattr(backend, "engine", None)
    if engine is not None:
        # A real model: the items' corpus perplexity, and the third ranking
        # method, by likelihood.
        from fairness_llm_tpu_torch.runtime.scoring import perplexity_by_model

        extras["corpus_perplexity"] = perplexity_by_model(
            {backend.name: engine}, [it.text for it in items]
        )[backend.name]
        sc_rankings = scored_evaluation(backend, items, queries)
        extras["scored"] = _aggregate_queries(
            [_per_query_entry(q, r, items) for q, r in zip(queries, sc_rankings)]
        )
    return {
        **extras,
        "listwise": _aggregate_queries(per_query),
        "pairwise": {
            "ranking": pw_ranked,
            "exposure_ratio": pw_er,
            "group_exposure": pw_exposure,
            "preference_ratio": pairwise_preference_ratio(comparisons),
            "ndcg_per_group": ndcg_per_group(pw_ranked, items),
            "num_comparisons": len(comparisons),
        },
        "parse_failures": {
            "listwise_failed_queries": sum(1 for q in per_query if q["parse_failed"]),
            "listwise_failure_rate": float(
                np.mean([q["parse_failed"] for q in per_query])
            ),
            "listwise_mean_fraction_parsed": float(
                np.mean([q["indices_parsed"] / max(len(items), 1) for q in per_query])
            ),
            "pairwise_unparsed": pw_unparsed,
            "pairwise_unparsed_rate": pw_unparsed / max(len(comparisons), 1),
        },
    }


def compare_models_and_methods(model_results: Dict[str, Dict]) -> Dict:
    """average_fairness = (listwise ER + pairwise ER) / 2 per model, as the
    reference study reports it."""
    comparison: Dict = {"model_fairness": {}, "method_comparison": {}}
    lw, pw, sc = [], [], []
    for name, res in model_results.items():
        lf = res["listwise"]["exposure_ratio"]
        pf = res["pairwise"]["exposure_ratio"]
        entry = {
            "listwise_fairness": lf,
            "pairwise_fairness": pf,
            "average_fairness": (lf + pf) / 2,
        }
        if "scored" in res:
            entry["scored_fairness"] = res["scored"]["exposure_ratio"]
            sc.append(res["scored"]["exposure_ratio"])
        comparison["model_fairness"][name] = entry
        lw.append(lf)
        pw.append(pf)
    comparison["method_comparison"] = {
        "listwise_avg": float(np.mean(lw)) if lw else 0.0,
        "pairwise_avg": float(np.mean(pw)) if pw else 0.0,
        "listwise_std": float(np.std(lw)) if lw else 0.0,
        "pairwise_std": float(np.std(pw)) if pw else 0.0,
    }
    if sc:
        comparison["method_comparison"]["scored_avg"] = float(np.mean(sc))
        comparison["method_comparison"]["scored_std"] = float(np.std(sc))
    return comparison


def build_corpus(
    config: Config, corpus: str = "synthetic", num_items: int = 20,
    with_provenance: bool = False,
):
    """``synthetic``: the reference study's 20-document corpus; ``movielens``:
    MovieLens titles with genre-derived groups. ``with_provenance=True``
    returns ``(items, provenance)``."""
    if corpus == "synthetic":
        items = create_synthetic_ranking_data(num_items, seed=config.random_seed)
        prov = {"source": "synthetic-ranking", "num_items": len(items)}
    elif corpus == "movielens":
        data = load_movielens(config.data_dir, seed=config.random_seed)
        items = movielens_ranking_corpus(data, num_items, seed=config.random_seed)
        prov = data.provenance()
    else:
        raise ValueError(
            f"unknown corpus '{corpus}' (expected 'synthetic' or 'movielens')"
        )
    return (items, prov) if with_provenance else items


def run_phase2(
    config: Optional[Config] = None,
    models: Optional[Sequence[str]] = None,
    num_items: int = 20,
    num_comparisons: int = 30,
    save: bool = True,
    backends: Optional[Dict[str, DecodeBackend]] = None,
    corpus: str = "synthetic",
    num_queries: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Phase 2 over ``models``; returns the record. A model without an entry
    in ``backends`` gets ``backend_for(name, config, device=device)`` (None
    means CUDA)."""
    config = config or default_config()
    save = save and is_primary()  # rank 0 alone writes under a process group
    models = list(models or config.default_models_phase2)
    t0 = time.time()

    items, corpus_prov = build_corpus(config, corpus, num_items, with_provenance=True)
    catalog = [it.text for it in items]

    model_results = {}
    known_settings = {n for n, _ in config.model_settings}
    groups = [it.protected_attribute for it in items]
    for name in models:
        backend = (backends or {}).get(name) or backend_for(
            name, config, catalog=catalog, catalog_groups=groups, device=device
        )
        # Injected backends may carry names outside the settings table; they
        # take the engine's defaults, as the simulated backend does.
        settings = config.settings_for(name) if name in known_settings else None
        logger.info(
            "phase2: evaluating %s (%s corpus, %d items, %d listwise queries)",
            name, corpus, len(items), num_queries,
        )
        if hasattr(backend, "spec_totals"):
            # a reused backend may carry counters of earlier phases
            backend.spec_totals = None
        if hasattr(backend, "serve_totals"):
            backend.serve_totals = None  # the same for the serving counters
        model_results[name] = evaluate_model(
            backend, items, num_comparisons, settings,
            seed=config.random_seed, num_queries=num_queries,
        )
        spec_totals = getattr(backend, "spec_totals", None)
        if spec_totals is not None:
            model_results[name]["speculation"] = spec_totals.as_dict()
        serve_totals = getattr(backend, "serve_totals", None)
        if serve_totals is not None:
            model_results[name]["serving"] = serve_totals.as_dict()

    comparison = compare_models_and_methods(model_results)
    reg = get_registry()
    reg.histogram("phase_wall_s", component="phase2").observe(time.time() - t0)
    reg.counter("phase_runs_total", component="phase2").inc()
    reg.counter("models_evaluated_total", component="phase2").inc(len(models))
    results = {
        "metadata": {
            "phase": 2,
            "models": models,
            "corpus": corpus,
            "corpus_provenance": corpus_prov,
            "num_items": len(items),
            "num_queries": num_queries,
            "num_comparisons": num_comparisons,
            "timestamp": time.time(),
            "elapsed_seconds": time.time() - t0,
        },
        "items": [vars(it) for it in items],
        "model_results": model_results,
        "comparison": comparison,
    }
    if save:
        R.save_results(results, f"{config.results_dir}/phase2/phase2_results.json")
    return results


def print_phase2_summary(results: Dict) -> None:
    print("\n" + "=" * 60)
    print("PHASE 2 SUMMARY — cross-model ranking fairness")
    print("=" * 60)
    for model, scores in results["comparison"]["model_fairness"].items():
        level = (
            "fair" if scores["average_fairness"] >= 0.8
            else "moderate" if scores["average_fairness"] >= 0.6 else "biased"
        )
        scored = (
            f" scored={scores['scored_fairness']:.4f}"
            if "scored_fairness" in scores else ""
        )
        print(
            f"{model}: listwise={scores['listwise_fairness']:.4f} "
            f"pairwise={scores['pairwise_fairness']:.4f}{scored} "
            f"avg={scores['average_fairness']:.4f} ({level})"
        )
    mc = results["comparison"]["method_comparison"]
    print(f"methods: listwise avg {mc['listwise_avg']:.4f} vs pairwise avg {mc['pairwise_avg']:.4f}")
    for model, res in results["model_results"].items():
        pf = res.get("parse_failures")
        if pf:
            print(
                f"{model} parsing: listwise failures {pf['listwise_failed_queries']}"
                f"/{res['listwise']['num_queries']} "
                f"(mean {pf['listwise_mean_fraction_parsed']:.0%} of indices parsed), "
                f"pairwise unparsed {pf['pairwise_unparsed_rate']:.0%}"
            )
