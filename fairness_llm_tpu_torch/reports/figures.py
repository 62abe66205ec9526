"""The study's figures over saved phase results (counterpart of
``fairness_llm_tpu/reports/figures.py``): the three phase-1 figures
(fairness overview, gender divergences with the parity panel, SNSR/SNSV
group similarity), the phase-2 exposure-ratio figure and the phase-3
before/after mitigation figure, drawn as the reference draws them.

matplotlib is imported inside each function (headless, ``Agg``): the card's
machine has none, and the CLI then logs that the figures were skipped.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

logger = logging.getLogger(__name__)

_FAIR, _MODERATE = 0.8, 0.7  # the reference notebook's thresholds


def generate_phase1_figures(results: Dict, out_dir: str) -> List[str]:
    """Render the three phase-1 figures; returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    m = results["metrics"]
    written = []

    # 1. fairness overview bars
    names = ["DP (gender)", "DP (age)", "Individual", "Equal opp."]
    scores = [
        m["demographic_parity_gender"]["score"],
        m["demographic_parity_age"]["score"],
        m["individual_fairness"]["score"],
        m["equal_opportunity"]["score"],
    ]
    fig, ax = plt.subplots(figsize=(8, 5))
    colors = ["#2a9d8f" if s >= _FAIR else "#e9c46a" if s >= _MODERATE else "#e76f51"
              for s in scores]
    ax.bar(names, scores, color=colors)
    ax.axhline(_FAIR, ls="--", c="gray", lw=1, label=f"fair ({_FAIR})")
    ax.axhline(_MODERATE, ls=":", c="gray", lw=1, label=f"moderate ({_MODERATE})")
    ax.set_ylim(0, 1.05)
    ax.set_ylabel("score")
    ax.set_title(f"Fairness overview — {results['metadata']['model']}")
    ax.legend()
    path = os.path.join(out_dir, "fairness_overview.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    # 2. gender divergences histogram + parity bar
    divs = m["demographic_parity_gender"].get("divergences", [])
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    if divs:
        axes[0].hist(divs, bins=min(10, max(3, len(divs))), color="#264653")
    axes[0].set_title("Pairwise JS distance between gender groups")
    axes[0].set_xlabel("JS distance")
    axes[1].bar(
        ["gender", "age"],
        [m["demographic_parity_gender"]["score"], m["demographic_parity_age"]["score"]],
        color="#2a9d8f",
    )
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title("Demographic parity")
    path = os.path.join(out_dir, "gender_analysis.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    # 3. SNSR/SNSV per-group similarity (a record without an snsr_snsv block
    # draws empty bars)
    sns = m.get("snsr_snsv", {})
    sims = sns.get("group_similarities", {})
    fig, ax = plt.subplots(figsize=(8, 4.5))
    if sims:
        ax.bar(list(sims.keys()), list(sims.values()), color="#457b9d")
    ax.set_ylim(0, 1.05)
    ax.set_title(
        f"Sensitive-to-neutral similarity (SNSR={sns.get('snsr', float('nan')):.3f}, "
        f"SNSV={sns.get('snsv', float('nan')):.3f})"
    )
    path = os.path.join(out_dir, "snsr_similarity.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    logger.info("wrote %d figures to %s", len(written), out_dir)
    return written


def generate_phase2_figure(results: Dict, out_dir: str) -> str:
    """Per-model listwise/pairwise exposure-ratio bars and the first model's
    per-group listwise exposure; returns the written path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    mf = results["comparison"]["model_fairness"]
    models = list(mf.keys())
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    x = range(len(models))
    w = 0.35
    axes[0].bar([i - w / 2 for i in x], [mf[m]["listwise_fairness"] for m in models],
                w, label="listwise", color="#2a9d8f")
    axes[0].bar([i + w / 2 for i in x], [mf[m]["pairwise_fairness"] for m in models],
                w, label="pairwise", color="#457b9d")
    axes[0].set_xticks(list(x))
    axes[0].set_xticklabels(models, rotation=15)
    axes[0].axhline(_FAIR, ls="--", c="gray", lw=1)
    axes[0].set_ylim(0, 1.05)
    axes[0].set_title("Exposure ratio by model and method")
    axes[0].legend()

    # per-group exposure for the first model (means over queries)
    first = results["model_results"][models[0]]["listwise"]["group_exposure"]
    axes[1].bar(list(first.keys()), list(first.values()), color="#264653")
    axes[1].set_title(f"Listwise group exposure — {models[0]}")
    path = os.path.join(out_dir, "phase2_ranking_fairness.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    logger.info("wrote %s", path)
    return path


def generate_phase3_figure(results: Dict, out_dir: str) -> str:
    """Before/after mitigation bars (fairness, quality); returns the written
    path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    b = results["bias_reduction"]
    q = results["quality_preservation"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    axes[0].bar(
        ["before", "after"],
        [b["original_fairness"], b["mitigated_fairness"]],
        color=["#e76f51", "#2a9d8f"],
    )
    axes[0].set_ylim(0, 1.05)
    axes[0].set_title(
        f"Demographic parity — bias reduced {b['bias_reduction_rate']:.1f}%"
    )
    axes[1].bar(
        ["quality preserved"], [q["quality_preservation_pct"]], color="#457b9d"
    )
    axes[1].set_ylim(0, 105)
    axes[1].set_title(f"Quality preservation ({q['num_comparisons']} profiles)")
    variant = results["metadata"]["variant"]
    path = os.path.join(out_dir, f"phase3_{variant}_mitigation.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    logger.info("wrote %s", path)
    return path
