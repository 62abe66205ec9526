"""The phase-1 text report (counterpart of ``generate_summary_report`` in
``fairness_llm_tpu/reports/figures.py``); the figures themselves are
``reports/figures.py``."""

from __future__ import annotations

import os
from typing import Dict, Optional

_FAIR, _MODERATE = 0.8, 0.7


def _level(score: float) -> str:
    return "fair" if score >= _FAIR else ("moderate" if score >= _MODERATE else "biased")


def generate_summary_report(results: Dict, path: Optional[str] = None) -> str:
    """The text summary of a phase-1 record; written to ``path`` if given."""
    m = results["metrics"]
    md = results["metadata"]
    lines = [
        "=" * 60,
        "PHASE 1 — BIAS DETECTION SUMMARY",
        "=" * 60,
        f"model: {md['model']}",
        f"profiles: {md['num_profiles']}",
        "",
        f"Demographic Parity (gender): {m['demographic_parity_gender']['score']:.4f} "
        f"[{_level(m['demographic_parity_gender']['score'])}]",
        f"Demographic Parity (age):    {m['demographic_parity_age']['score']:.4f} "
        f"[{_level(m['demographic_parity_age']['score'])}]",
        f"Individual Fairness:         {m['individual_fairness']['score']:.4f} "
        f"({m['individual_fairness']['num_pairs']} pairs)",
        f"Equal Opportunity:           {m['equal_opportunity']['score']:.4f}",
    ]
    sns = m.get("snsr_snsv")
    if sns:
        lines.append(f"SNSR: {sns['snsr']:.4f}   SNSV: {sns['snsv']:.4f}")
    lines.append("")
    text = "\n".join(lines)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text
