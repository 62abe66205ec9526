"""Response parsing + title canonicalization (the port's copy of
``fairness_llm_tpu/pipeline/parsing.py``, which is pure Python).

Ported so far: the numbered-list parser the phase-1 sweep uses and the
title canonicalisation its metrics match on (``canonical_title`` strips
year suffixes and articles; the reference compares raw strings, which makes
its Equal Opportunity metric vacuously 1.0, SURVEY.md §8.2).
"""

from __future__ import annotations

import re
from typing import List, Sequence

_NUMBERED = re.compile(r"^\s*(\d+)[\.\)\:]\s*(.+?)\s*$")
_YEAR_SUFFIX = re.compile(r"\s*\((19|20)\d{2}\)\s*$")


def _clean_item(text: str) -> str:
    """Per-item cleanup: whitespace, wrapping quotes, and markdown ``*``
    emphasis (models bold titles as ``**Title**``)."""
    return text.strip().strip('"').strip("*").strip()


def parse_numbered_list(text: str, max_items: int = 10) -> List[str]:
    """'1. Title' lines -> titles (reference numbered-list contract)."""
    out: List[str] = []
    for line in text.splitlines():
        m = _NUMBERED.match(line)
        if m:
            title = _clean_item(m.group(2))
            if title:
                out.append(title)
        if len(out) >= max_items:
            break
    return out


def canonical_title(title: str) -> str:
    """Normalize a movie title for set matching: strip year, articles, case."""
    t = _YEAR_SUFFIX.sub("", title.strip())
    t = re.sub(r"\s+", " ", t)
    # ML-1M style 'Matrix, The' -> 'The Matrix'
    m = re.match(r"^(.*),\s+(The|A|An)$", t, flags=re.IGNORECASE)
    if m:
        t = f"{m.group(2)} {m.group(1)}"
    return t.casefold()


def canonicalize(titles: Sequence[str]) -> List[str]:
    return [canonical_title(t) for t in titles]
