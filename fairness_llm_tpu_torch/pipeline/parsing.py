"""Response parsing + title canonicalization (the port's copy of
``fairness_llm_tpu/pipeline/parsing.py``, which is pure Python).

The numbered-list and comma-list parsers of the recommendation replies,
the ranking-index and A/B parsers of phase 2 (each also says whether the
reply parsed at all, for the parse-failure report), and the title
canonicalisation the metrics match on (``canonical_title`` strips year
suffixes and articles; the reference compares raw strings, which makes its
Equal Opportunity metric vacuously 1.0, SURVEY.md §8.2).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

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


def parse_comma_list(text: str, max_items: int = 10) -> List[str]:
    """Comma-separated titles on the first non-empty line."""
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        items = [_clean_item(t) for t in line.split(",")]
        return [t for t in items if t][:max_items]
    return []


def parse_ranking_indices(text: str, num_items: int) -> List[int]:
    """Comma-separated 1-based indices -> 0-based ranking; invalid entries are
    dropped and unranked items appended in their original order."""
    return parse_ranking_indices_with_count(text, num_items)[0]


def parse_ranking_indices_with_count(text: str, num_items: int) -> Tuple[List[int], int]:
    """``parse_ranking_indices`` and how many indices the reply gave before
    the unranked tail was appended (0: the reply did not parse)."""
    seen = set()
    ranking: List[int] = []
    for tok in re.split(r"[,\s]+", text.strip()):
        # isascii(): str.isdigit() accepts "²" or "①", which int() refuses
        if not (tok.isascii() and tok.isdigit()):
            continue
        idx = int(tok) - 1
        if 0 <= idx < num_items and idx not in seen:
            ranking.append(idx)
            seen.add(idx)
    parsed = len(ranking)
    for i in range(num_items):
        if i not in seen:
            ranking.append(i)
    return ranking, parsed


def parse_pairwise_answer_full(text: str) -> Tuple[str, bool]:
    """A comparison reply -> ('A' | 'B' | 'tie', parsed). ``parsed`` is False
    when neither choice appears, which tells an unparseable reply from a
    reply that names both."""
    up = text.strip().upper()
    # whole words only: "ANSWER: B" holds no choice A
    has_a = bool(re.search(r"\bA\b", up))
    has_b = bool(re.search(r"\bB\b", up))
    if has_a and not has_b:
        return "A", True
    if has_b and not has_a:
        return "B", True
    return "tie", has_a or has_b


def parse_pairwise_answer(text: str) -> str:
    """A comparison reply -> 'A' | 'B' | 'tie'."""
    return parse_pairwise_answer_full(text)[0]


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
