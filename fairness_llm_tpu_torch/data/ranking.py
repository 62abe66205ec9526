"""Ranking corpora for phase 2 (the port's copy of
``fairness_llm_tpu/data/ranking.py``, which is pure numpy).

- ``create_synthetic_ranking_data``: the reference study's "Document i"
  items with a seeded protected attribute in {male, female} and a relevance
  in [0.3, 1.0].
- ``movielens_ranking_corpus``: the most-rated MovieLens movies, relevance
  from the mean rating, the protected attribute from the genre class.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from fairness_llm_tpu_torch.data.movielens import MovieLensData


@dataclasses.dataclass
class RankingItem:
    id: int
    text: str
    protected_attribute: str  # group label; synthetic: "male" | "female"
    relevance: float
    genres: tuple = ()  # MovieLens corpus only


def create_synthetic_ranking_data(num_items: int = 20, seed: int = 42) -> List[RankingItem]:
    """Items to rank, each with a protected group and a true relevance."""
    rng = np.random.default_rng(seed)
    return [
        RankingItem(
            id=i,
            text=f"Document {i}: A relevant document about topic {i % 5}",
            protected_attribute=str(rng.choice(["male", "female"])),
            relevance=float(rng.uniform(0.3, 1.0)),
        )
        for i in range(num_items)
    ]


# A movie's group is the genre class that holds more of its genres; an exact
# tie takes a seeded coin flip. The split is a proxy, not a demographic claim
# about the films.
GENRE_CLASS_A = ("Drama", "Romance", "Musical", "Children's", "Animation", "Comedy")
GENRE_CLASS_B = ("Action", "Thriller", "Sci-Fi", "War", "Western", "Crime", "Horror", "Film-Noir")
GROUP_A_LABEL = "drama-romance"
GROUP_B_LABEL = "action-thriller"


def movielens_ranking_corpus(
    data: MovieLensData,
    num_items: int = 100,
    seed: int = 42,
    min_ratings: int = 20,
) -> List[RankingItem]:
    """The ``num_items`` most-rated movies with at least ``min_ratings``
    ratings (ties by movie id); relevance is the mean rating mapped from
    [1, 5] onto [0.3, 1.0]."""
    max_id = int(data.movie_ids.max()) + 1
    counts = np.bincount(data.rating_movie_ids, minlength=max_id)
    sums = np.bincount(data.rating_movie_ids, weights=data.rating_values, minlength=max_id)

    eligible = [
        (int(counts[mid]), int(mid), i)
        for i, mid in enumerate(data.movie_ids)
        # an unrated movie has no mean rating, whatever min_ratings says
        if counts[mid] >= min_ratings and counts[mid] > 0
    ]
    eligible.sort(key=lambda t: (-t[0], t[1]))
    chosen = eligible[:num_items]

    rng = np.random.default_rng(seed)
    set_a, set_b = set(GENRE_CLASS_A), set(GENRE_CLASS_B)
    items = []
    for count, mid, row in chosen:
        mean_rating = float(sums[mid]) / count
        relevance = 0.3 + 0.7 * (np.clip(mean_rating, 1.0, 5.0) - 1.0) / 4.0
        genres = data.genres[row]
        a, b = len(set_a.intersection(genres)), len(set_b.intersection(genres))
        if a > b:
            group = GROUP_A_LABEL
        elif b > a:
            group = GROUP_B_LABEL
        else:
            group = GROUP_A_LABEL if rng.random() < 0.5 else GROUP_B_LABEL
        items.append(
            RankingItem(
                id=mid,
                text=f"{data.titles[row]} [{'|'.join(genres)}]",
                protected_attribute=group,
                relevance=float(relevance),
                genres=tuple(genres),
            )
        )
    return items
