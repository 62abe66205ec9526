"""The counterfactual user-profile grid (the port's copy of
``fairness_llm_tpu/data/profiles.py``, which is pure Python and numpy).

One shared base preference set (10 highly rated popular movies and the top
3 genres) swept over {gender} x {age} x N with occupation held constant, so
any variation in the model's output across profiles comes from the
sensitive attributes alone.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from fairness_llm_tpu_torch.config import Config
from fairness_llm_tpu_torch.data.movielens import MovieLensData

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Profile:
    """One synthetic user."""

    id: str
    gender: str
    age: str
    occupation: str
    watched_movies: List[str]
    favorite_genres: List[str]
    avg_rating: float = 4.5

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "gender": self.gender,
            "age": self.age,
            "occupation": self.occupation,
            "preferences": {
                "watched_movies": list(self.watched_movies),
                "favorite_genres": list(self.favorite_genres),
                "avg_rating": self.avg_rating,
            },
        }


def create_base_preferences(
    data: MovieLensData,
    num_movies: int = 10,
    seed: int = 42,
    min_avg_rating: float = 4.0,
    min_num_ratings: int = 100,
) -> Dict:
    """Pick ``num_movies`` highly rated, popular movies + top-3 genres.

    Mirrors reference ``create_base_preferences`` (``phase1_bias_detection.py:76-115``):
    filter avg rating >= 4.0 and >= 100 ratings, seeded sample, genre histogram.
    If the filter empties the pool (small/synthetic corpora), thresholds relax by
    halving the count floor until movies qualify.
    """
    # Per-movie mean rating and count via bincount on dense re-indexed ids.
    uniq, inverse = np.unique(data.rating_movie_ids, return_inverse=True)
    counts = np.bincount(inverse).astype(np.float64)
    sums = np.bincount(inverse, weights=data.rating_values.astype(np.float64))
    means = sums / np.maximum(counts, 1)

    floor = min_num_ratings
    qualified = uniq[(means >= min_avg_rating) & (counts >= floor)]
    while len(qualified) < num_movies and floor > 1:
        floor = max(1, floor // 2)
        qualified = uniq[(means >= min_avg_rating) & (counts >= floor)]
    if len(qualified) == 0:
        qualified = uniq  # degenerate corpus: take anything rated

    rng = np.random.default_rng(seed)
    chosen = rng.choice(qualified, size=min(num_movies, len(qualified)), replace=False)

    title_of = data.title_of()
    genres_of = data.genres_of()
    watched = [title_of[int(m)] for m in chosen if int(m) in title_of]

    genre_counts: Dict[str, int] = {}
    for m in chosen:
        for g in genres_of.get(int(m), []):
            genre_counts[g] = genre_counts.get(g, 0) + 1
    favorite = [g for g, _ in sorted(genre_counts.items(), key=lambda kv: (-kv[1], kv[0]))[:3]]

    return {"watched_movies": watched, "favorite_genres": favorite, "avg_rating": 4.5}


def create_profile_grid(
    base_preferences: Dict,
    config: Config,
    num_profiles_per_combination: Optional[int] = None,
) -> List[Profile]:
    """The counterfactual grid: genders x age_groups x N, occupation constant
    (reference ``create_synthetic_profiles``, ``phase1_bias_detection.py:117-140``).

    Default grid is 3 genders x 5 age groups x 3 = 45 profiles.
    """
    n = num_profiles_per_combination or config.profiles_per_combo
    profiles: List[Profile] = []
    pid = 0
    for gender in config.genders:
        for age in config.age_groups:
            for _ in range(n):
                profiles.append(
                    Profile(
                        id=f"user_{pid:04d}",
                        gender=gender,
                        age=age,
                        occupation=config.occupation,
                        watched_movies=list(base_preferences["watched_movies"]),
                        favorite_genres=list(base_preferences["favorite_genres"]),
                        avg_rating=base_preferences.get("avg_rating", 4.5),
                    )
                )
                pid += 1
    logger.info("Created %d counterfactual profiles", len(profiles))
    return profiles


def profile_pairs(
    profiles: Sequence[Profile], differing_attribute: Optional[str] = None
) -> List[tuple]:
    """Pairs of profiles differing in exactly one sensitive attribute
    (reference ``utils.create_profile_pairs``, ``utils.py:327-347``).

    Used by individual-fairness: similar individuals (all but one attribute equal)
    should get similar recommendations.
    """
    pairs = []
    attrs = ("gender", "age", "occupation")
    for i, p1 in enumerate(profiles):
        for p2 in profiles[i + 1 :]:
            diffs = [a for a in attrs if getattr(p1, a) != getattr(p2, a)]
            if len(diffs) == 1 and (differing_attribute is None or differing_attribute in diffs):
                pairs.append((p1.id, p2.id))
    return pairs
