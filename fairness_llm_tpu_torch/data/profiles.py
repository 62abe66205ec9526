"""The counterfactual user profile (counterpart of the ``Profile`` dataclass in
``fairness_llm_tpu/data/profiles.py``; the MovieLens-driven grid builders
are not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


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
