"""MovieLens-1M loading (the port's copy of
``fairness_llm_tpu/data/movielens.py``, which is pure Python and numpy).

File formats (latin-1):

- ``movies.dat``:  ``movie_id::title (year)::Genre1|Genre2``
- ``ratings.dat``: ``user_id::movie_id::rating::timestamp``

Three modes: all tables from disk; the real catalog with seeded synthetic
ratings when ``ratings.dat`` is absent (the repo ships ``movies.dat``
only); a seeded synthetic corpus when ``movies.dat`` is absent too.
``ratings.dat`` goes through the native C parser (``native/``, built on
first use) and through the pure-Python parse, with the same arrays, where
no compiler is available. ``data/download.py`` fetches the three tables.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MovieLensData:
    """Columnar MovieLens tables.

    ``movie_ids``/``titles``/``genres`` are aligned; ratings are parallel arrays of
    int32/float32 so downstream aggregation is vectorized numpy, not row loops.
    """

    movie_ids: np.ndarray  # int32 [M]
    titles: List[str]  # [M]
    genres: List[List[str]]  # [M]
    rating_user_ids: np.ndarray  # int32 [R]
    rating_movie_ids: np.ndarray  # int32 [R]
    rating_values: np.ndarray  # float32 [R]
    synthetic: bool = False
    # "real" (all tables from disk) | "real-catalog+synthetic-ratings" (the
    # committed-snapshot mode: movies.dat/users.dat are the true ML-1M
    # tables, ratings seeded-synthetic over the real ids) | "synthetic"
    source: str = "real"

    @property
    def num_movies(self) -> int:
        return len(self.movie_ids)

    @property
    def num_ratings(self) -> int:
        return len(self.rating_values)

    def provenance(self) -> Dict[str, object]:
        """Corpus identity for result metadata — committed records pin THIS
        (source + table sizes) instead of requiring the data to be absent."""
        return {
            "source": self.source,
            "num_movies": int(self.num_movies),
            "num_ratings": int(self.num_ratings),
        }

    def title_of(self) -> Dict[int, str]:
        return dict(zip(self.movie_ids.tolist(), self.titles))

    def genres_of(self) -> Dict[int, List[str]]:
        return dict(zip(self.movie_ids.tolist(), self.genres))


def _parse_dat(path: str, encoding: str = "latin-1") -> List[List[str]]:
    """Parse a ``::``-separated .dat file into rows of string fields (pure
    Python — used for the small string tables like movies.dat)."""
    rows = []
    with open(path, "r", encoding=encoding) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                rows.append(line.split("::"))
    return rows


def _parse_ratings(path: str):
    """Parse the 1M-row numeric ratings table into (users, movies, ratings)
    arrays: the native C parser when it builds (``native/``), pure Python
    otherwise."""
    try:
        from fairness_llm_tpu_torch import native

        out = native.parse_ratings(path)
        if out is not None:
            return out
    except Exception as e:  # noqa: BLE001 — never let the fast path break loading
        logger.info("native ratings parse failed (%s); falling back", e)
    rows = _parse_dat(path)
    return (
        np.array([int(r[0]) for r in rows], dtype=np.int32),
        np.array([int(r[1]) for r in rows], dtype=np.int32),
        np.array([float(r[2]) for r in rows], dtype=np.float32),
    )


def load_movielens(data_dir: str, allow_synthetic: bool = True, seed: int = 42) -> MovieLensData:
    """Load MovieLens-1M from ``data_dir`` (movies.dat / ratings.dat required).

    ``users.dat`` is intentionally unused: the pipeline builds *synthetic*
    counterfactual users (reference behavior — ``users.dat`` is loaded but never
    consumed downstream of ``load_movielens_data``).

    Missing movies.dat triggers the fully-synthetic fallback (reference
    ``run_phase1``/``phase1_bias_detection.py:288-306``); movies.dat present
    but ratings.dat missing triggers the MIXED mode (real catalog + seeded
    synthetic ratings). ``allow_synthetic=False`` demands the fully-real
    corpus and raises in both fallback cases.
    """
    movies_path = os.path.join(data_dir, "movies.dat")
    ratings_path = os.path.join(data_dir, "ratings.dat")

    if not os.path.exists(movies_path):
        if not allow_synthetic:
            raise FileNotFoundError(f"MovieLens data not found under {data_dir}")
        logger.warning("MovieLens data missing under %s — using synthetic fallback", data_dir)
        return synthetic_movielens(seed=seed)

    movie_rows = _parse_dat(movies_path)
    movie_ids = np.array([int(r[0]) for r in movie_rows], dtype=np.int32)
    titles = [r[1] for r in movie_rows]
    genres = [r[2].split("|") for r in movie_rows]

    if os.path.exists(ratings_path):
        r_users, r_movies, r_values = _parse_ratings(ratings_path)
        source = "real"
    elif not allow_synthetic:
        # Strict callers demand the fully-real corpus: substituted ratings
        # (however seeded) are still synthetic data.
        raise FileNotFoundError(f"ratings.dat not found under {data_dir}")
    else:
        # Mixed mode: the REAL catalog (movies.dat ships in the snapshot;
        # only the 24 MB ratings.dat is stripped) with seeded synthetic
        # ratings over the real movie ids — real titles exercise the
        # canonicalizer and real genres drive the phase-2 queries, while the
        # substituted table follows the reference's ratings schema
        # (phase1_bias_detection.py:40-46) and stays deterministic.
        logger.warning(
            "ratings.dat missing under %s — real catalog (%d movies) with "
            "seeded synthetic ratings", data_dir, len(movie_ids),
        )
        r_users, r_movies, r_values = synthetic_ratings(movie_ids, seed=seed)
        source = "real-catalog+synthetic-ratings"

    logger.info("Loaded MovieLens: %d movies, %d ratings", len(movie_ids), len(r_values))
    return MovieLensData(
        movie_ids, titles, genres, r_users, r_movies, r_values, source=source
    )


# Genre pool for the synthetic corpus (the 18 MovieLens-1M genres).
_GENRES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]


def synthetic_ratings(
    movie_ids: np.ndarray,
    num_users: int = 6040,
    ratings_per_user: int = 165,
    seed: int = 42,
):
    """Seeded ratings over a given (real) movie-id catalog.

    Defaults match ML-1M's true proportions (6,040 users, ~1M ratings —
    ~257 per movie on the 3,883-movie catalog), so downstream popularity
    filters (phase-2's ``min_ratings=20``) behave as they would on the real
    table. Same generative shape as the fully-synthetic corpus: a random
    third of the catalog is "good" (skewed >= 4.0) so the quality filter
    keeps a nontrivial pool.
    """
    rng = np.random.default_rng(seed)
    r_users = np.repeat(np.arange(1, num_users + 1, dtype=np.int32), ratings_per_user)
    r_movies = rng.choice(movie_ids, size=num_users * ratings_per_user).astype(np.int32)
    good = rng.choice(movie_ids, size=max(1, len(movie_ids) // 3), replace=False)
    is_good = np.isin(r_movies, good)
    r_values = np.where(
        is_good,
        rng.choice([4.0, 4.5, 5.0], size=r_users.shape),
        rng.choice([2.0, 2.5, 3.0, 3.5, 4.0], size=r_users.shape),
    ).astype(np.float32)
    return r_users, r_movies, r_values


def synthetic_movielens(
    num_movies: int = 200,
    num_users: int = 200,
    ratings_per_user: int = 40,
    seed: int = 42,
) -> MovieLensData:
    """Seeded synthetic stand-in for MovieLens-1M.

    The reference builds a 100-movie/100-rating frame on ``FileNotFoundError``
    (``phase1_bias_detection.py:294-306``); this version is larger and fully seeded
    so tests and the quick path are deterministic.
    """
    rng = np.random.default_rng(seed)
    movie_ids = np.arange(1, num_movies + 1, dtype=np.int32)
    years = rng.integers(1950, 2001, size=num_movies)
    titles = [f"Synthetic Movie {i} ({y})" for i, y in zip(movie_ids, years)]
    genres = [
        sorted(rng.choice(_GENRES, size=rng.integers(1, 4), replace=False).tolist())
        for _ in range(num_movies)
    ]

    r_users = np.repeat(np.arange(1, num_users + 1, dtype=np.int32), ratings_per_user)
    r_movies = rng.choice(movie_ids, size=num_users * ratings_per_user).astype(np.int32)
    # Skew ratings high for a subset of "good" movies so the quality filter
    # (avg >= 4.0, >= min_ratings) keeps a nontrivial pool.
    good = rng.choice(movie_ids, size=num_movies // 3, replace=False)
    is_good = np.isin(r_movies, good)
    r_values = np.where(
        is_good,
        rng.choice([4.0, 4.5, 5.0], size=r_users.shape),
        rng.choice([2.0, 2.5, 3.0, 3.5, 4.0], size=r_users.shape),
    ).astype(np.float32)

    return MovieLensData(movie_ids, titles, genres, r_users, r_movies, r_values, synthetic=True)
