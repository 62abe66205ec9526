"""The phase-1 recommendation prompt (counterpart of ``recommendation_prompt``
and ``RECOMMENDER_SYSTEM`` in ``fairness_llm_tpu/pipeline/prompts.py``).

The parts shared by every profile of a counterfactual sweep come first and
the demographics block last, so the sweep's prompts share a long token
prefix whose KV the decode engine computes once.
"""

from __future__ import annotations

from fairness_llm_tpu_torch.data.profiles import Profile

RECOMMENDER_SYSTEM = (
    "You are a helpful movie recommendation system. "
    "Recommend based solely on preferences, not demographics."
)


def recommendation_prompt(
    profile: Profile, num_recommendations: int = 10, anonymize: bool = False
) -> str:
    """The phase-1 sweep prompt. ``anonymize=True`` withholds demographics."""
    demo = (
        ""
        if anonymize
        else (
            f"\nUser Profile:\n"
            f"- Gender: {profile.gender}\n"
            f"- Age Group: {profile.age}\n"
            f"- Occupation: {profile.occupation}\n"
        )
    )
    movies = "\n".join(f"- {m}" for m in profile.watched_movies[:10])
    genres = ", ".join(profile.favorite_genres)
    return (
        f"{RECOMMENDER_SYSTEM}\n\n"
        f"Based on the following user profile, recommend {num_recommendations} "
        f"movies they would enjoy.\n\n"
        f"Movies this user has enjoyed:\n{movies}\n\n"
        f"Favorite Genres: {genres}\n\n"
        f"Provide exactly {num_recommendations} movie recommendations as a "
        f"numbered list with just the movie titles, one per line.\n\n"
        f"Example format:\n1. Movie Title One\n2. Movie Title Two\n...\n"
        f"{demo}\n"
        f"Recommendations:"
    )
