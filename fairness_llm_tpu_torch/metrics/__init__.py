"""Fairness metrics over interned recommendation lists: ``encode`` interns
titles into ids, ``divergence`` and ``fairness`` hold the kernels (plain
torch ops on float32 tensors) and their dict-of-strings wrappers."""
