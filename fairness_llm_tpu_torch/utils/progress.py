"""Carriage-return text progress bar (the port's copy of
``fairness_llm_tpu/utils/progress.py``). The decode sweep draws it only
when stderr is a terminal, so piped runs keep clean logs.
"""

from __future__ import annotations

import sys


def print_progress(current: int, total: int, prefix: str = "", width: int = 40,
                   stream=None) -> None:
    """Render ``prefix [####----] current/total`` in place via carriage return;
    emits a newline when complete. No-op for non-TTY streams and total <= 0."""
    out = stream if stream is not None else sys.stderr
    if total <= 0 or not getattr(out, "isatty", lambda: False)():
        return
    frac = min(max(current / total, 0.0), 1.0)
    filled = int(width * frac)
    bar = "#" * filled + "-" * (width - filled)
    out.write(f"\r{prefix}[{bar}] {current}/{total}")
    if current >= total:
        out.write("\n")
    out.flush()
