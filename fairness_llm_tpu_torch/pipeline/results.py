"""Result persistence (the port's copy of
``fairness_llm_tpu/pipeline/results.py``): JSON writers and readers with the
reference's record shapes, atomic writes with a manifest entry each, and
checkpoint/resume for the decode sweep.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.integrity.manifest import update_manifest_entry, verify_manifest_entry

logger = logging.getLogger(__name__)


def _sanitize_non_finite(obj: Any, path: str = "") -> Tuple[Any, List[str]]:
    """Copy ``obj`` with NaN/Inf floats replaced by None, returning the
    dotted paths of every replacement. Fairness metrics CAN legitimately be
    NaN (an empty demographic group divides by zero), and ``json.dump``'s
    default ``allow_nan=True`` would emit bare ``NaN`` tokens — not JSON,
    rejected by every strict parser downstream (jq, browsers, pandas with
    default settings). Fresh containers throughout: the caller's in-memory
    dict is never mutated. ``np.float64`` subclasses ``float``, so numpy
    scalars are covered; non-float types json can't encode still fall to
    ``default=str`` as before."""
    if isinstance(obj, dict):
        bad: List[str] = []
        out: Dict = {}
        for k, v in obj.items():
            sv, sb = _sanitize_non_finite(v, f"{path}.{k}" if path else str(k))
            out[k] = sv
            bad.extend(sb)
        return out, bad
    if isinstance(obj, (list, tuple)):
        bad = []
        items = []
        for i, v in enumerate(obj):
            sv, sb = _sanitize_non_finite(v, f"{path}[{i}]")
            items.append(sv)
            bad.extend(sb)
        return items, bad
    if isinstance(obj, float) and not math.isfinite(obj):
        return None, [path or "<root>"]
    return obj, []


def save_results(results: Dict[str, Any], path: str, manifest: bool = True) -> None:
    """Atomic-rename write: a PROCESS interrupt mid-write leaves the previous
    file intact (resume depends on it). fsync before rename extends that to
    most system-crash orderings too, though no rename dance is a durability
    guarantee across power loss — the resume loader's corrupt-file fallback
    is the final backstop.

    Non-finite floats are sanitized to ``null`` (strict-JSON output; the
    sanitized key paths are recorded in the result's ``metadata``), and the
    written file's sha256 lands in the directory's ``manifest.json``
    (``integrity/manifest.py``) so resume can refuse a corrupted artifact.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    results, sanitized = _sanitize_non_finite(results)
    if sanitized:
        md = results.get("metadata")
        if isinstance(md, dict):
            md["sanitized_non_finite"] = sanitized
        else:
            results["sanitized_non_finite"] = sanitized
        logger.warning(
            "results %s: %d non-finite value(s) sanitized to null (%s%s)",
            path, len(sanitized), ", ".join(sanitized[:5]),
            "…" if len(sanitized) > 5 else "",
        )
    # Per-pid tmp name: concurrent writers (multi-host ranks, pytest -n) must
    # not truncate each other's in-flight tmp before its atomic rename.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            # allow_nan=False as a regression guard: any non-finite float
            # that slips past sanitization fails HERE, loudly, instead of
            # writing a file strict parsers reject.
            json.dump(results, f, indent=2, default=str, allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:  # noqa: BLE001 — incl. KeyboardInterrupt: no tmp litter
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if manifest:
        # The rename above and this manifest update are two separate atomic
        # writes, so a kill between them (or a cross-process read-modify-
        # write race on manifest.json) can leave a STALE digest for a valid
        # file. That window is accepted deliberately: a stale entry makes
        # the loader skip to the next-older valid checkpoint — bounded
        # recompute — whereas trusting a mismatched digest would reopen the
        # silent-corruption hole this manifest exists to close. (A dropped
        # entry from the RMW race is harmless: unlisted files verify
        # trivially.)
        update_manifest_entry(os.path.dirname(path) or ".",
                              os.path.basename(path))
    logger.info("saved results to %s", path)


def load_results(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def checkpoint_path(results_dir: str, phase: str, n: int) -> str:
    return os.path.join(results_dir, phase, f"{phase}_checkpoint_{n}.json")


def save_checkpoint(recs: Dict[str, Any], results_dir: str, phase: str, n: int) -> None:
    save_results(
        {"completed": n, "timestamp": time.time(), "recommendations": recs},
        checkpoint_path(results_dir, phase, n),
    )


def load_latest_checkpoint(results_dir: str, phase: str) -> Dict[str, Any]:
    """Resume support the reference lacks: find the newest checkpoint's recs."""
    d = os.path.join(results_dir, phase)
    if not os.path.isdir(d):
        return {}
    numbered = []
    for fname in os.listdir(d):
        if fname.startswith(f"{phase}_checkpoint_") and fname.endswith(".json"):
            try:
                n = int(fname[len(f"{phase}_checkpoint_"):-len(".json")])
            except ValueError:
                continue
            numbered.append((n, fname))
    # Newest first; fall back through older checkpoints if one is unreadable
    # (writes are atomic now, but checkpoints from older versions — or a
    # filesystem mishap — shouldn't make resume WORSE than starting over).
    for _, fname in sorted(numbered, reverse=True):
        if not verify_manifest_entry(d, fname, kind="results"):
            # Parses fine, WRONG BYTES: a digest mismatch means corruption
            # the JSON layer can't see (a flipped digit in a metric is
            # still valid JSON). Same ladder as an unreadable file — the
            # next-older valid checkpoint wins over resuming garbage.
            logger.warning(
                "skipping checkpoint %s: manifest digest mismatch", fname
            )
            continue
        try:
            data = load_results(os.path.join(d, fname)) or {}
        except (ValueError, OSError) as e:
            # ValueError covers json.JSONDecodeError AND UnicodeDecodeError
            # (byte-level truncation inside a multi-byte character).
            logger.warning("skipping unreadable checkpoint %s: %s", fname, e)
            continue
        recs = data.get("recommendations", {}) if isinstance(data, dict) else None
        if not isinstance(recs, dict):
            # Valid JSON, wrong shape (e.g. a list, or recommendations: null):
            # still corruption — resume must not crash on it.
            logger.warning("skipping malformed checkpoint %s", fname)
            continue
        # Never resume a contained failure as completed work.
        recs = {
            k: v for k, v in recs.items()
            if not (isinstance(v, dict) and v.get("error"))
        }
        if not recs:
            # Parses fine but every entry was a contained failure: keep
            # walking — an older checkpoint may hold valid completed work
            # (checkpoints are cumulative; this only matters after a
            # pathological run, but the fallback is free).
            logger.warning("checkpoint %s has no completed work; trying older", fname)
            continue
        logger.info("resuming from checkpoint %s (%d profiles done)", fname, len(recs))
        return recs
    return {}
