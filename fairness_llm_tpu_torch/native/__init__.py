"""The native ratings parser (the port's copy of ``fairness_llm_tpu/native``):
``parse_dat.c``, bound through ctypes.

``data/movielens._parse_ratings`` reads ``ratings.dat`` (1,000,209 rows in
MovieLens-1M) through it. The library is compiled on first use with ``cc
-O3 -shared -fPIC`` (``$CC`` where set) into ``build/native/`` at the root of
the checkout, never next to the source, and reused while it is newer than
the source. It builds to a per-pid temporary path and is renamed into place,
so processes that race the first build (ranks, test workers) never load a
half-written file. It is a host parser, not a device kernel: where no
compiler is available ``parse_ratings`` returns None and the caller parses
in pure Python, with the same arrays.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = pathlib.Path(__file__).resolve().parent / "parse_dat.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_SO = BUILD_DIR / "_parse_dat.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the parser library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = BUILD_DIR / f"{_SO.name}.{os.getpid()}.tmp"
                try:
                    subprocess.run(
                        [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", str(_SRC),
                         "-o", str(tmp)],
                        check=True, capture_output=True, timeout=120,
                    )
                    os.replace(tmp, _SO)
                finally:
                    if tmp.exists():  # a failed or timed-out compile's leftovers
                        tmp.unlink()
                logger.info("built native parser %s", _SO)
            lib = ctypes.CDLL(str(_SO))
            lib.parse_ratings.restype = ctypes.c_long
            lib.parse_ratings.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
            ]
            lib.count_lines.restype = ctypes.c_long
            lib.count_lines.argtypes = [ctypes.c_char_p]
            _lib = lib
            return lib
        except Exception as e:  # noqa: BLE001 — any failure means "no native path"
            logger.info("native parser unavailable (%s); using pure Python", e)
            _build_failed = True
            return None


def available() -> bool:
    return _build() is not None


def parse_ratings(path: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse ``user::movie::rating[::ts]`` rows -> (users int32, movies
    int32, values float32). None when the library cannot be built (the
    caller falls back); ``FileNotFoundError`` for a missing file,
    ``ValueError`` for a malformed line."""
    lib = _build()
    if lib is None:
        return None
    encoded = os.fsencode(path)
    n_lines = lib.count_lines(encoded)
    if n_lines < 0:
        raise FileNotFoundError(path)
    users = np.empty(n_lines, dtype=np.int32)
    movies = np.empty(n_lines, dtype=np.int32)
    values = np.empty(n_lines, dtype=np.float32)
    n = lib.parse_ratings(
        encoded,
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        movies.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_lines,
    )
    if n == -3:
        raise ValueError(f"malformed line in {path}")
    if n < 0:
        raise IOError(f"native parse failed ({n}) for {path}")
    return users[:n], movies[:n], values[:n]
