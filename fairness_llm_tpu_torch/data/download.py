"""Fetch MovieLens-1M into the configured data directory (the port's copy of
``fairness_llm_tpu/data/download.py``).

The repo ships ``movies.dat``/``users.dat`` but not the 1M-row
``ratings.dat``; the original study tells the user to download the archive.
This is that instruction as a command:

    python -m fairness_llm_tpu_torch.data.download [--data-dir data/ml-1m]

Downloads the official GroupLens archive (~6 MB zip), extracts the three
``.dat`` tables, and verifies the row counts against the published dataset
card (1,000,209 ratings / 3,883 movies / 6,040 users); a table that fails
its count is removed, so a rerun does not take it for present. On a
machine with no egress this fails fast with the manual instructions; the
pipeline itself falls back to seeded synthetic ratings when the tables are
absent (``data/movielens.py:load_movielens``).
"""

from __future__ import annotations

import argparse
import io
import logging
import os
import sys
import urllib.error
import urllib.request
import zipfile

logger = logging.getLogger(__name__)

ML1M_URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
TABLES = ("movies.dat", "users.dat", "ratings.dat")
EXPECTED_ROWS = {"ratings.dat": 1_000_209, "movies.dat": 3_883, "users.dat": 6_040}

MANUAL_HELP = f"""\
Could not download. To fetch manually:
  1. curl -LO {ML1M_URL}     (any machine with network)
  2. unzip ml-1m.zip
  3. copy ml-1m/{{movies,users,ratings}}.dat into the --data-dir
The pipeline runs on a seeded synthetic fallback until the real tables exist.
"""


def fetch_ml1m(data_dir: str, url: str = ML1M_URL, timeout: int = 60) -> bool:
    """Download + extract + verify. Returns True on success."""
    have = [t for t in TABLES if os.path.exists(os.path.join(data_dir, t))]
    if len(have) == len(TABLES):
        logger.info("all tables already present under %s", data_dir)
        return True

    logger.info("downloading %s ...", url)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            blob = r.read()
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        logger.error("download failed: %s", e)
        print(MANUAL_HELP, file=sys.stderr)
        return False

    os.makedirs(data_dir, exist_ok=True)
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            for member in z.namelist():
                base = os.path.basename(member)
                if base in TABLES:
                    with z.open(member) as src, open(os.path.join(data_dir, base), "wb") as dst:
                        dst.write(src.read())
                    logger.info("extracted %s", base)
    except zipfile.BadZipFile as e:
        # Captive portals / proxy error pages return 200 with non-zip bytes.
        logger.error("downloaded payload is not a zip archive: %s", e)
        print(MANUAL_HELP, file=sys.stderr)
        return False

    ok = True
    bad = []
    for table, expected in EXPECTED_ROWS.items():
        path = os.path.join(data_dir, table)
        if not os.path.exists(path):
            logger.error("missing %s after extract", table)
            ok = False
            continue
        with open(path, "rb") as f:
            rows = sum(1 for _ in f)
        if rows != expected:
            # Wrong dataset version / altered mirror: the study's golden
            # numbers assume the published 1M card — fail, don't shrug.
            logger.error("%s: %d rows (expected %d)", table, rows, expected)
            ok = False
            bad.append(path)
    if not ok:
        # Remove the rejected tables so a rerun doesn't hit the
        # already-present early-exit and bless data verification refused.
        for path in bad:
            try:
                os.remove(path)
                logger.info("removed rejected %s", path)
            except OSError as e:
                # Permissions / concurrent removal: the verification verdict
                # (False) stands either way; don't turn it into a crash.
                logger.warning("could not remove rejected %s: %s", path, e)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data-dir", default=None,
                        help="target directory (default: the config's data_dir)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    data_dir = args.data_dir
    if data_dir is None:
        from fairness_llm_tpu_torch.config import default_config

        data_dir = default_config().data_dir
    return 0 if fetch_ml1m(data_dir) else 1


if __name__ == "__main__":
    sys.exit(main())
