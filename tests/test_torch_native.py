"""The port's native ratings parser (``native/``) and ``data/movielens``'s
use of it, against the JAX package's, case for case with
``tests/test_native.py``: the native parse equals the reference's native
parse and the pure-Python one on a ``ratings.dat`` the test writes, the
library is built under ``build/native/`` only, and a missing compiler
falls back to the pure-Python parse."""

import logging
import os
import pathlib

import numpy as np
import pytest

from fairness_llm_tpu import native as ref_native
from fairness_llm_tpu.data import movielens as ref_movielens
from fairness_llm_tpu_torch import native
from fairness_llm_tpu_torch.data import movielens

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def ratings_file(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "ratings.dat"
    rows = []
    for _ in range(5000):
        u = int(rng.integers(1, 6041))
        m = int(rng.integers(1, 3953))
        r = int(rng.integers(1, 6))
        ts = int(rng.integers(9e8, 1e9))
        rows.append(f"{u}::{m}::{r}::{ts}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _python_parse(path):
    lines = open(path).read().splitlines()
    return (np.array([int(line.split("::")[0]) for line in lines], np.int32),
            np.array([int(line.split("::")[1]) for line in lines], np.int32),
            np.array([float(line.split("::")[2]) for line in lines], np.float32))


def _same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_builds_and_parses(ratings_file):
    if not native.available():
        pytest.skip("no C compiler in environment")
    got = native.parse_ratings(ratings_file)
    _same(got, _python_parse(ratings_file))
    if ref_native.available():
        _same(got, ref_native.parse_ratings(ratings_file))


def test_native_builds_under_build_only():
    """The library lands in ``build/native/`` at the root of the checkout,
    which .gitignore covers; nothing is built next to the source."""
    if not native.available():
        pytest.skip("no C compiler in environment")
    assert native._SO == ROOT / "build" / "native" / "_parse_dat.so"
    assert native._SO.exists()
    assert sorted(p.name for p in (ROOT / "fairness_llm_tpu_torch" / "native").iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "parse_dat.c"]
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_parse_ratings_wrapper_matches(ratings_file):
    users, movies, values = movielens._parse_ratings(ratings_file)
    assert len(users) == len(movies) == len(values) == 5000
    assert users.dtype == np.int32 and values.dtype == np.float32
    _same((users, movies, values), ref_movielens._parse_ratings(ratings_file))


def test_load_movielens_end_to_end(tmp_path, ratings_file):
    (tmp_path / "movies.dat").write_text(
        "1::Toy Story (1995)::Animation|Children's|Comedy\n"
        "2::Jumanji (1995)::Adventure|Children's|Fantasy\n",
        encoding="latin-1",
    )
    data = movielens.load_movielens(str(tmp_path), allow_synthetic=False)
    want = ref_movielens.load_movielens(str(tmp_path), allow_synthetic=False)
    assert data.num_movies == want.num_movies == 2
    assert data.num_ratings == want.num_ratings == 5000
    assert data.titles == want.titles and data.titles[0] == "Toy Story (1995)"
    assert data.source == want.source == "real"
    _same((data.rating_user_ids, data.rating_movie_ids, data.rating_values),
          (want.rating_user_ids, want.rating_movie_ids, want.rating_values))


@pytest.mark.parametrize("line", ["1::2", "1:2::3", "1::2:::3", "a::2::3", "1::2::5:978"])
def test_malformed_lines_raise_in_both(tmp_path, line):
    """A malformed line fails the native parse, and the fallback then
    raises what the reference's raises."""
    path = tmp_path / "ratings.dat"
    path.write_text(f"1::2::3::4\n{line}\n")
    raised = []
    for mod in (movielens, ref_movielens):
        with pytest.raises((ValueError, IndexError)) as e:
            mod._parse_ratings(str(path))
        raised.append(e.type)
    assert raised[0] is raised[1]
    if native.available():
        with pytest.raises(ValueError, match="malformed"):
            native.parse_ratings(str(path))


def test_missing_file_raises():
    if not native.available():
        pytest.skip("no C compiler in environment")
    with pytest.raises(FileNotFoundError):
        native.parse_ratings("/nonexistent/ratings.dat")


@pytest.fixture()
def fresh_native(tmp_path, monkeypatch):
    """The loader with nothing built or loaded yet, building into
    ``tmp_path`` (the module's state comes back after the test)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_SO", tmp_path / "build" / "_parse_dat.so")
    return native


def test_no_compiler_falls_back_to_python(fresh_native, ratings_file, monkeypatch, caplog):
    monkeypatch.setenv("CC", "/nonexistent/cc")
    with caplog.at_level(logging.INFO):
        assert fresh_native.parse_ratings(ratings_file) is None
        got = movielens._parse_ratings(ratings_file)
    assert "native parser unavailable" in caplog.text
    _same(got, _python_parse(ratings_file))
    assert not fresh_native.BUILD_DIR.exists() or not any(fresh_native.BUILD_DIR.iterdir())


def test_stale_library_is_rebuilt_by_rename(fresh_native, ratings_file):
    """A first build writes the library through a per-pid temporary file
    renamed into place; one older than the source is built again."""
    if not fresh_native.available():
        pytest.skip("no C compiler in environment")
    so = fresh_native._SO
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]
    old = fresh_native._SRC.stat().st_mtime - 100
    os.utime(so, (old, old))
    fresh_native._lib = None
    assert fresh_native.available()
    assert so.stat().st_mtime >= fresh_native._SRC.stat().st_mtime
    _same(fresh_native.parse_ratings(ratings_file), _python_parse(ratings_file))
