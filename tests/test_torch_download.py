"""The port's ``data/download.py`` against the JAX package's, case for case
with ``tests/test_download.py``: the fetch runs through a ``file://`` URL
to an archive the test builds (no network), and both modules must return
the same verdict and leave the same files."""

import zipfile

import pytest

from fairness_llm_tpu.data import download as ref
from fairness_llm_tpu_torch.data import download as port

MODULES = {"reference": ref, "port": port}


def _make_zip(path, rows_per_table):
    with zipfile.ZipFile(path, "w") as z:
        for table, rows in rows_per_table.items():
            z.writestr(f"ml-1m/{table}", "x::y::z\n" * rows)


def _files(path):
    if not path.exists():
        return {}
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def _both(tmp_path, fetch_url, prepare=None):
    """Run each module's ``fetch_ml1m`` into its own data directory: the
    verdicts and the files left, by module."""
    out = {}
    for name, mod in MODULES.items():
        data_dir = tmp_path / name
        if prepare is not None:
            prepare(data_dir)
        out[name] = (mod.fetch_ml1m(str(data_dir), url=fetch_url), _files(data_dir))
    return out


def test_constants_are_the_reference_s():
    assert port.ML1M_URL == ref.ML1M_URL
    assert port.TABLES == ref.TABLES
    assert port.EXPECTED_ROWS == ref.EXPECTED_ROWS
    assert port.MANUAL_HELP == ref.MANUAL_HELP


def test_fetch_extracts_and_verifies(tmp_path):
    archive = tmp_path / "ml-1m.zip"
    _make_zip(archive, port.EXPECTED_ROWS)
    got = _both(tmp_path, f"file://{archive}")
    assert got["port"] == got["reference"]
    ok, files = got["port"]
    assert ok and sorted(files) == sorted(port.EXPECTED_ROWS)


def test_fetch_skips_when_present(tmp_path):
    def present(data_dir):
        data_dir.mkdir()
        for table in port.EXPECTED_ROWS:
            (data_dir / table).write_text("1::2::3\n")

    # the unreachable URL is never touched: the tables are already present
    got = _both(tmp_path, "file:///nonexistent.zip", present)
    assert got["port"] == got["reference"] and got["port"][0]


@pytest.mark.parametrize("name", list(MODULES))
def test_fetch_fails_gracefully_offline(tmp_path, capsys, name):
    assert not MODULES[name].fetch_ml1m(str(tmp_path / "data"),
                                        url=f"file://{tmp_path}/missing.zip")
    err = capsys.readouterr().err
    assert "manually" in err and port.MANUAL_HELP in err


def test_fetch_rejects_wrong_row_counts(tmp_path):
    archive = tmp_path / "bad.zip"
    _make_zip(archive, {t: 5 for t in port.EXPECTED_ROWS})
    got = _both(tmp_path, f"file://{archive}")
    assert got["port"] == got["reference"] == (False, {})
    # the rejected tables are gone, so a rerun fails again
    again = _both(tmp_path, f"file://{archive}")
    assert again["port"] == again["reference"] == (False, {})


def test_fetch_removes_only_the_table_that_fails(tmp_path):
    archive = tmp_path / "mixed.zip"
    rows = dict(port.EXPECTED_ROWS, **{"users.dat": 5})
    _make_zip(archive, rows)
    got = _both(tmp_path, f"file://{archive}")
    assert got["port"] == got["reference"]
    ok, files = got["port"]
    assert not ok and sorted(files) == ["movies.dat", "ratings.dat"]


def test_fetch_rejects_non_zip_payload(tmp_path, capsys):
    payload = tmp_path / "portal.zip"
    payload.write_text("<html>sign in to continue</html>")
    got = _both(tmp_path, f"file://{payload}")
    assert got["port"] == got["reference"] == (False, {})
    assert capsys.readouterr().err.count("manually") == 2


def test_main_takes_its_directory_from_the_flag_and_the_config(tmp_path, monkeypatch):
    """``main`` exits 0 when the tables are present (no fetch), in the
    directory ``--data-dir`` names or, without it, in the config's
    ``data_dir`` (``FAIRNESS_TPU_DATA_DIR``), as the reference's does."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    for table in port.EXPECTED_ROWS:
        (data_dir / table).write_text("1::2::3\n")
    for mod in MODULES.values():
        assert mod.main(["--data-dir", str(data_dir)]) == 0
    monkeypatch.setenv("FAIRNESS_TPU_DATA_DIR", str(data_dir))
    for mod in MODULES.values():
        assert mod.main([]) == 0
