"""The port's figures (``reports/figures.py``) against the JAX package's: from
one live reference record per phase (the simulated study), both packages
write the same files and plot the same values (every bar, histogram,
threshold line, limit and title, recorded as each figure draws it)."""

import pathlib

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)
matplotlib = pytest.importorskip("matplotlib")

from matplotlib.axes import Axes  # noqa: E402

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu.pipeline import phase2 as jphase2  # noqa: E402
from fairness_llm_tpu.pipeline import phase3 as jphase3  # noqa: E402
from fairness_llm_tpu.reports import figures as jfig  # noqa: E402
from fairness_llm_tpu_torch.reports import figures as tfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data")
DRAWN = ("bar", "hist", "axhline", "set_ylim", "set_title", "set_xticklabels", "set_xlabel",
         "set_ylabel")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Phases 1-3 of the simulated study through the reference."""
    d = tmp_path_factory.mktemp("fig_records")
    cfg = jconfig.Config(data_dir=DATA, results_dir=str(d))
    p1 = jphase1.run_phase1(cfg, "simulated", save=False)
    p2 = jphase2.run_phase2(cfg, ["simulated"], num_items=10, num_comparisons=6, save=False)
    p3 = jphase3.run_phase3(cfg, phase1_results=p1, model_name="simulated", save=False)
    return {1: p1, 2: p2, 3: p3}


def _plain(v):
    """A plotted argument as plain Python: arrays and ranges to lists."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (list, tuple, range)):
        return [_plain(x) for x in v]
    return v


def _draw(monkeypatch, fn, *args):
    """Call ``fn`` with every drawing method of the axes recorded."""
    calls = []
    for name in DRAWN:
        real = getattr(Axes, name)

        def spy(self, *a, _name=name, _real=real, **kw):
            calls.append((_name, _plain(list(a)), {k: _plain(v) for k, v in sorted(kw.items())}))
            return _real(self, *a, **kw)

        monkeypatch.setattr(Axes, name, spy)
    out = fn(*args)
    monkeypatch.undo()
    return out, calls


CASES = {
    1: ("generate_phase1_figures", ["fairness_overview.png", "gender_analysis.png",
                                    "snsr_similarity.png"]),
    2: ("generate_phase2_figure", ["phase2_ranking_fairness.png"]),
    3: ("generate_phase3_figure", ["phase3_conformal_mitigation.png"]),
}


@pytest.mark.parametrize("phase", sorted(CASES))
def test_figures_equal_the_reference(phase, records, tmp_path, monkeypatch):
    name, files = CASES[phase]
    got, gcalls = _draw(monkeypatch, getattr(tfig, name), records[phase], str(tmp_path / "t"))
    want, wcalls = _draw(monkeypatch, getattr(jfig, name), records[phase], str(tmp_path / "j"))
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert [pathlib.Path(p).name for p in got] == [pathlib.Path(p).name for p in want] == files
    for p in got:
        assert pathlib.Path(p).stat().st_size > 0
    assert gcalls == wcalls
    assert any(c[0] in ("bar", "hist") for c in gcalls)


def test_cli_writes_the_figures(tmp_path):
    """``--all`` on the simulated study writes every phase's figures under
    ``<results-dir>/visualizations`` when matplotlib is there."""
    from fairness_llm_tpu_torch.cli import main as tcli

    rc = tcli.main(["--all", "--quick", "--model", "simulated", "--device", "cpu",
                    "--data-dir", DATA, "--results-dir", str(tmp_path)])
    assert rc == 0
    written = sorted(p.name for p in (tmp_path / "visualizations").iterdir())
    assert written == sorted(CASES[1][1] + CASES[2][1] + CASES[3][1])
