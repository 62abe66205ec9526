"""The port's per-phase device trace (``--trace-dir`` over torch.profiler),
its CLI's mesh flags, and the telemetry repairs around them, against the
JAX package's CLI.

- ``--trace-dir`` writes one capture a phase and prints a summary of it;
  ``summarize_trace`` and ``device_busy_share`` read a capture's kernels.
- ``--mesh``: dp parses as the reference's; tp and sp are refused naming
  their slice; dp=2 in one process fails and names torchrun.
- Every phase is a ``cat == "phase"`` span on the timeline, as in the
  reference (``maybe_trace`` records it with or without a directory).
- ``FAIRNESS_TPU_TELEMETRY_DIR`` with no flag exports telemetry in both
  packages.
"""

import json
import pathlib

import jax
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers.
torch.set_num_threads(1)

from fairness_llm_tpu import telemetry as JT  # noqa: E402
from fairness_llm_tpu.cli import main as jcli  # noqa: E402
from fairness_llm_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from fairness_llm_tpu.parallel import sharding as jshd  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.config import MeshConfig, default_config  # noqa: E402
from fairness_llm_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUICK = ["--quick", "--model", "simulated", "--no-save"]


def _flags(parser):
    return {o for a in parser._actions for o in a.option_strings}


def _captures(trace_dir):
    return sorted(p.relative_to(trace_dir).parts[0]
                  for p in pathlib.Path(trace_dir).rglob("*" + profiling.CAPTURE_SUFFIX))


def _phase_spans(trace_path):
    trace = json.loads(pathlib.Path(trace_path).read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted(e["name"] for e in events if e.get("cat") == "phase")


# ---------------------------------------------------------------------------
# The CLI's flags
# ---------------------------------------------------------------------------


def test_the_flag_set_equals_the_references():
    """The reference's flags, and the port's ``--device``; none is refused
    (``--tp`` is ported)."""
    assert _flags(tcli.build_parser()) == _flags(jcli.build_parser()) | {"--device"}
    assert tcli.NOT_PORTED == ()


@pytest.mark.parametrize("spec", ["dp=2", "dp=4", "dp=1,tp=1,sp=1"])
def test_mesh_parses_as_the_references(spec):
    argv = ["--phase", "1", "--mesh", spec, "--trace-dir", "/tmp/t"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert got.mesh.shape == want.mesh.shape
    assert got.profile_trace_dir == want.profile_trace_dir == "/tmp/t"
    for bad in ("xp=2", "dp=two"):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.parse_mesh(bad)


@pytest.mark.parametrize("spec,slice_", [("tp=2", "2"), ("dp=2,tp=2", "4"), ("sp=2", "2")])
def test_tensor_and_sequence_meshes_are_refused(spec, slice_):
    """Tensor and sequence meshes are ported (``tests/test_torch_tp.py``,
    ``test_torch_ring.py``); in one process they are refused as a dp mesh
    is, naming the ranks to launch."""
    assert tcli.config_from_args(tcli.build_parser().parse_args(
        ["--phase", "1", "--mesh", spec])).mesh == tcli.parse_mesh(spec)
    with pytest.raises(ValueError, match=f"torchrun --nproc-per-node {slice_}"):
        tcli.main(["--phase", "1", "--quick", "--model", "tiny-llama-study", "--weights-dir",
                   str(ROOT / "checkpoints"), "--device", "cpu", "--no-save", "--mesh", spec])


def test_a_dp_mesh_in_one_process_fails_and_names_torchrun(tmp_path):
    """As the reference's ``make_mesh`` refuses a mesh larger than its
    devices, the port's refuses a mesh larger than its world."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        jshd.make_mesh(JMeshConfig(dp=2), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tcli.main(["--phase", "1", "--quick", "--model", "tiny-llama-study", "--weights-dir",
                   str(ROOT / "checkpoints"), "--device", "cpu", "--mesh", "dp=2",
                   "--results-dir", str(tmp_path)])


def test_continuous_serving_refuses_a_dp_mesh_before_loading():
    from fairness_llm_tpu_torch.pipeline.backends import backend_for

    args = tcli.build_parser().parse_args(["--phase", "1", "--continuous", "--mesh", "dp=2"])
    with pytest.raises(ValueError, match="tp-only meshes"):
        backend_for("tiny-test", tcli.config_from_args(args), allow_random=True, device="cpu")


# ---------------------------------------------------------------------------
# --trace-dir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phases", [["--phase", "1"], ["--all"]], ids=["phase1", "all"])
def test_trace_dir_writes_a_capture_per_phase_and_a_summary(phases, tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert tcli.main(phases + QUICK + ["--device", "cpu", "--results-dir",
                                       str(tmp_path / "r"), "--trace-dir",
                                       str(trace_dir)]) == 0
    want = ["phase1"] if phases[0] == "--phase" else ["phase1", "phase2", "phase3"]
    caps = _captures(trace_dir)
    assert [c.split("-")[0] for c in caps] == want
    out = capsys.readouterr().out
    # no card: the summary falls back to the host ops, one block a capture
    summaries = profiling.summarize_trace(str(trace_dir), device_filter="")
    assert [s.device.split("-")[0] for s in summaries] == want
    for s in summaries:
        assert s.device.endswith(": host") and s.num_events > 0 and s.top_ops
        assert s.format().splitlines()[0] in out
    assert len(profiling.summarize_trace(str(trace_dir), latest_only=True,
                                         device_filter="")) == 1


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7}


def test_summary_and_busy_share_read_a_cards_capture(tmp_path):
    """A capture as the card writes it: the device side groups kernels by
    name and totals the union of their intervals; the busy share counts the
    kernel time inside the named spans."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "serve_step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "serve_step", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 5},
        _kernel("decode_split_tc", 10, 30), _kernel("decode_split_tc", 20, 30),
        _kernel("gemv_stream_tc", 250, 40), _kernel("gemv_stream_tc", 290, 50),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "phase1-x" / ("host.rank0" + profiling.CAPTURE_SUFFIX)
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": events}))
    cuda, host = profiling.summarize_trace(str(tmp_path), device_filter="")
    assert cuda.device == "phase1-x/host.rank0: cuda"
    # the union: 10..50, 250..340 and 400..410 us
    assert cuda.num_events == 5 and cuda.total_ms == pytest.approx(0.14)
    assert cuda.top_ops[0] == ("gemv_stream_tc", 0.09, 2)
    assert host.device.endswith(": host") and host.top_ops == [("aten::mm", 0.005, 1)]
    assert [s.device for s in profiling.summarize_trace(str(tmp_path))] == [cuda.device]
    share = profiling.device_busy_share(str(path), "serve_step")
    # 10..50 inside the first span, 250..300 inside the second (the rest is past it)
    assert share == {"spans": 2, "wall_ms": 0.2, "busy_ms": 0.09,
                     "busy_share": pytest.approx(0.45)}
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_maybe_trace_records_the_phase_span_and_no_capture_on_failure(tmp_path):
    with T.use_timeline() as tl:
        with profiling.maybe_trace(None, "phaseX"):
            pass
        with pytest.raises(RuntimeError):
            with profiling.maybe_trace(str(tmp_path), "phaseY"):
                raise RuntimeError("boom")
    assert [e["name"] for e in tl.events() if e.get("cat") == "phase"] == ["phaseX", "phaseY"]
    assert _captures(tmp_path) == []


# ---------------------------------------------------------------------------
# C3 and C4
# ---------------------------------------------------------------------------


def test_every_phase_is_a_phase_span_in_both_packages(tmp_path):
    argv = ["--all", "--results-dir", str(tmp_path / "r")] + QUICK
    with T.use_timeline(), JT.use_timeline():
        assert tcli.main(argv + ["--device", "cpu", "--telemetry-dir", str(tmp_path / "t")]) == 0
        assert jcli.main(argv + ["--telemetry-dir", str(tmp_path / "j")]) == 0
    got = _phase_spans(tmp_path / "t" / T.TRACE_FILENAME)
    assert got == _phase_spans(tmp_path / "j" / JT.TRACE_FILENAME)
    assert got == ["phase1", "phase2", "phase3"]


def test_the_telemetry_dir_variable_exports_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("FAIRNESS_TPU_TELEMETRY_DIR", str(tmp_path / "t"))
    assert default_config().telemetry_dir == str(tmp_path / "t")
    argv = ["--phase", "1", "--results-dir", str(tmp_path / "r")] + QUICK
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.setenv("FAIRNESS_TPU_TELEMETRY_DIR", str(tmp_path / "j"))
    assert jcli.main(argv) == 0
    for side in ("t", "j"):
        names = {p.name for p in (tmp_path / side).iterdir()}
        assert {"telemetry_snapshot.json", "trace.json"} <= names, (side, names)


def test_mesh_config_equals_the_references():
    for axes in (dict(), dict(dp=2), dict(dp=2, tp=4), dict(sp=2)):
        got, want = MeshConfig(**axes), JMeshConfig(**axes)
        assert (got.shape, got.num_devices, got.axis_names) == \
            (want.shape, want.num_devices, want.axis_names)
