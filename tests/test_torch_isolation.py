"""The port stands alone: it imports torch and numpy, never JAX, flax,
optax, orbax or the JAX package, nor ``safetensors``, ``tokenizers``,
``transformers``, ``regex`` or ``matplotlib``, which a CUDA host running it
need not have; and it runs on the CPU only when asked to."""

import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "fairness_llm_tpu_torch"
OUTSIDE = ("jax", "jaxlib", "flax", "optax", "orbax", "fairness_llm_tpu", "safetensors",
           "tokenizers", "transformers", "regex", "matplotlib")
# matplotlib may be imported lazily, inside a function (reports/figures.py
# draws where it is installed); at module level it is refused like the rest.
_NAMES = "|".join(n for n in OUTSIDE if n != "matplotlib")
FORBIDDEN = re.compile(
    rf"^\s*(?:import|from)\s+(?:{_NAMES})\b"
    rf"|^(?:import|from)\s+matplotlib\b"
    rf"|(?:import_module|__import__)\(\s*['\"](?:{_NAMES}|matplotlib)\b",
    re.MULTILINE,
)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fairness_llm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('fairness_llm_tpu_torch.')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40


# Modules whose lazy imports (inside functions) run only when they are
# used: the paged KV cache and the telemetry core.
LAZY = ["serving/paged.py"] + [f"telemetry/{m}.py" for m in (
    "__init__", "registry", "timeline", "slo", "tracing", "flightrecorder", "export",
    "heartbeat")]


def test_paged_and_telemetry_at_work_leave_jax_out(tmp_path):
    """Import is not enough for the modules that import inside their
    functions: drive the paged manager and every telemetry module (tracer
    to its SLO alert, heartbeat gap, flight recorder, snapshot and trace
    export) in a fresh interpreter and check what it loaded."""
    assert {str(p.relative_to(PKG)) for p in _port_sources() if PKG in p.parents} >= set(LAZY)
    code = (
        "import sys\n"
        "from fairness_llm_tpu_torch import telemetry as T\n"
        "from fairness_llm_tpu_torch.serving.paged import PagedKV\n"
        "from fairness_llm_tpu_torch.utils.profiling import ServingStats, phase_timer\n"
        f"sink = T.configure({str(tmp_path)!r})\n"
        "p = PagedKV(2, 4, 4)\n"
        "p.admit(0, list(range(9))); p.commit(0, list(range(9))); p.release(0)\n"
        "tr = T.RequestTracer()\n"
        "for i in range(4):\n"
        "    tr.record(f'r{i}', 'submitted'); tr.finalize(f'r{i}', 'failed', tokens=0)\n"
        "tr.slo.evaluate()\n"
        "clock = [0.0]\n"
        "hb = T.Heartbeat(interval_s=1.0, clock=lambda: clock[0])\n"
        "hb.poke(); clock[0] = 10.0; hb.poke()\n"
        "T.get_flight_recorder().record('chunks', steps=1)\n"
        "ServingStats(admitted=1).publish()\n"
        "with phase_timer('x'):\n"
        "    pass\n"
        f"T.write_snapshot(T.get_registry(), {str(tmp_path)!r})\n"
        f"T.get_timeline().export({str(tmp_path / 'trace.json')!r})\n"
        "T.render_report(T.snapshot(T.get_registry()))\n"
        "sink.close()\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "telemetry_snapshot.json").exists()


# The device-facing telemetry and the figures: their imports of other port
# modules (and matplotlib's) are inside their functions.
DEVICE_FACING = [f"telemetry/{m}.py" for m in ("compilestats", "roofline", "memory",
                                                "costmodel")] + ["reports/figures.py"]


def test_device_telemetry_at_work_leaves_jax_out(tmp_path):
    """Drive the five modules in a fresh interpreter: import the figures
    (matplotlib stays out until a figure is drawn), decode through the
    engine with the exporters configured (the compile stats, the cost walk,
    the roofline, the memory ledger and the program-memory capture), render
    both reports, and check what it loaded."""
    assert {str(p.relative_to(PKG)) for p in _port_sources() if PKG in p.parents} >= \
        set(DEVICE_FACING)
    code = (
        "import sys\n"
        "import fairness_llm_tpu_torch.reports.figures\n"
        "assert 'matplotlib' not in sys.modules\n"
        "from fairness_llm_tpu_torch import telemetry as T\n"
        "from fairness_llm_tpu_torch.config import ModelSettings\n"
        "from fairness_llm_tpu_torch.models.configs import get_model_config\n"
        "from fairness_llm_tpu_torch.runtime.engine import DecodeEngine\n"
        f"sink = T.configure({str(tmp_path)!r})\n"
        "eng = DecodeEngine(get_model_config('tiny-test'), device='cpu')\n"
        "eng.generate(['abc', 'de'], ModelSettings(temperature=0.0, max_tokens=3))\n"
        "snap = T.snapshot(T.get_registry())\n"
        "assert T.has_cost_data(snap) and T.has_memory_data(snap)\n"
        "assert T.check_costmodel(snap) == [] and T.check_memory(snap)\n"
        "T.render_cost_report(snap); T.render_memory_report(snap)\n"
        "sink.close()\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# The mesh, the sharded metrics and the device trace: their collectives and
# the profiler are imported inside their functions.
PARALLEL = ["parallel/__init__.py", "parallel/sharding.py", "parallel/multihost.py",
            "metrics/sharded.py", "utils/profiling.py"]


def test_parallel_and_trace_at_work_leave_jax_out(tmp_path):
    """In a fresh interpreter: join a one-rank gloo world through the
    launcher's environment, build the mesh, reduce metric counts over it,
    decode through a mesh engine inside a ``torch.profiler`` capture, read
    the capture back, and check what it loaded."""
    assert {str(p.relative_to(PKG)) for p in _port_sources() if PKG in p.parents} >= \
        set(PARALLEL)
    code = (
        "import socket, sys\n"
        "with socket.socket() as s:\n"
        "    s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]\n"
        "import os\n"
        "os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port), WORLD_SIZE='1',"
        " RANK='0')\n"
        "import numpy as np\n"
        "from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings\n"
        "from fairness_llm_tpu_torch.metrics.sharded import mesh_group_counts_fn\n"
        "from fairness_llm_tpu_torch.models.configs import get_model_config\n"
        "from fairness_llm_tpu_torch.parallel import multihost, param_shardings\n"
        "from fairness_llm_tpu_torch.runtime.engine import DecodeEngine\n"
        "from fairness_llm_tpu_torch.utils import maybe_trace, summarize_trace\n"
        "assert multihost.initialize_distributed()\n"
        "mesh = multihost.make_multihost_mesh(MeshConfig())\n"
        "cfg = get_model_config('tiny-test')\n"
        "assert param_shardings(cfg, mesh)\n"
        "c = mesh_group_counts_fn(mesh)(np.ones((3, 2), np.float32), np.array([0, 1, 1]), 2)\n"
        "assert c.tolist() == [[1.0, 1.0], [2.0, 2.0]]\n"
        f"with maybe_trace({str(tmp_path)!r}, 'phase1'):\n"
        "    DecodeEngine(cfg, device='cpu', mesh=mesh).generate(\n"
        "        ['abc'], ModelSettings(temperature=0.0, max_tokens=2))\n"
        f"assert summarize_trace({str(tmp_path)!r}, device_filter='')\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# Ring attention and training: the collectives, the checkpoint's manifest
# and torch.utils.checkpoint are imported inside their functions.
TRAINING = ["parallel/ring.py", "train/__init__.py", "train/step.py", "train/checkpoint.py"]


def test_ring_and_training_at_work_leave_jax_out(tmp_path):
    """In a fresh interpreter: attend through the ring (one rank), take a
    remat training step and a sequence-parallel one, save and restore the
    train state, and check that none of JAX, flax, optax or orbax loaded."""
    assert {str(p.relative_to(PKG)) for p in _port_sources() if PKG in p.parents} >= \
        set(TRAINING)
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from fairness_llm_tpu_torch.models.configs import get_model_config\n"
        "from fairness_llm_tpu_torch.parallel.ring import ring_attention\n"
        "from fairness_llm_tpu_torch.train import make_train_step\n"
        "from fairness_llm_tpu_torch.train.checkpoint import restore_train_state, "
        "save_train_state\n"
        "from fairness_llm_tpu_torch.train.step import make_sequence_parallel_train_step\n"
        "q = torch.ones(1, 4, 2, 8); pos = torch.arange(4)[None]\n"
        "ring_attention(q, q[:, :, :1], q[:, :, :1], pos, pos, torch.ones(1, 4, dtype=bool))\n"
        "cfg = get_model_config('tiny-test')\n"
        "toks, valid = np.arange(20).reshape(2, 10) + 3, np.ones((2, 10), bool)\n"
        "init, step = make_train_step(cfg, remat=True, device='cpu')\n"
        "state, loss = step(init(0), toks, valid)\n"
        "init_sp, step_sp = make_sequence_parallel_train_step(cfg, None, device='cpu')\n"
        "step_sp(init_sp(0), toks, valid)\n"
        f"save_train_state({str(tmp_path)!r}, state)\n"
        f"assert restore_train_state({str(tmp_path)!r}, init(1)).step == 1\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# The data path's last two modules: the fetch and the native ratings parser
# (its ctypes loader compiles the C source on first use).
DATA_PATH = ["data/download.py", "native/__init__.py", "data/movielens.py"]


def test_download_and_native_at_work_leave_jax_out(tmp_path):
    """In a fresh interpreter: fetch a fabricated MovieLens archive through
    a ``file://`` URL (no network), parse its ``ratings.dat`` natively and
    through ``load_movielens``, and check that nothing of JAX or the JAX
    package loaded."""
    assert {str(p.relative_to(PKG)) for p in _port_sources() if PKG in p.parents} >= \
        set(DATA_PATH)
    code = (
        "import sys, zipfile\n"
        "from fairness_llm_tpu_torch import native\n"
        "from fairness_llm_tpu_torch.data import download, movielens\n"
        f"archive = {str(tmp_path / 'ml-1m.zip')!r}\n"
        "rows = {'movies.dat': '1::A (1995)::Drama\\n', 'users.dat': '1::F::1::10::48067\\n',"
        " 'ratings.dat': '1::1::5::978300760\\n'}\n"
        "with zipfile.ZipFile(archive, 'w') as z:\n"
        "    for t, row in rows.items():\n"
        "        z.writestr('ml-1m/' + t, row * download.EXPECTED_ROWS[t])\n"
        f"d = {str(tmp_path / 'data')!r}\n"
        "assert download.fetch_ml1m(d, url='file://' + archive)\n"
        "users, movies, values = native.parse_ratings(d + '/ratings.dat')\n"
        "assert len(users) == 1_000_209 and float(values[0]) == 5.0\n"
        "data = movielens.load_movielens(d, allow_synthetic=False)\n"
        "assert data.num_ratings == 1_000_209 and data.source == 'real'\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_engine_without_a_device_needs_a_card():
    from fairness_llm_tpu_torch.device import resolve_device
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(get_model_config("tiny-test"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not apply")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


# ---------------------------------------------------------------------------
# Parity of public names with the JAX package
# ---------------------------------------------------------------------------

JAX_PKG = ROOT / "fairness_llm_tpu"
# Public names of the JAX package with no same-named function or class in
# the port: JAX and XLA mechanisms, each with what the port does instead.
JAX_ONLY = {
    "init_params_lowmem": "weights.init_params draws the largest tensors first",
    "quant_matmul_sharded": "tp runs through the port's own collectives (parallel/)",
    "compat_shard_map": "tp runs through the port's own collectives (parallel/)",
    "current_mesh": "tp runs through the port's own collectives (parallel/)",
    "resolve_logical_axis": "tp runs through the port's own collectives (parallel/)",
    "InstrumentedJit": "jaxpr cost accounting; costmodel.InstrumentedProgram walks aten ops",
    "instrument_jit": "jaxpr cost accounting; costmodel.InstrumentedProgram walks aten ops",
    "jaxpr_ledger": "jaxpr cost accounting; costmodel.InstrumentedProgram walks aten ops",
    "classify_eqn": "jaxpr cost accounting; costmodel.classify_op classifies aten ops",
    "capture_program_memory": "XLA AOT memory; telemetry/memory reads the CUDA allocator",
    "set_aot_memory_capture": "XLA AOT memory; telemetry/memory reads the CUDA allocator",
    "aot_memory_capture_on": "XLA AOT memory; telemetry/memory reads the CUDA allocator",
    "tree_shard_bytes": "XLA AOT memory; memory.tree_device_bytes counts the tensors",
    "flash_supported": "a Pallas gate; the CUDA wrappers check their own shapes",
    "decode_attn_supported": "a Pallas gate; the CUDA wrappers check their own shapes",
    "quant_tileable": "a Pallas gate; the CUDA wrappers check their own shapes",
    "force_pallas": "a Pallas gate; the CUDA wrappers check their own shapes",
    "base_program": "jit-program caching; the port's steps run eagerly",
    "compile_key": "jit-program caching; the port's steps run eagerly",
}


def _public_names(pkg: pathlib.Path) -> set:
    """Every public top-level ``def`` and ``class`` name of every module of
    ``pkg``, read from the source."""
    import ast

    names = set()
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names.add(node.name)
    return names


def _parity_gaps(jax_names: set, port_names: set, jax_only) -> list:
    """The JAX package's public names that the port lacks and the list does
    not excuse, and the listed names that are no longer JAX-only."""
    missing = sorted(jax_names - port_names - set(jax_only))
    stale = sorted(n for n in jax_only if n not in jax_names or n in port_names)
    return missing + [f"{n} (listed, not JAX-only)" for n in stale]


def test_every_public_jax_name_has_a_port_counterpart():
    assert _parity_gaps(_public_names(JAX_PKG), _public_names(PKG), JAX_ONLY) == []


@pytest.mark.parametrize("drop", ["save_checkpoint_hf", "load_checkpoint", "DecodeEngine"])
def test_parity_guard_catches_a_name_missing_from_the_port(drop):
    port = _public_names(PKG)
    assert drop in port
    assert _parity_gaps(_public_names(JAX_PKG), port - {drop}, JAX_ONLY) == [drop]


@pytest.mark.parametrize("drop", ["init_params_lowmem", "jaxpr_ledger", "force_pallas"])
def test_parity_guard_catches_a_name_missing_from_the_list(drop):
    listed = {k: v for k, v in JAX_ONLY.items() if k != drop}
    assert _parity_gaps(_public_names(JAX_PKG), _public_names(PKG), listed) == [drop]
