"""The port's checkpoint export and safetensors writer, against the JAX
package and the ``safetensors`` package on the CPU.

- ``safetensors_io.save_file``: every dtype the reader knows, every pair of
  them with ties of name within a dtype, a zero-size tensor, a
  ``__metadata__`` entry and a non-contiguous tensor, each written byte for
  byte as ``safetensors.numpy.save_file`` (``safetensors.torch`` for
  bfloat16, which numpy lacks) writes it, and read back equal by the
  package and by the port's reader.
- ``weights.save_checkpoint_hf``: six tiny families (llama, mistral,
  gemma, qwen2, gpt2 and tied llama), each with float32, bfloat16 and int8
  weights. Parameters come from the reference's flax init (seed 0), with
  every norm scale drawn uniform in [0.5, 2] and every bias N(0, 0.02) so
  that gemma's ``scale - 1`` and the q/k/v and Conv1D biases carry values;
  ``params_from_jax`` carries them across. The two packages' exports are
  byte for byte equal (``model.safetensors``) and so are their manifests'
  ``files`` entries; the port's ``load_checkpoint`` of its own export
  equals the port's tree bit for bit, an int8 tree's ``kernel_q`` bit for
  bit and its scales within one float32 ulp (re-quantizing the dequantized
  weight computes ``fl(fl(127 s) / 127)``, which may move ``s`` by one ulp).
  gemma's norm round trip (``x - 1`` on export, ``+ 1`` on load) is exact
  for scales in [0.5, 2], the range drawn here.
- A bit flipped in an exported file's tensor data is refused at load with
  an ``IntegrityError`` naming ``model.safetensors``.
"""

import functools
import hashlib
import itertools
import json
import os
import struct

import jax
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu.models import configs as jconfigs  # noqa: E402
from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.runtime import weights as jweights  # noqa: E402
from fairness_llm_tpu_torch.integrity import manifest as tmanifest  # noqa: E402
from fairness_llm_tpu_torch.integrity.manifest import IntegrityError  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.runtime import safetensors_io as sio  # noqa: E402
from fairness_llm_tpu_torch.runtime import weights as tweights  # noqa: E402
from fairness_llm_tpu_torch.telemetry import use_registry  # noqa: E402
from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector  # noqa: E402

# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------

DTYPES = {code: torch_dtype for code, (_np, torch_dtype) in sio._DTYPES.items()}


def _tensor(code, shape, seed):
    g = torch.Generator().manual_seed(seed)
    dtype = DTYPES[code]
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


def _package_bytes(tensors, metadata=None):
    """The package's bytes for ``tensors``: through numpy, or through torch
    where a tensor is bfloat16."""
    if any(t.dtype == torch.bfloat16 for t in tensors.values()):
        return safetensors_torch.save(tensors, metadata=metadata)
    return safetensors_numpy.save({k: t.numpy() for k, t in tensors.items()},
                                  metadata=metadata)


def _write(tensors, path, metadata=None):
    sio.save_file(tensors, str(path), metadata=metadata)
    return path.read_bytes()


def _read_back(path, tensors):
    """The file read by the port's reader and by the package equals
    ``tensors``."""
    with sio.SafetensorsFile(str(path)) as f:
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and got.shape == t.shape and torch.equal(got, t), name
    loaded = safetensors_torch.load_file(str(path))
    assert sorted(loaded) == sorted(tensors)
    for name, t in tensors.items():
        assert torch.equal(loaded[name], t), name


@pytest.mark.parametrize("code", sorted(DTYPES))
def test_writer_matches_the_package_for_each_dtype(code, tmp_path):
    tensors = {"w": _tensor(code, (3, 5), 0), "scalar": _tensor(code, (), 1),
               "empty": _tensor(code, (0, 4), 2)}
    digest = sio.save_file(tensors, str(tmp_path / "x.safetensors"))
    got = (tmp_path / "x.safetensors").read_bytes()
    assert got == _package_bytes(tensors)
    assert digest == hashlib.sha256(got).hexdigest()  # hashed as written
    _read_back(tmp_path / "x.safetensors", tensors)


@pytest.mark.parametrize("first,second", list(itertools.permutations(sorted(DTYPES), 2)))
def test_writer_orders_every_pair_of_dtypes_as_the_package(first, second, tmp_path):
    """Two names a dtype, given out of name order: the layout is the
    package's for every ordered pair of dtypes."""
    tensors = {"b": _tensor(first, (7,), 0), "a": _tensor(second, (2, 3), 1),
               "a.10": _tensor(first, (1,), 2), "a.9": _tensor(second, (4,), 3)}
    got = _write(tensors, tmp_path / "x.safetensors")
    assert got == _package_bytes(tensors)
    _read_back(tmp_path / "x.safetensors", tensors)


def test_writer_layout_order_is_the_packages():
    """One tensor of each dtype comes out I64, F32, I32, BF16, F16, I8 (by
    the package's dtype order, not by item size and name)."""
    tensors = {code: _tensor(code, (2,), i) for i, code in enumerate(sorted(DTYPES))}
    raw = safetensors_torch.save(tensors)
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    assert list(header) == ["I64", "F32", "I32", "BF16", "F16", "I8"]
    assert sorted(sio._WRITE_ORDER, key=sio._WRITE_ORDER.get) == list(header)


def test_writer_metadata_zero_size_and_views(tmp_path):
    mixed = {"z.weight": _tensor("BF16", (4, 6), 0).t(), "emb": _tensor("F32", (0, 8), 1),
             "q": _tensor("I8", (5, 3), 2), "s": _tensor("F32", (3,), 3),
             "ids": _tensor("I64", (2, 2), 4), "h": _tensor("F16", (1, 1, 2), 5)}
    assert not mixed["z.weight"].is_contiguous()
    dense = {k: t.contiguous() for k, t in mixed.items()}
    got = _write(mixed, tmp_path / "x.safetensors", metadata={"format": "pt"})
    assert got == _package_bytes(dense, metadata={"format": "pt"})
    _read_back(tmp_path / "x.safetensors", dense)
    # Empty: the header alone, "{}" padded to 8 bytes.
    assert _write({}, tmp_path / "e.safetensors") == _package_bytes({})
    # The package writes a metadata dict of several keys in a hash order
    # that varies between runs: the headers agree as JSON, the data byte
    # for byte.
    meta = {"format": "pt", "producer": "test", "step": "3"}
    got = _write(dense, tmp_path / "m.safetensors", metadata=meta)
    want = _package_bytes(dense, metadata=meta)
    (n,) = struct.unpack("<Q", got[:8])
    assert got[:8] == want[:8] and json.loads(got[8:8 + n]) == json.loads(want[8:8 + n])
    assert list(json.loads(got[8:8 + n])["__metadata__"]) == list(meta)
    assert got[8 + n:] == want[8 + n:]
    with pytest.raises(ValueError, match="unsupported dtype"):
        sio.save_file({"b": torch.zeros(2, dtype=torch.bool)}, str(tmp_path / "b.safetensors"))


# ---------------------------------------------------------------------------
# save_checkpoint_hf against the reference's
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=64, d_ff=128, head_dim=16,
            max_seq_len=256, rope_theta=10000.0, eos_token_id=1, pad_token_id=0,
            dtype="float32")
# llama and gpt2 are the registry's tiny configs; the others are
# tests/test_torch_families.py's tiny families.
FAMILIES = {
    "llama": "tiny-test",
    "gpt2": "tiny-gpt2",
    "mistral": dict(num_kv_heads=2, norm_eps=1e-5, sliding_window=8),
    "gemma": dict(num_kv_heads=4, norm_eps=1e-6, activation="gelu_tanh", embed_scale=True,
                  tie_embeddings=True),
    "qwen2": dict(num_kv_heads=2, norm_eps=1e-6, qkv_bias=True, tie_embeddings=True),
    "llama-tied": dict(num_kv_heads=2, tie_embeddings=True),
}
WEIGHTS = ("float32", "bfloat16", "int8")
# Largest |difference| of a re-quantized scale, in float32 ulps.
SCALE_ULPS = 1


def _configs(family, quant):
    spec = FAMILIES[family]
    if isinstance(spec, str):
        fields = {f: getattr(jconfigs.get_model_config(spec), f)
                  for f in jconfigs.ModelConfig.__dataclass_fields__}
    else:
        fields = dict(BASE, name=f"tiny-{family}-family", **spec)
    fields["weight_quant"] = quant
    return jconfigs.ModelConfig(**fields), tconfigs.ModelConfig(**fields)


def _randomize(tree, rng):
    """Norm scales uniform in [0.5, 2], biases N(0, 0.02), in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key == "scale":
            tree[key] = rng.uniform(0.5, 2.0, val.shape).astype(val.dtype)
        elif key == "bias":
            tree[key] = (rng.standard_normal(val.shape) * 0.02).astype(val.dtype)


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else np.asarray(v).astype(dtype)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _flax_tree(family, weights):
    jcfg, _ = _configs(family, "none")
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.key(0)))
    _randomize(tree, np.random.default_rng(1))
    if weights == "bfloat16":
        tree = _cast(tree, ml_dtypes.bfloat16)
    elif weights == "int8":
        tree = jax.device_get(jweights.quantize_params(tree))
    return tree


def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_matches_the_reference_and_round_trips(family, weights, tmp_path):
    quant = "int8" if weights == "int8" else "none"
    jcfg, tcfg = _configs(family, quant)
    tree = _flax_tree(family, weights)
    params = tweights.params_from_jax(tree, tcfg)
    jdir, tdir = tmp_path / "reference", tmp_path / "port"
    jweights.save_checkpoint_hf(jcfg, tree, str(jdir))
    tweights.save_checkpoint_hf(tcfg, params, str(tdir))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "manifest.json", "model.safetensors"]
    assert (tdir / "model.safetensors").read_bytes() == (jdir / "model.safetensors").read_bytes()
    files = [json.loads((d / "manifest.json").read_text())["files"] for d in (tdir, jdir)]
    assert files[0] == files[1]
    header, _ = sio.read_header(str(tdir / "model.safetensors"))
    assert ("lm_head.weight" in header) == (not tcfg.tie_embeddings)
    if family == "gpt2":
        assert "h.0.attn.c_attn.weight" in header

    dtype = torch.bfloat16 if weights == "bfloat16" else torch.float32
    got = tweights.load_checkpoint(tcfg, str(tdir), dtype=dtype, device="cpu")
    assert sorted(got) == sorted(params)
    for name, want in params.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        if name.endswith(".kernel_scale"):
            assert _ulps(got[name], want) <= SCALE_ULPS, name
        else:
            assert torch.equal(got[name], want), name
    if family == "gemma":
        norm = params["final_norm.scale"]
        assert norm.min() < 0.75 and norm.max() > 1.75  # the drawn range is covered


def test_export_takes_an_int8_tree_on_its_own(tmp_path):
    """The int8 export holds the reference's layout: bfloat16 embeddings
    and norms beside float32 dequantized kernels in one file; a quantized
    tree's ``kernel_q`` survives the re-quantization bit for bit (each of
    its columns reaches +-127, so the scale comes back within an ulp)."""
    _, fcfg = _configs("llama", "none")
    _, tcfg = _configs("llama", "int8")
    params = tweights.quantize_params(
        tweights.init_params(fcfg, 0, torch.device("cpu"), torch.bfloat16))
    tweights.save_checkpoint_hf(tcfg, params, str(tmp_path))
    header, _ = sio.read_header(str(tmp_path / "model.safetensors"))
    assert header["model.embed_tokens.weight"]["dtype"] == "BF16"
    assert header["model.norm.weight"]["dtype"] == "BF16"
    assert header["model.layers.0.self_attn.q_proj.weight"]["dtype"] == "F32"
    assert header["lm_head.weight"]["dtype"] == "F32"
    got = tweights.load_checkpoint(tcfg, str(tmp_path), dtype=torch.bfloat16, device="cpu")
    for name, want in params.items():
        if name.endswith(".kernel_scale"):
            assert _ulps(got[name], want) <= SCALE_ULPS, name
        else:
            assert torch.equal(got[name], want), name


def test_flipped_bit_in_an_export_is_refused(tmp_path):
    """The counterpart of the reference's manifest test: a bit flipped in
    the tensor data is refused at load, naming the file; ``verify=False``
    still loads."""
    _, tcfg = _configs("llama", "none")
    params = tweights.params_from_jax(_flax_tree("llama", "float32"), tcfg)
    d = str(tmp_path / "ckpt")
    tweights.save_checkpoint_hf(tcfg, params, d)
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert manifest["files"]["model.safetensors"]["num_tensors"] == len(params)
    tweights.load_checkpoint(tcfg, d, device="cpu")
    shard = os.path.join(d, "model.safetensors")
    with use_registry():
        ScriptedFaultInjector.flip_bit(shard, (os.path.getsize(shard) - 64) * 8)
        with pytest.raises(IntegrityError, match="model.safetensors"):
            tweights.load_checkpoint(tcfg, d, device="cpu")
    tweights.load_checkpoint(tcfg, d, verify=False, device="cpu")


def test_manifest_hashes_shards_in_parallel_and_reports_the_first(tmp_path, monkeypatch):
    """A sharded directory's manifest equals one built a file at a time;
    with two shards corrupted, the check (all files hashed at once) names
    the first in sorted order, as the sequential check did; a digest the
    writer gives is used without reading the file."""
    shards = {f"model-0000{i}-of-00004.safetensors": {f"w{i}": _tensor("F32", (64, 33), i)}
              for i in range(1, 5)}
    for name, tensors in shards.items():
        sio.save_file(tensors, str(tmp_path / name))
    monkeypatch.setattr(tmanifest, "_HASH_THREADS", 1)
    one_by_one = tmanifest.build_manifest(str(tmp_path))
    monkeypatch.setattr(tmanifest, "_HASH_THREADS", 8)
    assert tmanifest.build_manifest(str(tmp_path)) == one_by_one
    tmanifest.write_manifest(str(tmp_path))
    tmanifest.verify_manifest(str(tmp_path), kind="weights")
    with use_registry():
        for name in sorted(shards)[1:3]:
            ScriptedFaultInjector.flip_bit(str(tmp_path / name),
                                           ((tmp_path / name).stat().st_size - 8) * 8)
        with pytest.raises(IntegrityError, match=sorted(shards)[1]):
            tmanifest.verify_manifest(str(tmp_path), kind="weights")
    first = sorted(shards)[0]
    given = tmanifest.build_manifest(str(tmp_path), [first], digests={first: "0" * 64})
    assert given["files"][first]["sha256"] == "0" * 64
    assert given["files"][first]["bytes"] == (tmp_path / first).stat().st_size
