"""The port's study-checkpoint path against the JAX package's: the
hand-written safetensors reader and ``load_checkpoint``, the manifest check,
and the byte-level BPE ``HFTokenizer`` (which reads ``tokenizer.json``
without ``tokenizers``/``transformers``)."""

import dataclasses
import os
import pathlib
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from fairness_llm_tpu.config import Config as JConfig  # noqa: E402
from fairness_llm_tpu.data import create_base_preferences as j_base  # noqa: E402
from fairness_llm_tpu.data import create_profile_grid as j_grid  # noqa: E402
from fairness_llm_tpu.data import load_movielens as j_load  # noqa: E402
from fairness_llm_tpu.integrity.manifest import IntegrityError as JIntegrityError  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as j_model_config  # noqa: E402
from fairness_llm_tpu.models.tokenizer import HFTokenizer as JHFTokenizer  # noqa: E402
from fairness_llm_tpu.pipeline.prompts import recommendation_prompt as j_prompt  # noqa: E402
from fairness_llm_tpu.runtime import weights as jweights  # noqa: E402
from fairness_llm_tpu_torch.integrity.manifest import IntegrityError  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.models.tokenizer import HFTokenizer, pretokenize  # noqa: E402
from fairness_llm_tpu_torch.runtime import weights  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.safetensors_io import SafetensorsFile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPTS = ROOT / "checkpoints"
STUDY = ("tiny-llama-study", "tiny-gpt2-study")


def _load_both(name: str, quant: str):
    jcfg = dataclasses.replace(j_model_config(name), weight_quant=quant)
    cfg = dataclasses.replace(get_model_config(name), weight_quant=quant)
    want = weights.params_from_jax(
        jax.device_get(jweights.load_checkpoint(jcfg, str(CKPTS / name))), cfg)
    got = weights.load_checkpoint(cfg, str(CKPTS / name), device="cpu")
    return got, want


@pytest.mark.parametrize("name", STUDY)
def test_study_checkpoint_tensors_equal_the_reference(name):
    got, want = _load_both(name, "none")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        assert torch.equal(got[key], w), key


@pytest.mark.parametrize("name", STUDY)
def test_study_checkpoint_int8_equals_the_reference(name):
    got, want = _load_both(name, "int8")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        if key.endswith("kernel_scale"):
            torch.testing.assert_close(got[key], w, rtol=1e-7, atol=0)
        else:
            assert torch.equal(got[key], w), key


def test_reader_round_trip_of_every_dtype(tmp_path):
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file as torch_save

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "i8": rng.integers(-128, 128, size=(2, 3, 4), dtype=np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, size=(7,), dtype=np.int32),
        "i64": rng.integers(-2**40, 2**40, size=(2, 2), dtype=np.int64),
        "empty": np.zeros((0, 3), np.float32),
    }
    np_save(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    bf16 = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32)).to(torch.bfloat16)
    torch_save({"bf16": bf16}, str(tmp_path / "b.safetensors"))
    with SafetensorsFile(str(tmp_path / "a.safetensors")) as f:
        assert sorted(f.keys()) == sorted(arrays)
        for key, a in arrays.items():
            t = f.get_tensor(key)
            assert t.shape == a.shape and t.numpy().dtype == a.dtype
            np.testing.assert_array_equal(t.numpy(), a)
    with SafetensorsFile(str(tmp_path / "b.safetensors")) as f:
        got = f.get_tensor("bf16")
        assert got.dtype == torch.bfloat16 and torch.equal(got, bf16)
    # two files: every name maps to its own file
    index = weights._checkpoint_index(str(tmp_path))
    assert index == {**{k: "a.safetensors" for k in arrays}, "bf16": "b.safetensors"}


def test_sharded_checkpoint_loads_through_its_index(tmp_path):
    """A checkpoint split over two files with ``model.safetensors.index.json``
    loads the same tensors as the single file."""
    import json

    from safetensors.torch import save_file

    name = "tiny-llama-study"
    src = CKPTS / name
    with SafetensorsFile(str(src / "model.safetensors")) as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    keys = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    for fname, names in shards.items():
        save_file({k: tensors[k] for k in names}, str(tmp_path / fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, ns in shards.items() for k in ns}}))
    cfg = get_model_config(name)
    got = weights.load_checkpoint(cfg, str(tmp_path), device="cpu")
    want = weights.load_checkpoint(cfg, str(src), device="cpu")
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_flipped_byte_is_refused_naming_the_file(tmp_path):
    name = "tiny-gpt2-study"
    bad = tmp_path / name
    shutil.copytree(CKPTS / name, bad)
    path = bad / "model.safetensors"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))
    cfg = get_model_config(name)
    with pytest.raises(IntegrityError, match="model.safetensors"):
        weights.load_checkpoint(cfg, str(bad), device="cpu")
    with pytest.raises(JIntegrityError, match="model.safetensors"):
        jweights.load_checkpoint(j_model_config(name), str(bad))
    # verification off: the bytes load (the flip lands inside a tensor)
    assert weights.load_checkpoint(cfg, str(bad), verify=False, device="cpu")


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toks():
    path = str(CKPTS / "tiny-llama-study")
    return HFTokenizer(path), JHFTokenizer(path)


def _phase1_prompts():
    """The default sweep's 45 profile prompts and 3 neutral ones."""
    cfg = JConfig()
    data = j_load(str(ROOT / "data" / "ml-1m"), seed=cfg.random_seed)
    base = j_base(data, seed=cfg.random_seed)
    profiles = j_grid(base, cfg)
    neutral = [dataclasses.replace(profiles[0], id=f"neutral_{i:04d}", gender="", age="")
               for i in range(cfg.profiles_per_combo)]
    return ([j_prompt(p) for p in profiles]
            + [j_prompt(p, anonymize=True) for p in neutral])


def test_tokenizer_specials_match_the_reference(toks):
    mine, ref = toks
    assert (mine.pad_id, mine.eos_id, mine.bos_id, mine.vocab_size) == \
        (ref.pad_id, ref.eos_id, ref.bos_id, ref.vocab_size)


def test_tokenizer_matches_the_reference_on_the_phase1_prompts(toks):
    mine, ref = toks
    prompts = _phase1_prompts()
    assert len(prompts) == 48
    for p in prompts:
        ids = ref.encode(p)
        assert mine.encode(p) == ids
        assert mine.decode(ids) == ref.decode(ids)
    batch, want = mine.encode_batch(prompts), ref.encode_batch(prompts)
    np.testing.assert_array_equal(batch.tokens, want.tokens)
    np.testing.assert_array_equal(batch.valid, want.valid)


def test_tokenizer_matches_the_reference_on_every_movielens_title(toks):
    mine, ref = toks
    with open(ROOT / "data" / "ml-1m" / "movies.dat", encoding="latin-1") as f:
        titles = [line.split("::")[1] for line in f if line.strip()]
    assert len(titles) == 3883
    assert any(not t.isascii() for t in titles)
    for t in titles:
        ids = ref.encode(t)
        assert mine.encode(t) == ids, t
        assert mine.decode(ids) == ref.decode(ids), t


# Contractions, digits, runs of spaces and newlines, letters and numbers
# outside ASCII (accented, Greek, CJK, Arabic-Indic and superscript digits,
# roman numerals), the special token's text, and characters outside the
# vocabulary.
_PIECES = list("abcXYZ019 '\n\t.,!?-()") + [
    "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "  ", "\n\n", " \n ", "é", "Ä", "ß", "Ω",
    "漢", "٣", "²", "Ⅻ", "　", "\x85", "\xa0", "😀", "<|endoftext|>", "ǅ", "ʰ"]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(_PIECES), max_size=24))
def test_tokenizer_matches_the_reference_on_sampled_text(toks, pieces):
    mine, ref = toks
    text = "".join(pieces)
    ids = ref.encode(text)
    assert mine.encode(text) == ids
    assert mine.decode(ids) == ref.decode(ids)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 511), max_size=40))
def test_tokenizer_decodes_any_ids_as_the_reference(toks, ids):
    mine, ref = toks
    assert mine.decode(ids) == ref.decode(ids)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(_PIECES), max_size=24))
def test_pretokenize_splits_as_the_gpt2_pattern(pieces):
    """The scanner against the pattern itself, run by ``regex`` (which has
    \\p{L}; the port itself does not depend on the module)."""
    regex = pytest.importorskip("regex")
    text = "".join(pieces)
    assert pretokenize(text) == regex.findall(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+", text)
    assert pretokenize("a\n\nb  ") == ["a", "\n", "\n", "b", "  "]


def test_engine_takes_the_checkpoint_tokenizer():
    name = "tiny-gpt2-study"
    cfg = get_model_config(name)
    params = weights.load_checkpoint(cfg, str(CKPTS / name), device="cpu")
    eng = DecodeEngine(cfg, params=params, device="cpu", tokenizer_path=str(CKPTS / name))
    assert isinstance(eng.tokenizer, HFTokenizer)
    assert DecodeEngine(cfg, params=params, device="cpu").tokenizer.__class__.__name__ \
        == "ByteTokenizer"
    assert os.path.exists(CKPTS / name / "tokenizer_config.json")
