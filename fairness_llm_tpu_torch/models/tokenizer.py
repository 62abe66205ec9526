"""Tokenizers (counterpart of ``fairness_llm_tpu/models/tokenizer.py``).

- ``ByteTokenizer``: UTF-8 bytes with reserved specials; what randomly
  initialised models use.
- ``HFTokenizer``: a byte-level BPE tokenizer read from a checkpoint's
  ``tokenizer.json``, written without ``tokenizers``/``transformers``. It
  gives the ids and text the reference's ``transformers`` adapter gives on
  the same file: special tokens split out first, GPT-2's pre-tokenizer split,
  bytes mapped to printable characters, merges applied lowest rank first,
  characters missing from the vocabulary dropped (no unknown token).

Both expose ``encode_batch``, which produces **left-padded** fixed-shape
``[B, S]`` int32 arrays (left padding keeps the KV write index uniform
across the batch), and ``decode``.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TokenBatch:
    """Left-padded prompt batch ready for prefill."""

    tokens: np.ndarray  # [B, S] int32
    valid: np.ndarray  # [B, S] bool (False on left pads)
    lengths: np.ndarray  # [B] int32 real token counts


def _left_pad(rows: Sequence[List[int]], pad_id: int, max_len: Optional[int] = None) -> TokenBatch:
    n = len(rows)
    s = max_len or max((len(r) for r in rows), default=1)
    s = max(s, 1)
    tokens = np.full((n, s), pad_id, dtype=np.int32)
    valid = np.zeros((n, s), dtype=bool)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, row in enumerate(rows):
        row = row[-s:] if len(row) > s else row  # truncate from the left, keep recency
        if row:
            tokens[i, s - len(row):] = row
            valid[i, s - len(row):] = True
        lengths[i] = len(row)
    return TokenBatch(tokens=tokens, valid=valid, lengths=lengths)


class ByteTokenizer:
    """UTF-8 bytes -> ids with reserved specials.

    Layout: 0=pad, 1=eos, 2=bos, bytes b -> 3+b. Total 259 ids; any model with
    vocab_size >= 259 can host it.
    """

    PAD_ID = 0
    EOS_ID = 1
    BOS_ID = 2
    OFFSET = 3

    def __init__(self, vocab_size: int = 512):
        if vocab_size < self.OFFSET + 256:
            raise ValueError(f"vocab_size {vocab_size} < {self.OFFSET + 256}")
        self.vocab_size = vocab_size
        self.pad_id = self.PAD_ID
        self.eos_id = self.EOS_ID
        self.bos_id = self.BOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.OFFSET + b for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Sequence[str], max_len: Optional[int] = None) -> TokenBatch:
        return _left_pad([self.encode(t) for t in texts], self.pad_id, max_len)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map: printable latin-1 bytes map
    to themselves, the rest to code points from 256 up, in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    out, extra = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + extra)
            extra += 1
    return out


_BYTE_CHARS = _bytes_to_unicode()
_CHAR_BYTES = {c: b for b, c in _BYTE_CHARS.items()}
# The Unicode White_Space property, which the pre-tokenizer's \s matches.
# Python's str.isspace differs from it (it also takes U+001C..U+001F).
_WHITESPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)] + [" ", "\x85", "\xa0", "\u1680"]
    + [chr(c) for c in range(0x2000, 0x200B)]
    + ["\u2028", "\u2029", "\u202f", "\u205f", "\u3000"])
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _is_letter(c: str) -> bool:  # \p{L}
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:  # \p{N}
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:  # [^\s\p{L}\p{N}]
    return c not in _WHITESPACE and unicodedata.category(c)[0] not in "LN"


def pretokenize(text: str) -> List[str]:
    """GPT-2's split, ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, as a scanner that tries the
    alternatives in order at each position (Python's ``re`` has no \\p{L},
    and the port does not depend on ``regex``)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        end = 0
        if c == "'":
            for suffix in _CONTRACTIONS:
                if text.startswith(suffix, i + 1):
                    end = i + 1 + len(suffix)
                    break
        if not end:
            j = i + 1 if c == " " and i + 1 < n else i
            for cls in (_is_letter, _is_number, _is_other):
                if cls(text[j]):
                    end = j + 1
                    while end < n and cls(text[end]):
                        end += 1
                    break
        if not end:
            # c is whitespace: the run, less its last character when a
            # non-space follows and the run is longer than one (\s+(?!\S)),
            # else the whole run (\s+)
            end = i + 1
            while end < n and text[end] in _WHITESPACE:
                end += 1
            if end < n and end - i > 1:
                end -= 1
        out.append(text[i:end])
        i = end
    return out


class HFTokenizer:
    """Byte-level BPE over a checkpoint's ``tokenizer.json``.

    What the reference's ``transformers`` adapter does with the files this
    repo holds, and so what this class does: ``post_processor`` is null, so
    encoding adds no BOS; ``pad_id`` falls back to ``eos_id`` (the
    ``tokenizer_config.json`` eos token); ``decode`` drops pad and eos ids
    and the special tokens and reads the bytes as UTF-8, each invalid
    sequence becoming U+FFFD."""

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        pre = spec.get("pre_tokenizer") or {}
        if (model.get("type") != "BPE" or pre.get("type") != "ByteLevel"
                or pre.get("add_prefix_space") or spec.get("normalizer") is not None
                or spec.get("post_processor") is not None or model.get("unk_token")
                or model.get("byte_fallback") or model.get("continuing_subword_prefix")
                or model.get("end_of_word_suffix") or model.get("dropout")):
            raise ValueError(
                f"{path}/tokenizer.json is not a plain byte-level BPE tokenizer "
                "(no normalizer, post-processor, unknown token or prefix space)")
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self._merges[(self._vocab[a], self._vocab[b])] = (rank, self._vocab[a + b])
        self._specials = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self._special_ids = {t["id"] for t in spec.get("added_tokens", []) if t.get("special")}
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._id_to_token.update({i: t for t, i in self._specials.items()})
        self._cache: Dict[str, List[int]] = {}
        config = {}
        config_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as f:
                config = json.load(f)
        self.eos_id = self._special_id(config.get("eos_token"))
        self.bos_id = self._special_id(config.get("bos_token"))
        self.pad_id = self._special_id(config.get("pad_token"))
        if self.pad_id is None:
            self.pad_id = self.eos_id
        self.vocab_size = len(set(self._vocab.values()) | set(self._specials.values()))

    def _special_id(self, token) -> Optional[int]:
        if isinstance(token, dict):
            token = token.get("content")
        if token is None:
            return None
        return self._specials.get(token, self._vocab.get(token))

    def _bpe(self, word: str) -> List[int]:
        """The ids of one pre-token's mapped characters after the merges,
        in the order ``tokenizers`` applies them: the lowest (rank,
        position) pair first, stale queue entries skipped."""
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        sym = [self._vocab[c] for c in word if c in self._vocab]
        n = len(sym)
        prev, nxt = list(range(-1, n - 1)), list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for pos in range(n - 1):
            m = self._merges.get((sym[pos], sym[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self._merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self._merges.get((sym[prev[pos]], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = self._merges.get((sym[pos], sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        ids = [s for s, a in zip(sym, alive) if a]
        self._cache[word] = ids
        return ids

    def _split_specials(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """(text, None) pieces and (token, id) pieces for each special token
        found, longest match first at the leftmost position."""
        pieces: List[Tuple[str, Optional[int]]] = []
        start = i = 0
        tokens = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            hit = next((t for t in tokens if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                pieces.append((text[start:i], None))
            pieces.append((hit, self._specials[hit]))
            i = start = i + len(hit)
        if start < len(text):
            pieces.append((text[start:], None))
        return pieces

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Token ids of ``text``. No BOS is added whatever ``add_bos`` says:
        the tokenizer has no post-processor to add one."""
        ids: List[int] = []
        for piece, special in self._split_specials(text):
            if special is not None:
                ids.append(special)
                continue
            for word in pretokenize(piece):
                ids.extend(self._bpe("".join(_BYTE_CHARS[b] for b in word.encode("utf-8"))))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        drop = {self.pad_id, self.eos_id} | self._special_ids
        data = bytearray()
        for i in ids:
            i = int(i)
            if i in drop or i not in self._id_to_token:
                continue
            token = self._id_to_token[i]
            if all(c in _CHAR_BYTES for c in token):
                data.extend(_CHAR_BYTES[c] for c in token)
            else:
                data.extend(token.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Sequence[str], max_len: Optional[int] = None) -> TokenBatch:
        return _left_pad([self.encode(t) for t in texts], self.pad_id, max_len)


def tokenizer_for(model_config, tokenizer_path: Optional[str] = None):
    """``HFTokenizer`` over ``tokenizer_path`` when given, else the byte
    tokenizer sized to the model's vocabulary."""
    if tokenizer_path is not None:
        return HFTokenizer(tokenizer_path)
    return ByteTokenizer(model_config.vocab_size)
