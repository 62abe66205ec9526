"""A safetensors reader and writer written without the ``safetensors``
package.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header; an optional ``__metadata__``
entry), then the raw little-endian tensor bytes.

``SafetensorsFile`` reads one tensor at a time straight into a fresh host
array (``readinto``: one copy, and no page faults as a mapped file would
take a page at a time), so a checkpoint of many gigabytes never sits in
host memory whole. A sharded checkpoint names each tensor's file in
``model.safetensors.index.json`` (``INDEX_FILENAME``).

``save_file`` writes the same bytes as the package's ``save_file`` for the
same tensors: the JSON header compact, ``__metadata__`` first, padded with
spaces to a multiple of 8 bytes, and the tensors laid out by dtype
(``_WRITE_ORDER``) and then by name. It copies one tensor at a time to the
host, so a tree on the card never sits in host memory whole, and hashes
the bytes as it writes them (sha256 on a second thread, a tensor behind the
writes), so a manifest needs no second read of the file.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype -> (numpy dtype read from the file, torch dtype it views as)
_DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    # numpy has no bfloat16: read the bits as uint16 and view them in torch
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_CODES = {torch_dtype: code for code, (_np, torch_dtype) in _DTYPES.items()}
# The package lays tensors out by dtype in this order (its dtype enum,
# largest first), then by name; read off its output for every pair of the
# dtypes above.
_WRITE_ORDER = {code: i for i, code in enumerate(("I64", "F32", "I32", "BF16", "F16", "I8"))}
# A header is a few KB per hundred tensors; refuse a length no real file has.
_MAX_HEADER = 100 << 20
INDEX_FILENAME = "model.safetensors.index.json"


def read_header(path: str) -> Tuple[Dict, int]:
    """(the JSON header, the byte offset where tensor data starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (hlen,) = struct.unpack("<Q", raw)
        if hlen > _MAX_HEADER:
            raise ValueError(f"{path}: header length {hlen} is not plausible")
        header = json.loads(f.read(hlen))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + hlen


class SafetensorsFile:
    """One ``.safetensors`` file, read a tensor at a time. Close it (or use
    it as a context manager) to drop the mapping."""

    def __init__(self, path: str):
        self.path = path
        header, self._data_start = read_header(path)
        header.pop("__metadata__", None)
        self._entries = header
        size = os.path.getsize(path)
        for name, meta in header.items():
            begin, end = meta["data_offsets"]
            if meta["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {meta['dtype']}")
            want = int(np.prod(meta["shape"], dtype=np.int64)) * _DTYPES[meta["dtype"]][0].itemsize
            if end - begin != want or self._data_start + end > size or begin < 0:
                raise ValueError(f"{path}: tensor {name} has offsets {begin}..{end} for "
                                 f"{want} bytes in a file of {size}")
        self._file = open(path, "rb", buffering=0)

    def keys(self) -> List[str]:
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A fresh CPU tensor holding a copy of ``name``'s bytes."""
        meta = self._entries[name]
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        flat = np.empty((end - begin) // np_dtype.itemsize, np_dtype)
        view, done = memoryview(flat).cast("B"), 0
        self._file.seek(self._data_start + begin)
        while done < end - begin:
            n = self._file.readinto(view[done:])
            if not n:
                raise ValueError(f"{self.path}: tensor {name} ends past the end of the file")
            done += n
        t = torch.from_numpy(flat.reshape(meta["shape"]))
        return t.view(torch_dtype) if t.dtype != torch_dtype else t

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _host_array(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes in row-major order as a host numpy array (a view when
    ``t`` is a contiguous CPU tensor; otherwise made contiguous on its
    device, then copied to the host)."""
    t = t.detach().contiguous().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)  # numpy has no bfloat16: write the bits
    return t.numpy()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> str:
    """Write ``tensors`` (on any device) to ``path`` as one safetensors file,
    byte for byte as the package writes it (its ``__metadata__`` keys come
    out in a hash order that varies from run to run; these keep
    ``metadata``'s order). Returns the sha256 (hex) of the bytes written."""
    order = []
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name} has unsupported dtype {t.dtype}")
        order.append((_WRITE_ORDER[_CODES[t.dtype]], name))
    order.sort()
    header: Dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for _rank, name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    digest = hashlib.sha256()
    with open(path, "wb") as f, ThreadPoolExecutor(max_workers=1) as hasher:
        hashing = None

        def put(buf) -> None:
            # Hash ``buf`` while the next tensor is copied and written; at
            # most two tensors' bytes are on the host at once.
            nonlocal hashing
            f.write(buf)
            if hashing is not None:
                hashing.result()
            hashing = hasher.submit(digest.update, buf)

        put(struct.pack("<Q", len(raw)) + raw)
        for _rank, name in order:
            put(_host_array(tensors[name]))
        hashing.result()
    return digest.hexdigest()
