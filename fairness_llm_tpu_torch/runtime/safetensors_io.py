"""A safetensors reader written without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header; an optional ``__metadata__``
entry), then the raw little-endian tensor bytes.

``SafetensorsFile`` maps the file with ``np.memmap`` and copies one tensor
at a time out of it, so a checkpoint of many gigabytes never sits in host
memory whole. A sharded checkpoint names each tensor's file in
``model.safetensors.index.json`` (``INDEX_FILENAME``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Tuple

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
        self._map = np.memmap(path, dtype=np.uint8, mode="r") if size else None

    def keys(self) -> List[str]:
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A fresh CPU tensor holding a copy of ``name``'s bytes."""
        meta = self._entries[name]
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        start = self._data_start + begin
        flat = np.frombuffer(self._map, dtype=np_dtype, count=(end - begin) // np_dtype.itemsize,
                             offset=start) if end > begin else np.zeros(0, np_dtype)
        t = torch.from_numpy(flat.reshape(meta["shape"]).copy())
        return t.view(torch_dtype) if t.dtype != torch_dtype else t

    def close(self) -> None:
        self._map = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
