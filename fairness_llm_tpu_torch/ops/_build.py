"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles on its own,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``, into ``build/kernels/lib<name>.so`` at the root of the
checkout. No PyTorch header is included, so a build takes seconds. A library
newer than its source is reused. A failed build, load or launch raises
``KernelError``; nothing falls back. ``load_events`` counts the builds and
library loads of the process, so that the step watchdog
(``resilience/watchdog.py``) can exempt a call that paid for one.

The kernels stage k/v rows into shared memory in 16-byte chunks, so a row's
bytes must be a multiple of 16 and every row must start on a 16-byte
boundary; ``rows_aligned16`` and ``pad_last_dim`` let a wrapper meet that.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict, Sequence, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}
# Sources built and libraries loaded in this process so far.
load_events = 0


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, to load or to launch. After a
    failed launch the CUDA context may be unusable, so fault containment
    never absorbs this error (``utils/failures.is_fatal_device_error``)."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale source in ``names``, one ``nvcc`` per source, all
    started together. Returns each compiler's output (``-Xptxas -v`` lists
    registers, shared memory and spills). Raises ``KernelError`` on any
    failure."""
    global load_events
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        load_events += 1
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built first if
    needed), with its argument types set and an int return (a CUDA error
    code). Pointers and the stream go as ``c_void_p``, or ctypes would pass
    them as 32-bit ints. Set up once per symbol; later calls return it."""
    global load_events
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            try:
                lib = ctypes.CDLL(str(_lib_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load {_lib_path(name)}: {e}") from e
            load_events += 1
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
        return fn


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a Stream object (that took 6-10 us a call on the host of an
    H100 80GB HBM3 machine at 700 W, a third of a decode-step matmul's host
    time)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


#: Shared memory of an H100 SM, of which each resident block reserves 1 KB,
#: and the most one block may take: the float32 kernels' plans count blocks
#: an SM from them.
SMEM_PER_SM, SMEM_PER_BLOCK = 233472, 232448


def grown(cache: dict, key, numel: int, dtype: torch.dtype, device: torch.device,
          zero: bool = False) -> torch.Tensor:
    """``cache[key]``, a 1-D scratch tensor kept between calls and replaced
    by a larger one (zero-filled if ``zero``) only when a call needs more.
    A kernel's workspace is keyed by (device, stream): calls on one stream
    run in order, so a call's kernels write it only after the previous
    call's have read it."""
    buf = cache.get(key)
    if buf is None or buf.numel() < numel:
        buf = cache[key] = (torch.zeros if zero else torch.empty)(numel, dtype=dtype,
                                                                 device=device)
    return buf


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status} at launch")


def rows_aligned16(t: torch.Tensor) -> bool:
    """Every row (last dimension) of ``t`` starts on a 16-byte boundary and
    its bytes are a multiple of 16."""
    item = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * item % 16 == 0
            and all(s * item % 16 == 0 for s in t.stride()[:-1]))


def pad_last_dim(t: torch.Tensor, n: int) -> torch.Tensor:
    """A fresh (so aligned) contiguous copy of ``t`` with the last dimension
    zero-padded to ``n``."""
    out = t.new_zeros(*t.shape[:-1], n)
    out[..., :t.shape[-1]] = t
    return out
