"""Verified artifacts: sha256 manifests beside weights and results (the
port's copy of ``fairness_llm_tpu/integrity/manifest.py``).

A producer writes ``manifest.json`` beside its files: per-file sha256 and
byte size, plus a tensor shape/dtype summary for safetensors files. Two
disciplines:

- **Refuse** (weights): ``verify_manifest`` raises :class:`IntegrityError`
  naming the file on the first mismatch, before a tensor is read.
- **Fall back** (results checkpoints): ``verify_manifest_entry`` returns
  False on a mismatch, and the resume loader skips to an older checkpoint.

Files are hashed in parallel, one thread a file (sha256 is one stream a
file, and ``hashlib`` releases the GIL), so a sharded checkpoint verifies
in about the time of its largest shard. A producer that hashed a file as
it wrote it passes the digest to ``write_manifest`` instead of reading the
file back.

A directory without a manifest verifies trivially, and so does a file the
manifest does not list. Both paths count
``manifest_verifications_total{kind}`` / ``manifest_failures_total{kind}``,
emit a ``manifest_failure`` event and trigger an ``integrity_fault``
incident on a mismatch.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, TypeVar

from fairness_llm_tpu_torch.runtime.safetensors_io import read_header
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger

logger = logging.getLogger(__name__)

MANIFEST_FILENAME = "manifest.json"
MANIFEST_VERSION = 1
_HASH_CHUNK = 1 << 20
# Files hashed at once (each a thread; the host's cores bound it too).
_HASH_THREADS = 8

_T = TypeVar("_T")


def _in_parallel(fn: Callable[[str], _T], items: Sequence[str]) -> List[_T]:
    """``[fn(x) for x in items]``, a thread an item up to ``_HASH_THREADS``."""
    workers = min(len(items), _HASH_THREADS, os.cpu_count() or 1)
    if workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


class IntegrityError(RuntimeError):
    """An artifact failed its manifest check (digest or size mismatch, or a
    listed file missing). The message names the file."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _safetensors_summary(path: str) -> Optional[Dict]:
    """Shape/dtype summary from a safetensors header (no tensor bytes read).
    None when the header does not parse; the digest still covers the file."""
    try:
        header, _ = read_header(path)
    except (OSError, ValueError):
        return None
    tensors = {
        name: {"dtype": meta.get("dtype"), "shape": meta.get("shape")}
        for name, meta in header.items()
        if name != "__metadata__" and isinstance(meta, dict)
    }
    return {"num_tensors": len(tensors), "tensors": tensors}


def _file_entry(root: str, rel: str, sha256: Optional[str] = None) -> Dict:
    path = os.path.join(root, rel)
    entry: Dict = {"sha256": sha256 or _sha256_file(path), "bytes": os.path.getsize(path)}
    if rel.endswith(".safetensors"):
        summary = _safetensors_summary(path)
        if summary is not None:
            entry.update(summary)
    return entry


def build_manifest(root: str, files: Optional[Sequence[str]] = None,
                   digests: Optional[Mapping[str, str]] = None) -> Dict:
    """Manifest dict for ``files`` (relative paths; default: every regular
    file under ``root``, recursively, except the manifest itself).
    ``digests`` gives the sha256 of files already hashed (by the writer, as
    it wrote them); the others are read and hashed here."""
    if files is None:
        files = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fname in filenames:
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                if rel != MANIFEST_FILENAME:
                    files.append(rel)
        files.sort()
    digests = digests or {}
    entries = _in_parallel(lambda rel: _file_entry(root, rel, digests.get(rel)), list(files))
    return {"version": MANIFEST_VERSION, "files": dict(zip(files, entries))}


def write_manifest(root: str, files: Optional[Sequence[str]] = None,
                   path: Optional[str] = None,
                   digests: Optional[Mapping[str, str]] = None) -> str:
    """Build and atomically write a manifest for ``root``; returns its path
    (default ``root/manifest.json``; ``path`` puts it elsewhere, as the train
    checkpointer keeps it outside its step directories). ``digests`` as in
    ``build_manifest``."""
    path = path or os.path.join(root, MANIFEST_FILENAME)
    _write_json_atomic(build_manifest(root, files, digests), path)
    return path


def _write_json_atomic(payload: Dict, path: str) -> None:
    # tmp + fsync + replace: a torn manifest would refuse good artifacts.
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_manifest(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("unreadable manifest %s: %s", path, e)
        return None
    return data if isinstance(data, dict) and isinstance(data.get("files"), dict) else None


def _check_entry(root: str, rel: str, entry: Dict) -> Optional[str]:
    """None when the file matches its manifest entry, else the reason (which
    names the file)."""
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return f"{rel}: listed in manifest but missing on disk"
    size = os.path.getsize(path)
    want_bytes = entry.get("bytes")
    if want_bytes is not None and size != want_bytes:
        return f"{rel}: size {size} != manifest {want_bytes} (truncated?)"
    digest = _sha256_file(path)
    want = entry.get("sha256")
    if want is not None and digest != want:
        return f"{rel}: sha256 {digest[:16]}… != manifest {want[:16]}… (corrupt)"
    return None


def verify_manifest(root: str, manifest_path: Optional[str] = None,
                    kind: str = "artifact") -> None:
    """Verify every file the manifest lists; raise :class:`IntegrityError` on
    the first mismatch in the files' sorted order (all are checked first,
    in parallel)."""
    manifest_path = manifest_path or os.path.join(root, MANIFEST_FILENAME)
    manifest = _load_manifest(manifest_path)
    get_registry().counter("manifest_verifications_total", kind=kind).inc()
    if manifest is None:
        _fail(kind, manifest_path, "manifest unreadable or malformed")
    listed = sorted(manifest["files"])
    problems = _in_parallel(lambda rel: _check_entry(root, rel, manifest["files"][rel]), listed)
    for rel, problem in zip(listed, problems):
        if problem is not None:
            _fail(kind, os.path.join(root, rel), problem)
    logger.info("manifest OK (%s): %s (%d file(s) verified)", kind, root,
                len(manifest["files"]))


def _note_failure(kind: str, path: str, problem: str) -> None:
    """Count a mismatch, emit its event and trigger the incident (corrupt
    bytes at rest: the bundle names the file and the problem)."""
    get_registry().counter("manifest_failures_total", kind=kind).inc()
    # "artifact_kind", not "kind": emit_event's first positional is the
    # event kind.
    emit_event("manifest_failure", artifact_kind=kind, file=path, reason=problem)
    maybe_trigger("integrity_fault", f"manifest digest failure: {path}: {problem}",
                  scope=kind, file=path)


def _fail(kind: str, path: str, problem: str) -> None:
    _note_failure(kind, path, problem)
    raise IntegrityError(f"integrity check failed for {path}: {problem}")


def maybe_verify_manifest(root: str, kind: str = "artifact") -> bool:
    """``verify_manifest`` when ``root`` has a manifest (True); False when it
    has none."""
    if not os.path.exists(os.path.join(root, MANIFEST_FILENAME)):
        logger.debug("no manifest under %s; skipping verification", root)
        return False
    verify_manifest(root, kind=kind)
    return True


def update_manifest_entry(directory: str, filename: str) -> None:
    """Insert or refresh one file's entry in ``directory/manifest.json``
    (read-modify-write, atomic replace). An unreadable manifest is replaced."""
    path = os.path.join(directory, MANIFEST_FILENAME)
    manifest = (_load_manifest(path) if os.path.exists(path) else None) or {
        "version": MANIFEST_VERSION, "files": {}}
    manifest["files"][filename] = _file_entry(directory, filename)
    _write_json_atomic(manifest, path)


def verify_manifest_entry(directory: str, filename: str, kind: str = "results") -> bool:
    """True when ``filename`` matches its manifest entry or has none; False
    (logged) on a mismatch, so that the caller falls back to an older
    artifact."""
    manifest = _load_manifest(os.path.join(directory, MANIFEST_FILENAME))
    if manifest is None:
        return True
    entry = manifest["files"].get(filename)
    if entry is None:
        return True
    get_registry().counter("manifest_verifications_total", kind=kind).inc()
    problem = _check_entry(directory, filename, entry)
    if problem is None:
        return True
    _note_failure(kind, os.path.join(directory, filename), problem)
    logger.warning("manifest mismatch (%s): %s", kind, problem)
    return False
