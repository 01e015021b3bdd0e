"""Durable (atomic and checksummed) checkpoint files, one process
(counterpart of timm_tpu/resilience/durable.py).

Every write goes tmp file -> flush -> fsync -> ``os.replace``; then a
sidecar manifest (``<name>.manifest.json``) records a SHA-256 per array, the
schema version and step metadata. The manifest is the commit record: it is
written after the data file, so a crash mid-write leaves either the previous
(file, manifest) pair or a data file without a matching manifest, and both
are detected. The manifest is byte-compatible with the JAX package's, so
each package verifies and loads the other's files.

Sharded (one file per process) checkpoints and the asynchronous writer are
not ported (ROADMAP A.5.11): a sharded manifest fails verification with
that reason, and ``CheckpointSaver`` raises for either.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

_logger = logging.getLogger(__name__)

__all__ = [
    'SCHEMA_VERSION', 'CorruptCheckpointError',
    'atomic_write_bytes', 'atomic_write_json', 'atomic_write_npz', 'atomic_copy',
    'manifest_path', 'read_manifest', 'verify_checkpoint', 'load_verified',
    'find_checkpoints', 'load_with_fallback', 'resolve_auto_resume',
    'checkpoint_progress_key', 'remove_checkpoint_files',
]

SCHEMA_VERSION = 1
_SHARDED = 'sharded checkpoints are not ported yet (ROADMAP A.5.11)'


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed integrity verification (truncated zip, manifest
    hash mismatch, missing arrays, or unreadable file)."""


def _fsync_dir(path: str):
    """fsync the containing directory so the rename itself is durable."""
    try:
        fd = os.open(path or '.', os.O_RDONLY)
    except OSError:
        return  # platforms without O_RDONLY directories; the rename is still atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, tmp_dir: Optional[str] = None):
    """tmp -> fsync -> os.replace; the final path is never partially written."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix='.' + os.path.basename(path) + '.', suffix='.tmp',
                               dir=tmp_dir or d)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, tmp_dir: Optional[str] = None):
    atomic_write_bytes(path, json.dumps(obj, indent=1, default=str).encode(), tmp_dir=tmp_dir)


def manifest_path(path: str) -> str:
    base, _ = os.path.splitext(path)
    return base + '.manifest.json'


def _array_digest(arr: np.ndarray) -> str:
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def atomic_write_npz(path: str, arrays: Dict[str, np.ndarray], meta: Optional[dict] = None,
                     tmp_dir: Optional[str] = None) -> str:
    """Durably write ``arrays`` as an .npz at ``path`` with a sidecar
    manifest: the data file first, the manifest second. Returns the
    manifest path."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix='.' + os.path.basename(path) + '.', suffix='.tmp',
                               dir=tmp_dir or d)
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    manifest = {
        'schema_version': SCHEMA_VERSION,
        'file': os.path.basename(path),
        'arrays': {k: {'sha256': _array_digest(v), 'shape': list(v.shape), 'dtype': str(v.dtype)}
                   for k, v in arrays.items()},
        'meta': dict(meta or {}),
    }
    mpath = manifest_path(path)
    atomic_write_json(mpath, manifest, tmp_dir=tmp_dir)
    return mpath


def atomic_copy(src: str, dst: str, with_sidecars: bool = True):
    """Copy a committed checkpoint (and its manifest and args sidecars) so
    the destination also appears atomically."""
    with open(src, 'rb') as f:
        atomic_write_bytes(dst, f.read())
    if not with_sidecars:
        return
    for side_src, side_dst in (
            (manifest_path(src), manifest_path(dst)),
            (os.path.splitext(src)[0] + '.json', os.path.splitext(dst)[0] + '.json'),
    ):
        if os.path.exists(side_src):
            with open(side_src, 'rb') as f:
                atomic_write_bytes(side_dst, f.read())


def remove_checkpoint_files(path: str):
    """Remove a checkpoint with its manifest and args sidecar; missing
    files are ignored."""
    for p in (path, manifest_path(path), os.path.splitext(path)[0] + '.json'):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def read_manifest(path: str) -> Optional[dict]:
    mpath = manifest_path(path)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        _logger.warning(f'Unreadable checkpoint manifest {mpath}: {e}')
        return None


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """Return (ok, reason). With a manifest: schema and per-array SHA-256
    check. Without one (a foreign checkpoint): accept if the npz loads."""
    manifest = read_manifest(path)
    if manifest is not None and manifest.get('format') == 'sharded':
        return False, _SHARDED
    if not os.path.exists(path):
        return False, 'missing'
    try:
        with np.load(path, allow_pickle=False) as data:
            if manifest is None:
                _ = data.files  # the zip directory parse is the only check there is
                return True, 'no-manifest (legacy checkpoint; hashes not verified)'
            if int(manifest.get('schema_version', 0)) > SCHEMA_VERSION:
                return False, f'schema_version {manifest.get("schema_version")} > {SCHEMA_VERSION}'
            declared = manifest.get('arrays', {})
            missing = [k for k in declared if k not in data.files]
            if missing:
                return False, f'arrays missing from file: {missing[:4]}'
            for k, info in declared.items():
                if _array_digest(data[k]) != info['sha256']:
                    return False, f'sha256 mismatch for array {k!r}'
    except Exception as e:
        # a torn write surfaces as BadZipFile, zlib.error, EOFError or OSError
        # depending on where the bytes were cut: each means not loadable
        return False, f'unreadable: {e!r}'
    return True, 'ok'


def load_verified(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load a checkpoint after integrity verification; raises
    CorruptCheckpointError with the reason on failure. Returns (state, meta)."""
    ok, reason = verify_checkpoint(path)
    if not ok:
        raise CorruptCheckpointError(f'{path}: {reason}')
    manifest = read_manifest(path)
    with np.load(path, allow_pickle=False) as data:
        state = {k: data[k] for k in data.files}
    return state, (manifest or {}).get('meta', {})


_RECOVERY_RE = re.compile(r'recovery-(\d+)-(\d+)\.npz$')
_CHECKPOINT_RE = re.compile(r'checkpoint-(\d+)\.npz$')
_SHARD_RE = re.compile(r'\.shard(\d+)-of-(\d+)\.npz$')


def checkpoint_progress_key(path: str) -> Tuple[float, int, float]:
    """Training-progress key of a checkpoint file (higher = newer): a
    completed epoch E (last, checkpoint-E, model_best) ranks (E+1, 0), a
    mid-epoch recovery-E-B ranks (E, B+1); mtime breaks ties."""
    name = os.path.basename(path)
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    m = _RECOVERY_RE.search(name)
    if m:
        return float(m.group(1)), int(m.group(2)) + 1, mtime
    m = _CHECKPOINT_RE.search(name)
    if m:
        return float(m.group(1)) + 1.0, 0, mtime
    # last.npz, model_best.npz or a foreign name: the epoch from the manifest
    # meta or the stored epoch array
    manifest = read_manifest(path)
    epoch = None
    if manifest is not None:
        epoch = manifest.get('meta', {}).get('epoch')
    if epoch is None:
        try:
            with np.load(path, allow_pickle=False) as data:
                if 'epoch' in data.files:
                    epoch = int(data['epoch'])
        except Exception:
            epoch = None  # an unreadable file ranks last; verification rejects it
    return (float(epoch) + 1.0 if epoch is not None else -1.0), 0, mtime


def find_checkpoints(directory: str) -> List[str]:
    """The checkpoint files in ``directory``, newest first by training
    progress. Shard files are not checkpoints and are left out."""
    if not directory or not os.path.isdir(directory):
        return []
    names = [n for n in os.listdir(directory)
             if n.endswith('.npz') and not n.startswith('.') and n != 'tmp.npz'
             and not _SHARD_RE.search(n)]
    paths = [os.path.join(directory, n) for n in names]
    return sorted(paths, key=checkpoint_progress_key, reverse=True)


def load_with_fallback(
        path: str,
        search_dir: Optional[str] = None,
) -> Tuple[Dict[str, np.ndarray], dict, str]:
    """Load ``path``, falling back to the newest valid checkpoint in
    ``search_dir`` (default: path's directory) when it is corrupt. Returns
    (state, meta, used_path); raises CorruptCheckpointError only when no
    valid candidate exists."""
    search_dir = search_dir or os.path.dirname(os.path.abspath(path))
    tried = []
    candidates = [path] + [c for c in find_checkpoints(search_dir)
                           if os.path.abspath(c) != os.path.abspath(path)]
    for cand in candidates:
        ok, reason = verify_checkpoint(cand)
        if ok:
            if tried:
                _logger.warning(
                    f'Checkpoint fallback: {", ".join(tried)} — using {cand} instead')
            state, meta = load_verified(cand)
            return state, meta, cand
        tried.append(f'{cand} ({reason})')
        _logger.warning(f'Checkpoint failed verification: {cand}: {reason}')
    raise CorruptCheckpointError(
        f'No valid checkpoint found (tried: {"; ".join(tried) or path})')


def resolve_auto_resume(directory: str) -> Optional[str]:
    """``--resume auto``: the newest valid checkpoint in ``directory``, or None."""
    for cand in find_checkpoints(directory):
        ok, reason = verify_checkpoint(cand)
        if ok:
            return cand
        _logger.warning(f'auto-resume skipping invalid checkpoint {cand}: {reason}')
    return None
