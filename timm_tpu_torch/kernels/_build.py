# no-kernel-registry: infrastructure module — builds and loads the kernels, defines none
"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C interface.
``load_library(name)`` compiles ``csrc/<name>.cu`` (or ``<source_dir>/<name>.cu``)
with ``nvcc`` for sm_90a
into a shared library under ``build/`` (listed in ``.gitignore``), loads it
with ``ctypes`` and caches it for the process. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import time:
the CPU tests import every module of the port and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

__all__ = ['BuiltLibrary', 'find_nvcc', 'load_library', 'loaded_libraries', 'nvcc_command']

_HERE = Path(__file__).resolve().parent
SOURCE_DIR = _HERE / 'csrc'
BUILD_DIR = _HERE / 'build'

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)


@dataclass
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""
    name: str
    lib: ctypes.CDLL
    path: Path
    built: bool            # False when an identical build was already on disk
    build_seconds: float   # nvcc wall time, 0.0 when not built in this process
    log: str               # nvcc/ptxas output (registers, shared memory, spills)


_LIBS: Dict[Path, BuiltLibrary] = {}
_LOCK = threading.Lock()                  # guards _LOCKS
_LOCKS: Dict[Path, threading.Lock] = {}  # one per source: builds of two kernels run side by side


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        'nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): '
        'the CUDA kernels of timm_tpu_torch are built from source at first use')


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, '-o', str(output), str(source)]


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, source_dir: Path = SOURCE_DIR) -> BuiltLibrary:
    """Build (if needed) and load ``<source_dir>/<name>.cu``; raises if nvcc
    is missing or the build fails, with the compiler's output. Calls for
    different sources from different threads build in parallel."""
    source = Path(source_dir) / f'{name}.cu'
    with _LOCK:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LIBS:
            return _LIBS[source]
        if not source.is_file():
            raise FileNotFoundError(f'kernel source {source} does not exist')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f'{name}-{_digest(source)}.so'
        log_path = target.with_suffix('.log')  # the compiler's report, kept beside the build
        built, seconds = False, 0.0
        log = log_path.read_text() if log_path.exists() else ''
        if not target.exists():
            nvcc = find_nvcc()
            tmp = target.with_suffix(f'.{os.getpid()}.tmp.so')
            t0 = time.perf_counter()
            proc = subprocess.run(nvcc_command(nvcc, source, tmp),
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'nvcc failed to build {source} '
                                   f'(exit {proc.returncode}):\n{log}')
            log_path.write_text(log)
            os.replace(tmp, target)  # atomic: a reader never sees half a library
            built = True
        entry = BuiltLibrary(name, ctypes.CDLL(str(target)), target, built, seconds, log)
        _LIBS[source] = entry
        return entry


def loaded_libraries() -> Dict[Path, BuiltLibrary]:
    """{source: library} of every kernel library this process has loaded."""
    return dict(_LIBS)
