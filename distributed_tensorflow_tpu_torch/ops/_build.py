"""Build the CUDA sources in ``ops/csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into
``distributed_tensorflow_tpu_torch/_build/`` (a build output, listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name carries
a hash of its source, the headers beside it and the flags, so an edited
source or header rebuilds and an unchanged one is reused. ``build_all``
starts one ``nvcc`` per source, all at once. A failed build raises with
nvcc's stderr.

Nothing here runs at import: the CPU tests import every module, and this
host need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels build on a machine with the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the file name carries a hash of
    the source, of every header in ``csrc/`` (``*.cuh``), and of the
    flags, so editing any of them rebuilds."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build every named source (default: all of ``csrc/*.cu``) that has no
    current library, one ``nvcc`` process per source started together.
    Returns {name: nvcc's stderr} for the sources built now (``-Xptxas -v``
    puts each kernel's registers, shared memory and spills there)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    logs, failures = {}, []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):"
                            f"\n{out}{err}")
            continue
        library_path(n).with_suffix(".log").write_text(out + err)
        os.replace(tmp, library_path(n))
        logs[n] = out + err
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def build_log(name: str) -> str:
    """nvcc's output from the build of the current ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
