"""Build and load the port's hand-written CUDA kernels.

Each library is one source ``parler_tts_tpu_torch/csrc/<name>.cu`` whose
kernels have a plain C interface (``flash_attention_fwd.cu`` holds K1,
``flash_attention_bwd.cu`` K2-K4), plus the headers of ``csrc/`` it
includes (``sm90_mma.cuh``, the tensor-core building blocks both share).  It
is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
and loaded with ``ctypes``.  Libraries live in
``parler_tts_tpu_torch/_build/<hash>/``, where the hash covers the sources
and headers in ``csrc/`` and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded; ``nvcc``'s output is kept
beside each library as ``lib<name>.log``.  ``build`` and ``library`` also
take another source directory (a test builds a modified copy of the sources
that way).  Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[tuple[str, Path], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's kernels need it")
    return str(path)


def _library_path(name: str, csrc: Path = CSRC) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc).glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build(names, csrc: Path = CSRC) -> dict[str, str]:
    """Compile every named library of ``csrc`` that is missing, one ``nvcc``
    process per source, all started together.  Returns each library's
    ``nvcc`` output (registers, shared memory, spills), the kept log of a
    library built before; raises with the compiler's output if any build
    fails."""
    procs, logs = {}, {}
    for name in names:
        lib = _library_path(name, csrc)
        if lib.exists():
            log = lib.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            lib.with_suffix(".log").write_text(logs[name])  # before the library: it implies its log
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return logs


def library(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library ``name`` of ``csrc``, built first if needed."""
    key = (name, Path(csrc))
    if key not in _LIBS:  # the sources are hashed once, not at every launch
        build([name], csrc)
        _LIBS[key] = ctypes.CDLL(str(_library_path(name, csrc)))
    return _LIBS[key]
