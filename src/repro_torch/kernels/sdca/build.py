"""Build the SDCA kernel with ``nvcc`` and bind it with ``ctypes``.

The source (``csrc/sdca.cu``) has a plain C interface, so it compiles in
seconds into a shared library without PyTorch's headers.  The library goes
into ``build/`` beside this module (listed in ``.gitignore``) at first use,
named after a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``build`` starts one
``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "sdca.cu",)
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
#: what the last ``build`` did: seconds, whether it compiled, nvcc's log
LAST_BUILD: Dict[str, object] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the SDCA kernel builds on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{tag.hexdigest()[:12]}.so"


def build(sources: Sequence[Path] = SOURCES) -> Dict[Path, Path]:
    """Compile every source that has no up-to-date library, all at once.

    Returns ``{source: library}``; records seconds and nvcc's output
    (``-Xptxas -v``: registers and shared memory per kernel) in
    ``LAST_BUILD``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: _target(src) for src in sources}
    jobs = []
    for src, lib in targets.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    logs = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"$ nvcc {src.name}\n{out}")
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        os.replace(tmp, lib)   # atomic: concurrent builds agree
    LAST_BUILD.update(seconds=time.perf_counter() - t0,
                      compiled=[str(s) for s, *_ in jobs], log="".join(logs))
    return targets


def load() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[SOURCES[0]]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sdca_local_solve.argtypes = [P] * 11 + [I] * 7 + [P]
        lib.sdca_local_solve.restype = I
        lib.sdca_shared_bytes.argtypes = [I] * 4
        lib.sdca_shared_bytes.restype = ctypes.c_longlong
        lib.sdca_shared_limit.argtypes = [I]
        lib.sdca_shared_limit.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB
