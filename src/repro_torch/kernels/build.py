"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every source (``<kernel>/csrc/<kernel>.cu``) has a plain C interface, so it
compiles in seconds into a shared library without PyTorch's headers; the
Hopper helpers they share (mbarriers, TMA, wgmma) are in
``include/hopper.cuh``, and what the flash and cache attention kernels
share in ``include/attention.cuh``.  Nothing links ``libcuda``: the one
driver-API call,
``cuTensorMapEncodeTiled``, is looked up through the CUDA runtime.  The
libraries go into ``build/`` beside this module (listed in ``.gitignore``)
at first use, each named after a hash of its source, the shared headers
and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is.
``build`` starts one ``nvcc`` per source, all at once: the first kernel a
process loads builds all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Sequence

from repro_torch.utils.timing import tick

_HERE = Path(__file__).resolve().parent
#: kernel name -> its CUDA source
SOURCES: Dict[str, Path] = {
    name: _HERE / name / "csrc" / f"{name}.cu"
    for name in ("sdca", "flash_attention", "decode_attention",
                 "cache_attention")}
BUILD_DIR = _HERE / "build"
INCLUDE_DIR = _HERE / "include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: what the last ``build`` did: seconds, what it compiled, nvcc's log
LAST_BUILD: Dict[str, object] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes()
                       for h in sorted(INCLUDE_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{tag.hexdigest()[:12]}.so"


def build(sources: Sequence[Path] = tuple(SOURCES.values())
          ) -> Dict[Path, Path]:
    """Compile every source that has no up-to-date library, all at once.

    Returns ``{source: library}``; records seconds and nvcc's output
    (``-Xptxas -v``: registers and shared memory per kernel) in
    ``LAST_BUILD``.  Raises if any source fails to compile."""
    t0 = tick()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: _target(src) for src in sources}
    jobs = []
    for src, lib in targets.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", tmp,
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    logs, failed = [], []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"$ nvcc {src.name}\n{out}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src}:\n{out}")
        else:
            os.replace(tmp, lib)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    LAST_BUILD.update(seconds=tick() - t0,
                      compiled=[str(s) for s, *_ in jobs], log="".join(logs))
    return targets


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Kernel ``name``'s library, built at first use; ``bind`` sets its C
    signatures once, when the library is first opened."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[SOURCES[name]]))
        bind(lib)
        _LIBS[name] = lib
    return lib


def check_operand(name: str, t, shape, dtypes, device, align: int = 1
                  ) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    with a dtype in ``dtypes``, its data ``align``-byte aligned, as the
    kernels' C interfaces assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{tuple(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
