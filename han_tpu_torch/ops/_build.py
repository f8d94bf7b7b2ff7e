"""Build ``csrc/<name>.cu`` with nvcc into ``build/kernels/`` on first use and
load it with ctypes.

The library name carries a hash of the source, the headers under ``csrc/``
(``*.cuh``, which the sources include) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. There is no
fallback: a missing nvcc or a failed build raises. ptxas reports each
kernel's registers and spills (``-Xptxas -v``); the build keeps that report
beside the library (:func:`ptxas_report`), where a check can read, say, the
lines in which ptxas says it serialized a kernel's wgmma products.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of han_tpu_torch cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    data = b"".join(p.read_bytes() for p in parts) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(data)
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> list[pathlib.Path]:
    """Compile every csrc/<name>.cu whose library is not built yet, one nvcc
    process per source, all started together."""
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for so, tmp, cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{out}{err}")
        so.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return [library_path(name) for name in names]


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    return build_all([name])[0]


def ptxas_report(name: str) -> str:
    """What nvcc and ptxas printed when csrc/<name>.cu was built (built
    first if needed)."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
