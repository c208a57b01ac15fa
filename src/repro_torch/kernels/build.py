"""Build and load the port's hand-written CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers in the build, so it takes seconds, not
minutes). The build runs at first use, from the repo's sources only, into
``build/kernels/<hash of sources and flags>/`` at the repo root (listed in
``.gitignore``); each source compiles in its own ``nvcc`` process, all
started together, then one link. A later call with unchanged sources loads
the cached library.

Importing this module needs no ``nvcc`` and no GPU: only ``load_library``
does, and the kernel wrappers call it only for CUDA tensors.
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
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entry points (csrc/attention_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_key() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on a machine with the CUDA toolkit"
    )


def library_path() -> Path:
    return BUILD_ROOT / _build_key() / LIB_NAME


def build() -> Path:
    """Compile the kernels if the cached library for these sources is
    missing; return its path. The compiler's register/shared-memory report
    (``-Xptxas -v``) is kept beside the library as ``ptxas.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp_lib, out)   # atomic: concurrent builds race safely
    return out


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every C entry point's argument types: c_void_p for each pointer and the
# stream, c_int for each int, c_float for each float; each returns an int
ARGTYPES = {
    "repro_paged_attention": [_VP] * 11 + [_I] * 11 + [_F, _F, _I, _VP],
    "repro_chunked_prefill": [_VP] * 7 + [_I] * 9 + [_F, _F, _I, _VP],
    "repro_shared_prefix": [_VP] * 8 + [_I] * 11 + [_F, _F, _I, _VP],
    "repro_flash_attention": [_VP] * 7 + [_I] * 7 + [_F, _F, _I, _VP],
    "repro_decode_attention": [_VP] * 7 + [_I] * 8 + [_F, _F, _I, _VP],
    "repro_ssd_chunk": [_VP] * 8 + [_I] * 7 + [_VP],
}


def declare(lib: ctypes.CDLL, name: str) -> None:
    """Set entry point ``name``'s argument and result types on ``lib``."""
    fn = getattr(lib, name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = _I


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's argument types declared (``ARGTYPES``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ARGTYPES:
                declare(lib, name)
            _lib = lib
    return _lib


def require(where: str, cond: bool, msg: str) -> None:
    """Input check of a kernel binding: raise ValueError unless ``cond``."""
    if not cond:
        raise ValueError(f"{where}: {msg}")


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_sms(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count
