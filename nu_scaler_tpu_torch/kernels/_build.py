"""Build and load the port's CUDA kernels.

All kernel code is one source, `csrc/resample_fused.cu`, with a plain C
interface. It is compiled by one `nvcc` call into a shared library under
``build/nu_scaler_tpu_torch/`` at the root of the checkout and loaded with
`ctypes`; no PyTorch headers are involved, so the build takes seconds. The
library's name carries a hash of the source and the flags, so a changed source
is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first CUDA launch calls `load_library`.
The CPU paths never reach this module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "resample_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nu_scaler_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_TIMEOUT_S = 300

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME, else under /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libresample_fused_{digest[:16]}.so"


def _compile(nvcc: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    print(f"nvcc built {out.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    if proc.stderr.strip():
        print(proc.stderr.strip(), flush=True)  # -Xptxas=-v: registers, spills, smem


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every function's
    argtypes and restype declared."""
    out = library_path()
    if not out.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: "
                "the CUDA kernels cannot be built"
            )
        _compile(nvcc, out)
    lib = ctypes.CDLL(str(out))
    lib.nu_resample_fused.argtypes = [
        _INT, _VP, _INT, _INT, _INT,  # device, src, n, h, w
        _VP, _VP, _INT,  # first_v, w_v, kv
        _VP, _VP, _INT,  # first_h, w_h, kh
        _INT, _INT, _INT, _INT, _INT,  # oh, ow, tile_h, tile_w, smem_bytes
        _VP, _INT, _F32, _F32,  # prev, n_ts, t0, t1
        _VP, _VP, _VP, _VP,  # dst, mid0, mid1, stream
    ]
    lib.nu_resample_fused.restype = _INT
    lib.nu_cuda_error_string.argtypes = [_INT]
    lib.nu_cuda_error_string.restype = ctypes.c_char_p
    return lib
