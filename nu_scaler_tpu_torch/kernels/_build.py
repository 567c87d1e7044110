"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` has a plain C interface. It is compiled by
one `nvcc` call into its own shared library under
``build/nu_scaler_tpu_torch/`` at the root of the checkout and loaded with
`ctypes`; no PyTorch headers are involved, so a build takes seconds. A
library's name carries a hash of its source and the flags, so a changed
source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first CUDA launch of a kernel calls
`load_library(name)`. `build()` starts one `nvcc` per source at once, for a
caller that wants every kernel ready before its first launch. The CPU paths
never reach this module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nu_scaler_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_TIMEOUT_S = 300

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

# Every library: its C entry points and their argument types. Each source also
# defines `nu_cuda_error_string(int) -> const char*`.
SIGNATURES = {
    "resample_fused": {
        "nu_resample_fused": [
            _INT, _VP, _INT, _INT, _INT,  # device, src, n, h, w
            _VP, _VP, _INT,  # first_v, w_v, kv
            _VP, _VP, _INT,  # first_h, w_h, kh
            _INT, _INT, _INT, _INT, _INT,  # oh, ow, tile_h, tile_w, smem_bytes
            _VP, _INT, _F32, _F32,  # prev, n_ts, t0, t1
            _VP, _VP, _VP, _VP,  # dst, mid0, mid1, stream
        ],
    },
    "soft_warp": {
        "nu_soft_warp_blend": [
            _INT, _VP, _VP, _INT, _INT,  # device, a, b, h, w
            _VP, _VP, _VP, _INT,  # tiles, assign, cand, k
            _INT, _INT, _F32, _F32,  # th, tw, inv_th, inv_tw
            _F32, _F32,  # weight of a, weight of b
            _VP, _VP,  # out, stream
        ],
    },
    "fsr": {
        "nu_fsr": [
            _INT, _VP, _INT, _INT, _INT, _INT,  # device, src, n, h, w, scale
            _F32, _INT, _VP, _VP,  # sharp, mix, dst, stream
        ],
    },
}


def source_path(name: str) -> Path:
    if name not in SIGNATURES:
        raise ValueError(f"unknown kernel library {name!r}; known: {sorted(SIGNATURES)}")
    return CSRC / f"{name}.cu"


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME, else under /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _compile(nvcc: str, name: str) -> float:
    """One `nvcc` call for one source; returns its seconds. Raises with
    nvcc's errors if it fails."""
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    seconds = time.perf_counter() - t0
    print(f"nvcc built {out.name} in {seconds:.2f} s", flush=True)
    if proc.stderr.strip():
        print(proc.stderr.strip(), flush=True)  # -Xptxas=-v: registers, spills, smem
    return seconds


def build(names: Iterable[str] = tuple(SIGNATURES)) -> dict:
    """Compile every named library that is not built yet, one `nvcc` process
    per source, all started together. Returns {name: seconds} for the ones
    built; raises with nvcc's errors if any build fails."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: "
            "the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        jobs = {name: pool.submit(_compile, nvcc, name) for name in todo}
    return {name: job.result() for name, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, with every function's
    argtypes and restype declared."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.nu_cuda_error_string.argtypes = [_INT]
    lib.nu_cuda_error_string.restype = ctypes.c_char_p
    return lib
