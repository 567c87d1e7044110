"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` has a plain C interface. It is compiled by
one `nvcc` call into its own shared library under
``build/nu_scaler_tpu_torch/`` at the root of the checkout and loaded with
`ctypes`; no PyTorch headers are involved, so a build takes seconds. A
library's name carries a hash of its source, of every header the source
includes with quotes (`conv3x3_core.cuh`), and of the flags, so a changed
source or header is rebuilt and an unchanged one is reused.

The runtime's two host libraries (`runtime/native/framering.cpp`, the frame
ring, and `y4m.cpp`, the Y4M demuxer; no device code) are built the same way
by one `g++` call each (`HOST_SIGNATURES`, `GXX_FLAGS`), under the same key
and into the same directory.

Nothing here runs at import time: the first CUDA launch of a kernel, or the
first use of a host library, calls `load_library(name)`. `build()` starts one
compiler per source at once, for a caller that wants every library ready
before its first use. The CPU paths of the kernels never reach this module.

From the command line (the counterpart of ``python -m
nu_scaler_tpu.runtime.native.build``), every library, or the ones named,
built ahead of first use, each path printed; ``--force`` rebuilds:

    python -m nu_scaler_tpu_torch.kernels._build [--force] [name ...]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional

from nu_scaler_tpu_torch.utils.tracing import span

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parents[1] / "runtime" / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nu_scaler_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# no -march=native: a library built on one host may run on another
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
NVCC_TIMEOUT_S = 300
# nvcc's messages (-Xptxas=-v: registers, spills, shared memory per kernel) of
# each library built by this process
BUILD_LOGS: dict = {}

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

# Every library: its C entry points and their argument types. Each source also
# defines `nu_cuda_error_string(int) -> const char*`.
SIGNATURES = {
    "resample_fused": {
        "nu_resample_fused": [
            _INT, _VP, _INT, _INT, _INT,  # device, src, n, h, w
            _VP, _INT, _VP, _INT,  # first_v, kv, first_h, kh
            _INT, _INT, _INT, _INT,  # oh, ow, tile_h, tile_w
            _INT, _INT, _INT, _INT, _INT, _INT,  # fr, fc, wv, wh, nbuf, smem_bytes
            _VP, _VP, _VP, _VP,  # band tables: vertical weights, starts; horizontal weights, starts
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
            _INT, _INT,  # row0, rows
            _VP, _VP,  # out, stream
        ],
    },
    "fsr": {
        "nu_fsr": [
            _INT, _VP, _INT, _INT, _INT, _INT,  # device, src, n, h, w, scale
            _F32, _INT, _VP, _VP,  # sharp, mix, dst, stream
        ],
    },
    "conv3x3": {
        "nu_conv3x3": [
            _INT, _VP, _VP, _VP, _VP,  # device, x, k (packed), b, out
            _INT, _INT, _INT, _INT, _INT, _INT, _INT,  # n, h, w, cin, cout, relu, round_sum
            _VP,  # stream
        ],
        "nu_conv3x3_q": [
            _INT, _VP, _VP, _VP, _VP, _VP,  # device, x, k (packed), scale, b (or NULL), out
            _INT, _INT, _INT, _INT, _INT, _INT,  # n, h, w, cin, cout, relu
            _VP,  # stream
        ],
    },
    "trunk_fused": {
        "nu_trunk_fused": [
            _INT, _VP, _VP, _VP, _INT,  # device, x, packed kernels[depth], biases[depth], depth
            _VP, _VP, _VP, _VP, _VP,  # feat, h, t, ready flags, out
            _INT, _INT, _INT, _INT, _INT, _INT, _INT,  # n, h, w, cin, cmid, cout, blocks
            _INT, _INT,  # grid, round_sum
            _VP,  # stream
        ],
    },
    "rrdb_conv": {
        "nu_rrdb_conv": [
            _INT, _VP, _INT, _INT, _INT,  # device, x and its image, plane and position strides
            _INT, _INT, _INT, _INT, _INT,  # n, h, w, c_total, cin
            _VP, _VP, _INT,  # packed weights, bias, cout
            _VP, _INT, _INT, _INT,  # out and its strides
            _INT, _F32,  # lrelu, slope
            _VP, _INT, _INT, _INT, _F32,  # r1, its strides, s1
            _VP, _INT, _INT, _INT, _F32,  # r2, its strides, s2
            _VP,  # stream
        ],
    },
    "resample_twopass": {
        "nu_resample_vert": [
            _INT, _VP, _INT, _INT, _INT,  # device, src, n, h, w
            _VP, _VP, _INT, _INT,  # first_v, w_v, kv, oh
            _VP, _VP,  # mid, stream
        ],
        "nu_resample_horiz": [
            _INT, _VP, _INT, _INT, _INT,  # device, mid, n, oh, w
            _VP, _VP, _INT, _INT,  # first_h, w_h, kh, ow
            _VP, _VP,  # dst, stream
        ],
    },
}


_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# The host libraries: each C entry point's (restype, argtypes).
HOST_SIGNATURES = {
    "framering": {
        "nu_ring_create": (_VP, [_U32]),  # capacity
        "nu_ring_destroy": (None, [_VP]),
        "nu_ring_push": (None, [_VP, _U8P, _U32, _U32]),  # ring, rgba, width, height
        # ring, out, max bytes; width, height, truncated (out)
        "nu_ring_latest": (_INT, [_VP, _U8P, _U64, ctypes.POINTER(_U32), ctypes.POINTER(_U32),
                                  ctypes.POINTER(_INT)]),
        "nu_ring_pushed": (_U64, [_VP]),
        "nu_ring_dropped": (_U64, [_VP]),
        "nu_bgra_to_rgba": (None, [_U8P, _U8P, _U64]),  # src, dst, pixels
        "nu_test_pattern": (None, [_U8P, _U32, _U32, _U32]),  # dst, width, height, tick
    },
    "y4m": {
        # path; width, height, fps (out)
        "nu_y4m_open": (_VP, [ctypes.c_char_p, ctypes.POINTER(_U32), ctypes.POINTER(_U32),
                              ctypes.POINTER(ctypes.c_double)]),
        "nu_y4m_next": (_INT, [_VP, _U8P]),  # 1 a frame, 0 the end, -1 a broken stream
        "nu_y4m_rewind": (None, [_VP]),
        "nu_y4m_close": (None, [_VP]),
    },
}


# What building or loading a host library raises: no compiler, a failed or
# timed-out compile, a library the loader refuses. The runtime records it and
# serves its pure-Python stand-in.
HOST_BUILD_ERRORS = (OSError, RuntimeError, subprocess.SubprocessError)


def source_path(name: str) -> Path:
    if name in HOST_SIGNATURES:
        return NATIVE / f"{name}.cpp"
    if name not in SIGNATURES:
        raise ValueError(f"unknown kernel library {name!r}; known: "
                         f"{sorted(SIGNATURES)} and the host libraries {sorted(HOST_SIGNATURES)}")
    return CSRC / f"{name}.cu"


def _flags(name: str) -> tuple:
    return GXX_FLAGS if name in HOST_SIGNATURES else NVCC_FLAGS


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME, else under /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _compiler(name: str) -> str:
    """The compiler of a library: g++ for a host library, else nvcc; raises
    when it is missing."""
    if name in HOST_SIGNATURES:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the host library {name!r} cannot be built")
        return gxx
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: "
            "the CUDA kernels cannot be built"
        )
    return nvcc


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """The library's source and every file it includes with quotes, each
    once, in the order they are first met (an include is read relative to
    the file that names it, as nvcc reads it)."""
    files, todo = [], [source_path(name)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(compiler: str, name: str) -> float:
    """One compiler call for one source; returns its seconds. Raises with
    the compiler's errors if it fails."""
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *_flags(name), "-o", str(tmp), str(source_path(name))]
    tool = Path(compiler).name
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    seconds = time.perf_counter() - t0
    BUILD_LOGS[name] = proc.stderr
    print(f"{tool} built {out.name} in {seconds:.2f} s", flush=True)
    if proc.stderr.strip():
        print(proc.stderr.strip(), flush=True)  # -Xptxas=-v: registers, spills, smem
    return seconds


def build(names: Iterable[str] = tuple(SIGNATURES), force: bool = False) -> dict:
    """Compile every named library that is not built yet (every one with
    `force`), one compiler process per source, all started together.
    Returns {name: seconds} for the ones built; raises with the compiler's
    errors if any build fails."""
    todo = [n for n in names if force or not library_path(n).is_file()]
    if not todo:
        return {}
    compilers = {name: _compiler(name) for name in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        jobs = {name: pool.submit(_compile, compilers[name], name) for name in todo}
    return {name: job.result() for name, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel or host library, with every
    function's argtypes and restype declared. Traced as ``nu.setup.kernels``
    (`library`, and `compiled`: whether a compiler ran)."""
    with span("nu.setup.kernels", library=name) as s:
        s.set(compiled=bool(build([name])))
        lib = ctypes.CDLL(str(library_path(name)))
        if name in HOST_SIGNATURES:
            for fn_name, (restype, argtypes) in HOST_SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            return lib
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _INT
        lib.nu_cuda_error_string.argtypes = [_INT]
        lib.nu_cuda_error_string.restype = ctypes.c_char_p
        return lib


def main(argv=None) -> int:
    """Build the named libraries (all of `SIGNATURES` and `HOST_SIGNATURES`
    by default) into `BUILD_DIR` and print each one's path."""
    every = (*SIGNATURES, *HOST_SIGNATURES)
    p = argparse.ArgumentParser(description="Build the port's CUDA kernel libraries (nvcc) and host "
                                "libraries (g++) ahead of first use; print each library's path.")
    p.add_argument("names", nargs="*", metavar="name", help=f"the libraries to build (default: all of {every})")
    p.add_argument("--force", action="store_true", help="rebuild even where the library is built")
    args = p.parse_args(argv)
    unknown = [n for n in args.names if n not in every]
    if unknown:
        p.error(f"unknown libraries {unknown}; known: {every}")
    names = args.names or every
    build(names, force=args.force)
    for name in names:
        print(library_path(name), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
