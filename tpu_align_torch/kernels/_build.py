"""Build and load the port's CUDA kernels.

The sources under tpu_align_torch/csrc/ (the stagger fill, the banded
fill, the row-sweep fill, the walk with event compaction, the Hirschberg
split reduction, the elementwise DPX op layer and the s16x2 experiment's
core; the header dpx.cuh is part of the hash) are compiled by nvcc for
sm_90a into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), loaded with ctypes.  The library goes to
build/tpu_align_torch/<hash>/ at the repository root, keyed by a hash of
the sources and flags, and is built at first use: nothing is compiled when
a module is imported.  A build that fails raises; nothing falls back.
nvcc's output (including ptxas's register and spill report) is kept beside
the library as nvcc.log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("stagger_fill.cu", "banded_fill.cu", "stagger_walk.cu",
           "rowscan_fill.cu", "split_reduce.cu", "dpx_apply.cu",
           "s16x2_core.cu")
HEADERS = ("dpx.cuh",)
BUILD_ROOT = _PKG.parent / "build" / "tpu_align_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtpu_align_torch.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build tpu_align_torch's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as work:
        objs = [os.path.join(work, src + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        # link to a private name, then rename: a concurrent build never
        # loads a half-written library
        tmp = os.path.join(work, so.name)
        proc = subprocess.run(
            [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        (so.parent / "nvcc.log").write_text(log)
        os.replace(tmp, so)


def _configure(lib: ctypes.CDLL) -> None:
    # every pointer and the stream as c_void_p: a default ctypes int would
    # cut them to 32 bits
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "ta_torch_stagger_fill": [
            i32,                         # algo
            ptr, ptr, ptr, ptr,          # ref, qry, ref_len, qry_len
            ptr,                         # open_top
            i32, i32, i32, i32, i32,     # B, N, M, S, W
            i32, i32, i32, i32, i32,     # match, mismatch, gap, open, extend
            i32,                         # with_dirs
            ptr, ptr,                    # hrow, frow
            ptr, ptr, ptr, ptr,          # score, srow, scol, dirs
            ptr,                         # stream
        ],
        "ta_torch_banded_fill": [
            ptr, ptr, ptr, ptr,          # ref, qry, ref_len, qry_len
            i32, i32, i32, i32, i32,     # B, N, M, K8, band
            i32, i32, i32,               # match, mismatch, gap
            i32,                         # with_dirs
            ptr, ptr, ptr, ptr,          # score, srow, scol, dirs
            ptr,                         # scratch
            ptr,                         # stream
        ],
        "ta_torch_banded_scratch_words": [i32, i32],  # B, K8
        "ta_torch_walk": [
            i32,                         # algo
            ptr, ptr, ptr, ptr,          # dirs, start_row, start_col, score
            i32, i32, i32, i32, i32,     # B, S, W, K8, band
            i32, i32,                    # T16, ev_max
            i32, i32, i32,               # match, mismatch, gap
            ptr, ptr, ptr,               # packed, slots, nev
            ptr,                         # stream
        ],
        # algo, mode, B, N, M, band rows
        "ta_torch_rowscan_scratch_words": [i32, i32, i32, i32, i32, i32],
        # algo, mode, band rows
        "ta_torch_rowscan_resident_warps": [i32, i32, i32],
        "ta_torch_rowscan_fill": [
            i32, i32, i32,               # algo, mode, band rows
            ptr, ptr, ptr, ptr,          # ref, qry, ref_len, qry_len
            ptr,                         # open_top
            i32, i32, i32,               # B, N, M
            i32, i32, i32, i32, i32,     # match, mismatch, gap, open, extend
            i32,                         # band
            ptr,                         # scratch
            ptr, ptr, ptr,               # score, srow, scol
            ptr, ptr, ptr,               # dirs, hlast, flast
            ptr,                         # scores_cells: a device uint64
            ptr,                         # stream
            ctypes.POINTER(i32),         # warps: the launch's persistent warps
        ],
        "ta_torch_split_reduce": [
            ptr, ptr,                    # hlast, flast
            ptr, ptr, ptr, ptr,          # fhb, bhb, nn, go
            i32, i32, i32,               # n, K2, K
            ptr,                         # state
            ptr,                         # out
            ptr,                         # stream
        ],
        # n, K2, K, affine
        "ta_torch_split_reduce_state_words": [i32, i32, i32, i32],
        "ta_torch_compact_events": [
            ptr, ptr,                    # slots, nev
            i32, i32, i32,               # B, ev_max, cap
            ptr, ptr,                    # flat, meta
            ptr,                         # stream
        ],
        "ta_torch_dpx_apply": [
            i32,                         # op
            ptr, ptr, ptr, ptr,          # a, b, c, out
            ptr, ptr,                    # pred_hi, pred_lo
            ctypes.c_longlong,           # n
            ptr,                         # stream
        ],
        "ta_torch_s16x2_core": [
            ptr, i32, i32, i32,          # x, b, steps, packed
            ptr,                         # out
            ptr,                         # stream
        ],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = argtypes
    lib.ta_torch_rowscan_scratch_words.restype = ctypes.c_longlong
    lib.ta_torch_banded_scratch_words.restype = ctypes.c_longlong
    lib.ta_torch_split_reduce_state_words.restype = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if the current sources
    have not been built yet."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            _configure(lib)
            _lib = lib
        return _lib
