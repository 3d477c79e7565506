"""The port's ctypes binding to the native host runtime (native/tpualign.cpp).

The port's own counterpart of tpu_align/native/binding.py, with only the
wrappers the port calls.  The library is compiled by g++ from
native/tpualign.cpp at first use -- nothing is built when a module is
imported -- into build/tpu_align_torch/native-<hash>/libtpualign.so at the
repository root, keyed by a hash of the source, the flags and the host
CPU (the flags hold -march=native, so a library never reaches a CPU it
was not built for).  Like kernels/_build.py it compiles in a private
temporary directory and moves the library into place with one
os.replace, so a concurrent process never loads a half-written file.

Every wrapper returns None when the library cannot be built or loaded
(`available()` is False; `require()` raises with the reason), as the JAX
package's do: the copied io modules then take their numpy paths, and the
port's walk, replay and formatting callers raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "tpualign.cpp"
BUILD_ROOT = _REPO / "build" / "tpu_align_torch"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread")

_lock = threading.Lock()
_lib = None
_error: str | None = None

_ALGO_CODE = {"lnw": 0, "lsw": 1, "anw": 2, "bsw": 3}


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.machine().encode()


def library_path() -> Path:
    """Where the library for the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libtpualign.so"


def _compile(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as work:
        tmp = os.path.join(work, so.name)
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
             str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)


def _load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                so = library_path()
                if not so.exists():
                    _compile(so)
                lib = ctypes.CDLL(str(so))
                _configure(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = str(e)
        return _lib


def available() -> bool:
    """True when the library is built (now, if need be) and loaded."""
    return _load() is not None


def require(why: str) -> None:
    """Raise RuntimeError, with the build's error, unless the library is
    available; `why` names what the caller cannot do without it."""
    if not available():
        raise RuntimeError(f"native library unavailable ({why}): {_error}")


def _configure(lib) -> None:
    i64 = ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(i64)
    c_int, c_char_p = ctypes.c_int, ctypes.c_char_p
    signatures = {
        "ta_traceback_bucket": (c_int, [
            c_int, i64, i64, i64, i64, i64, i64, i64, i64,
            c_int, c_int, c_int, c_int, i64,
            i32p,                        # dirs
            u8p, u8p,                    # ref_tokens, qry_tokens
            i32p, i32p,                  # ref_len, qry_len
            i32p, i32p, i32p,            # start_row, start_col, scores
            c_char_p, i64, i32p,         # out_buf, out_stride, out_lens
            c_int,                       # num_threads
        ]),
        "ta_replay_moves": (c_int, [
            i64, i64, i64, i64, i64, c_int,
            i32p,                        # moves
            u8p, u8p,                    # ref_tokens, qry_tokens
            i32p, i32p, i32p,            # start_row, start_col, scores
            c_char_p, i64, i32p,         # out_buf, out_stride, out_lens
            c_int,                       # num_threads
        ]),
        "ta_replay_events": (c_int, [
            i64, i64, i64, c_int, c_int, c_int, c_int,
            u16p, i64p,                  # events (flat), ev_off
            u8p, u8p,                    # ref_tokens, qry_tokens
            i32p, i32p, i32p,            # start_row, start_col, scores
            c_char_p, i64, i32p,         # out_buf, out_stride, out_lens
            i32p,                        # out_scores (nullable)
            c_int,                       # num_threads
        ]),
        "ta_replay_events_blocks": (c_int, [
            i64, i64, i64, c_int, c_int, c_int, c_int,
            u16p, i64p,                  # events (flat), ev_off
            u8p, u8p,                    # ref_tokens, qry_tokens
            i32p, i32p, i32p,            # start_row, start_col, scores
            i64p,                        # pair_ids
            c_char_p, i64,               # chunk, blk_stride
            i64p, i64p,                  # dst_off (nullable), spans
            c_int,                       # num_threads
        ]),
        "ta_events_block_lens": (None, [
            i64, u16p, i64p,             # B, events (flat), ev_off
            i32p, i64p, i32p,            # start_row, pair_ids, scores
            i64p,                        # lens
        ]),
        "ta_format_blocks": (i64, [
            i64, i32p, i32p,             # B, pair_ids, scores
            c_char_p, i64, i32p,         # out_buf, out_stride, out_lens
            c_char_p, i64, i64p,         # dst, dst_cap, spans
            c_int,                       # num_threads
        ]),
        "ta_gather_spans": (i64, [
            c_char_p, i64p, i64p, i64,   # src, spans, order, count
            c_char_p,                    # dst
        ]),
        "ta_gather_parts": (i64, [
            ctypes.POINTER(c_char_p),    # srcs
            i64p, i32p, i64p, i64,       # spans, part_of, order, count
            c_char_p, c_int,             # dst, num_threads
        ]),
        "ta_gather_padded": (None, [
            u8p, i64p, i64p, i64, i64, c_int, u8p, c_int,
        ]),
        "ta_count_pairs": (i64, [u8p, i64]),
        "ta_parse_pairs": (i64, [
            u8p, i64, i64, i64p, i64p, i64p, i64p, c_int,
        ]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_traceback_bucket(
    algorithm_value: str,
    dirs: np.ndarray,        # (MW, B_total, N) int32, C-contiguous, or
    #                          (stripes, W, S, B_total) when stagger > 0
    ref_tokens: np.ndarray,  # (B, N) uint8, B <= B_total
    qry_tokens: np.ndarray,  # (B, M) uint8
    ref_len: np.ndarray,     # (B,) int32
    qry_len: np.ndarray,
    start_row: np.ndarray,
    start_col: np.ndarray,
    scores: np.ndarray,
    num_threads: int = 0,
    skew_band: int = 0,
    stagger: int = 0,
    bits: int = 4,
    match: int = 3,
    mismatch: int = -1,
    gap: int = -2,
):
    """Walk a whole bucket natively.  Returns (out_buf, out_lens) where
    out_buf is (B, 3, stride) uint8 with left-aligned ref/rel/qry strings of
    length out_lens[b].  None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if stagger > 0:
        _, stag_w, _, b_total = dirs.shape
        mw, dirs_cols = 0, 0
    else:
        mw, b_total, dirs_cols = dirs.shape
        stag_w = 0
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    stride = m + n
    dirs = np.ascontiguousarray(dirs, np.int32)
    ref_tokens = np.ascontiguousarray(ref_tokens, np.uint8)
    qry_tokens = np.ascontiguousarray(qry_tokens, np.uint8)
    ref_len = np.ascontiguousarray(ref_len, np.int32)
    qry_len = np.ascontiguousarray(qry_len, np.int32)
    start_row = np.ascontiguousarray(start_row, np.int32)
    start_col = np.ascontiguousarray(start_col, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    out_buf = np.zeros((b, 3, stride), np.uint8)
    out_lens = np.zeros(b, np.int32)
    rc = lib.ta_traceback_bucket(
        _ALGO_CODE[algorithm_value], b, b_total, mw, n, dirs_cols,
        skew_band, stagger, stag_w, bits, match, mismatch, gap, m,
        _ptr(dirs, ctypes.c_int32),
        _ptr(ref_tokens, ctypes.c_uint8), _ptr(qry_tokens, ctypes.c_uint8),
        _ptr(ref_len, ctypes.c_int32), _ptr(qry_len, ctypes.c_int32),
        _ptr(start_row, ctypes.c_int32), _ptr(start_col, ctypes.c_int32),
        _ptr(scores, ctypes.c_int32),
        out_buf.ctypes.data_as(ctypes.c_char_p), stride,
        _ptr(out_lens, ctypes.c_int32), num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"ta_traceback_bucket failed: {rc}")
    return out_buf, out_lens


def native_replay_moves(
    moves: np.ndarray,       # (T16, B_total) int32 packed 2-bit codes
    ref_tokens: np.ndarray,  # (B, N) uint8, B <= B_total
    qry_tokens: np.ndarray,  # (B, M) uint8
    start_row: np.ndarray,
    start_col: np.ndarray,
    scores: np.ndarray,
    local: bool,
    num_threads: int = 0,
):
    """Replay device-walk move streams into alignment strings (threaded).
    Returns (out_buf (B, 3, stride) uint8, out_lens) or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t16, b_total = moves.shape
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    stride = m + n
    moves = np.ascontiguousarray(moves, np.int32)
    ref_tokens = np.ascontiguousarray(ref_tokens, np.uint8)
    qry_tokens = np.ascontiguousarray(qry_tokens, np.uint8)
    start_row = np.ascontiguousarray(start_row, np.int32)
    start_col = np.ascontiguousarray(start_col, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    out_buf = np.zeros((b, 3, stride), np.uint8)
    out_lens = np.zeros(b, np.int32)
    rc = lib.ta_replay_moves(
        b, b_total, t16, n, m, 1 if local else 0,
        _ptr(moves, ctypes.c_int32),
        _ptr(ref_tokens, ctypes.c_uint8), _ptr(qry_tokens, ctypes.c_uint8),
        _ptr(start_row, ctypes.c_int32), _ptr(start_col, ctypes.c_int32),
        _ptr(scores, ctypes.c_int32),
        out_buf.ctypes.data_as(ctypes.c_char_p), stride,
        _ptr(out_lens, ctypes.c_int32), num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"ta_replay_moves failed: {rc}")
    return out_buf, out_lens


def native_replay_events(
    events: np.ndarray,      # flat uint16 payloads (row << 1 | is_ins)
    ev_off: np.ndarray,      # (B + 1,) int64: lane b at [off[b], off[b+1])
    ref_tokens: np.ndarray,  # (B, N) uint8
    qry_tokens: np.ndarray,  # (B, M) uint8
    start_row: np.ndarray,
    start_col: np.ndarray,
    scores: np.ndarray,
    local: bool,
    match: int, mismatch: int, gap: int,
    num_threads: int = 0,
):
    """Replay event-compacted device-walk streams (the compaction kernel's
    flat layout) into alignment strings (threaded).  Returns
    (out_buf (B, 3, stride) uint8, out_lens) or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    stride = m + n
    events = np.ascontiguousarray(events, np.uint16)
    ev_off = np.ascontiguousarray(ev_off, np.int64)
    ref_tokens = np.ascontiguousarray(ref_tokens, np.uint8)
    qry_tokens = np.ascontiguousarray(qry_tokens, np.uint8)
    start_row = np.ascontiguousarray(start_row, np.int32)
    start_col = np.ascontiguousarray(start_col, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    out_buf = np.zeros((b, 3, stride), np.uint8)
    out_lens = np.zeros(b, np.int32)
    rc = lib.ta_replay_events(
        b, n, m, 1 if local else 0, match, mismatch, gap,
        _ptr(events, ctypes.c_uint16), _ptr(ev_off, ctypes.c_int64),
        _ptr(ref_tokens, ctypes.c_uint8), _ptr(qry_tokens, ctypes.c_uint8),
        _ptr(start_row, ctypes.c_int32), _ptr(start_col, ctypes.c_int32),
        _ptr(scores, ctypes.c_int32),
        out_buf.ctypes.data_as(ctypes.c_char_p), stride,
        _ptr(out_lens, ctypes.c_int32), None, num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"ta_replay_events failed: {rc}")
    return out_buf, out_lens


def native_events_block_lens(
    events: np.ndarray,      # flat uint16 payloads
    ev_off: np.ndarray,      # (B + 1,) int64
    start_row: np.ndarray,   # (B,)
    pair_ids: np.ndarray,    # (B,)
    scores: np.ndarray,      # (B,)
):
    """Exact formatted block length per pair, derived from events alone
    (GLOBAL walks: aligned length = start_row + #insertions).  Returns
    (B,) int64 or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    b = int(start_row.shape[0])
    events = np.ascontiguousarray(events, np.uint16)
    ev_off = np.ascontiguousarray(ev_off, np.int64)
    start_row = np.ascontiguousarray(start_row, np.int32)
    pair_ids = np.ascontiguousarray(pair_ids, np.int64)
    scores = np.ascontiguousarray(scores, np.int32)
    lens = np.empty(b, np.int64)
    lib.ta_events_block_lens(
        b, _ptr(events, ctypes.c_uint16), _ptr(ev_off, ctypes.c_int64),
        _ptr(start_row, ctypes.c_int32), _ptr(pair_ids, ctypes.c_int64),
        _ptr(scores, ctypes.c_int32), _ptr(lens, ctypes.c_int64),
    )
    return lens


def native_replay_events_blocks(
    events: np.ndarray,      # flat uint16 payloads
    ev_off: np.ndarray,      # (B + 1,) int64
    ref_tokens: np.ndarray,  # (B, N) uint8
    qry_tokens: np.ndarray,  # (B, M) uint8
    start_row: np.ndarray,
    start_col: np.ndarray,
    scores: np.ndarray,
    pair_ids: np.ndarray,    # (B,) int64
    local: bool,
    match: int, mismatch: int, gap: int,
    num_threads: int = 0,
    dst_off: np.ndarray | None = None,  # (B,) int64 dense offsets
    total: int | None = None,           # chunk size when dst_off given
):
    """Fused event replay + 4-line block formatting: one native pass from
    event streams to the final output bytes.  With dst_off/total (global
    walks only; from native_events_block_lens + cumsum) the chunk is
    DENSE -- every block lands at its exact final offset with no stride
    holes, so downstream gathers coalesce to one memcpy per chunk.
    Returns (chunk uint8, spans (B, 2) int64) or None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    events = np.ascontiguousarray(events, np.uint16)
    ev_off = np.ascontiguousarray(ev_off, np.int64)
    ref_tokens = np.ascontiguousarray(ref_tokens, np.uint8)
    qry_tokens = np.ascontiguousarray(qry_tokens, np.uint8)
    start_row = np.ascontiguousarray(start_row, np.int32)
    start_col = np.ascontiguousarray(start_col, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    pair_ids = np.ascontiguousarray(pair_ids, np.int64)
    if dst_off is not None:
        assert not local and total is not None
        dst_off = np.ascontiguousarray(dst_off, np.int64)
        blk_stride = 0
        chunk = np.empty(int(total), np.uint8)
        off_ptr = _ptr(dst_off, ctypes.c_int64)
    else:
        blk_stride = 26 + 3 * (m + n + 1)
        chunk = np.empty(b * blk_stride, np.uint8)
        off_ptr = None
    spans = np.zeros((b, 2), np.int64)
    rc = lib.ta_replay_events_blocks(
        b, n, m, 1 if local else 0, match, mismatch, gap,
        _ptr(events, ctypes.c_uint16), _ptr(ev_off, ctypes.c_int64),
        _ptr(ref_tokens, ctypes.c_uint8), _ptr(qry_tokens, ctypes.c_uint8),
        _ptr(start_row, ctypes.c_int32), _ptr(start_col, ctypes.c_int32),
        _ptr(scores, ctypes.c_int32), _ptr(pair_ids, ctypes.c_int64),
        chunk.ctypes.data_as(ctypes.c_char_p), blk_stride,
        off_ptr, _ptr(spans, ctypes.c_int64), num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"ta_replay_events_blocks failed: {rc}")
    return chunk, spans


def native_format_blocks(
    pair_ids: np.ndarray,   # (B,)
    scores: np.ndarray,     # (B,)
    out_buf: np.ndarray,    # (B, 3, stride) uint8
    out_lens: np.ndarray,   # (B,)
    num_threads: int = 0,
):
    """Render every pair's 4-line output block into one contiguous uint8
    buffer (the reference's per-pair printf loop, vectorized + threaded).
    Returns (chunk (total,) uint8, spans (B, 2) int64 offset/length) or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    b = int(pair_ids.shape[0])
    stride = out_buf.shape[2]
    pair_ids = np.ascontiguousarray(pair_ids, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    out_buf = np.ascontiguousarray(out_buf, np.uint8)
    out_lens = np.ascontiguousarray(out_lens, np.int32)
    spans = np.zeros((b, 2), np.int64)
    # exact upper bound: header <= 26 bytes (two int32s + " | \n")
    cap = int(3 * (out_lens.astype(np.int64) + 1).sum() + 26 * b)
    chunk = np.empty(cap, np.uint8)
    total = lib.ta_format_blocks(
        b, _ptr(pair_ids, ctypes.c_int32), _ptr(scores, ctypes.c_int32),
        out_buf.ctypes.data_as(ctypes.c_char_p), stride,
        _ptr(out_lens, ctypes.c_int32),
        chunk.ctypes.data_as(ctypes.c_char_p), cap,
        _ptr(spans, ctypes.c_int64), num_threads,
    )
    if total < 0:
        raise RuntimeError(f"ta_format_blocks needs {-total} bytes, more "
                           f"than its exact bound {cap}")
    return chunk[:total], spans


def native_gather_spans(src: np.ndarray, spans: np.ndarray,
                        order: np.ndarray):
    """Concatenate src's spans in the given order: block b is
    src[spans[b, 0]:spans[b, 0] + spans[b, 1]].  Returns the gathered uint8
    array.  Raises RuntimeError when the library cannot load (the JAX
    package's wrapper returns None there)."""
    require("native_gather_spans")
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    spans = np.ascontiguousarray(spans, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    if spans.ndim != 2 or spans.shape[1] != 2:
        raise ValueError(f"spans must be (B, 2), got {spans.shape}")
    if order.size and (order.min() < 0 or order.max() >= spans.shape[0]):
        raise ValueError("order indexes past spans")
    if spans.size and ((spans < 0).any()
                       or (spans[:, 0] + spans[:, 1] > src.size).any()):
        raise ValueError("a span lies outside src")
    total = int(spans[order, 1].sum()) if order.size else 0
    dst = np.empty(total, np.uint8)
    done = lib.ta_gather_spans(
        src.ctypes.data_as(ctypes.c_char_p), _ptr(spans, ctypes.c_int64),
        _ptr(order, ctypes.c_int64), order.shape[0],
        dst.ctypes.data_as(ctypes.c_char_p),
    )
    if done != total:
        raise RuntimeError(f"ta_gather_spans wrote {done} of {total} bytes")
    return dst


def native_gather_parts(srcs, spans: np.ndarray, part_of: np.ndarray,
                        order: np.ndarray, num_threads: int = 0):
    """Multi-source ordered span gather (threaded).  srcs: list of uint8
    arrays; block b = srcs[part_of[b]][spans[b,0]:+spans[b,1]].  Returns
    the gathered uint8 array or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    srcs = [np.ascontiguousarray(s, np.uint8) for s in srcs]
    spans = np.ascontiguousarray(spans, np.int64)
    part_of = np.ascontiguousarray(part_of, np.int32)
    order = np.ascontiguousarray(order, np.int64)
    total = int(spans[order, 1].sum()) if order.size else 0
    dst = np.empty(total, np.uint8)
    ptrs = (ctypes.c_char_p * max(len(srcs), 1))(
        *(s.ctypes.data_as(ctypes.c_char_p) for s in srcs))
    done = lib.ta_gather_parts(
        ptrs, _ptr(spans, ctypes.c_int64), _ptr(part_of, ctypes.c_int32),
        _ptr(order, ctypes.c_int64), order.shape[0],
        dst.ctypes.data_as(ctypes.c_char_p), num_threads,
    )
    assert done == total, (done, total)
    return dst


def native_gather_padded(buf: np.ndarray, off: np.ndarray, lens: np.ndarray,
                         rows: int, width: int, pad: int,
                         num_threads: int = 0, out: np.ndarray | None = None):
    """Flat-buffer -> (rows, width) padded token gather (threaded), into
    `out` (a C-contiguous (rows, width) uint8 array, e.g. the numpy view of
    a pinned tensor) or a new array.  Returns the uint8 array or None if
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    if out is None:
        out = np.empty((rows, width), np.uint8)
    elif (out.shape != (rows, width) or out.dtype != np.uint8
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous ({rows}, "
                         f"{width}) uint8 array")
    n = len(off)
    if n < rows:  # padding rows beyond the real batch
        out[n:] = pad
    lib.ta_gather_padded(
        _ptr(buf, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), n, width, pad,
        _ptr(out, ctypes.c_uint8), num_threads,
    )
    return out


def native_parse_pair_bytes(data: bytes, translate_digits: bool = True):
    """Parse a 3-line pair file natively.  Returns (buffer, ref_off, ref_len,
    qry_off, qry_len) or None if the library is unavailable.  Raises
    ValueError on malformed input (line count not a multiple of 3)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8).copy()
    nbytes = buf.size
    npairs = lib.ta_count_pairs(_ptr(buf, ctypes.c_uint8), nbytes)
    if npairs < 0:
        raise ValueError("number of lines not a multiple of 3")
    i64 = ctypes.c_int64
    ro = np.zeros(npairs, np.int64)
    rl = np.zeros(npairs, np.int64)
    qo = np.zeros(npairs, np.int64)
    ql = np.zeros(npairs, np.int64)
    got = lib.ta_parse_pairs(
        _ptr(buf, ctypes.c_uint8), nbytes, npairs,
        _ptr(ro, i64), _ptr(rl, i64), _ptr(qo, i64), _ptr(ql, i64),
        1 if translate_digits else 0,
    )
    if got < 0:
        raise ValueError("malformed pair file")
    return buf, ro[:got], rl[:got], qo[:got], ql[:got]
