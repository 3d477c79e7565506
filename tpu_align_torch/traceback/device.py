"""Device traceback: the walk's move semantics, its plain version, event
compaction, dispatch, and the host replay glue.

Port of tpu_align/traceback/device.py.  The reference's end state walks
the direction words on the accelerator (cuda/LNW/LinearNeedlemanWunschV8.cu;
V19.cu:26-110 `backtracking()`), so only scores and moves cross to the
host, never the dirs.  Here the walk and the compaction are CUDA kernels
(csrc/stagger_walk.cu, wrapped by traceback/walk_kernel.py); this module
holds their plain PyTorch versions, which CPU tensors run:

* `decide_step` -- one backward move of a cursor, the JAX function ported
  whole (linear, local and affine branches).  The plain walk calls it with
  each lane's own row as the phase row; the CUDA walk has a __device__
  copy of its linear and local branches.
* `device_walk_reference` -- every live lane takes one step per
  iteration, reading its own code with a per-lane gather (the TPU's walker
  phases lanes by row only because its vector unit has no gather), then
  global lanes flush insertions along row 0.  Outputs equal the kernel's:
  packed (T16, B) int32 moves dense from step 0, 16 to a word (1 diagonal,
  2 deletion, 3 insertion); slots (ev_max, B) uint16, each lane's first
  ev_max events; nev (B,) int32, every event.
* `compact_events_reference` -- the exclusive prefix sum that lays the
  events out flat, _compact_events's layout: lane b's events at
  flat[offs[b]:offs[b] + nev[b]], payload (row before the move << 1) |
  is_ins, in walk order.

A path takes at most M + N moves (2M + band - 1 over the banded layout),
so that bound rounded up to 16 bounds every walk: the JAX walker's phase
budget and its doubling retry have no counterpart.  Decoded move
sequences and events are the contract with the JAX package; packed
positions are not (its two walk engines differ there too).

Two readbacks of one walk (the CUDA walk kernel either way):
* events mode (device_walk_dispatch_events), the engine's: only the
  compacted events cross to the host, the packed stream when they
  overflow;
* moves mode (device_walk_dispatch, device_walk_finalize,
  device_traceback_moves): the dense packed stream itself, with no
  compaction.
Both return a WalkHandle, which finalize_any takes, and
device_traceback_bucket(_arrays) run a whole bucket in one call.

Two replays of a finalized walk: the threaded native replayers (the
default), which raise when the native library cannot load, and the
Python replay (moves_to_result, _events_to_codes), taken only on an
explicit use_native=False -- never because a load failed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_align_torch.core import directions as D
from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.core.result import AlignmentResult, results_from_arrays
from tpu_align_torch.kernels.banded import ROWS_PER_WORD as BANDED_ROWS
from tpu_align_torch.kernels.common import (
    bits_per_cell,
    steps_per_word,
    to_int32_words,
)

# walker state codes for affine (c++/backtrack.cpp:214-356)
SCORING, INSERTION, DELETION = 0, 1, 2

MOVES_PER_WORD = 16  # 2-bit moves per int32 word of the packed stream
EV_MAX = 32  # per-lane event slot bound in the compacted readback
EV_CAP_PER_LANE = 16  # flat buffer slots per lane (bucket-wide average)
# events mode needs rows < 2**14 (the payload's 14-bit row) and a path
# bound M + N below 2**12 (the JAX capacity heuristic, device.py:501-511)
EVENT_ROW_LIMIT = 1 << 14
EVENT_PATH_LIMIT = 1 << 12

stream_finalized = 0  # walks finalized in the stream form since the reset


def decide_step(algorithm, params, code, m, i, j, rem, anw_state, done):
    """One step of the backward walk: decide this lane's move and advance
    its cursor state.  Torch on broadcastable tensors (``m`` is the row
    the step works on: the TPU's shared phase row, or each lane's own row
    in the per-lane walk).

    Returns (emit, i, j, rem, anw_state, done) where emit is the 2-bit
    move code (int32): 0 = no-op, 1 = diagonal, 2 = query deletion,
    3 = query insertion."""
    is_local = algorithm.is_local
    p = params
    main = code & 3

    in_row = (i == m) & ~done
    act = in_row & (j > 0)
    # border column: j == 0 with rows left -> forced deletion
    forced_del = in_row & (j == 0)

    if algorithm.is_affine:
        # three-state Gotoh walk; E/F extend bits end or continue runs
        ins_now = (anw_state == INSERTION) | (
            (anw_state == SCORING) & (main == D.MAIN_QUERY_INSERTION))
        del_now = (anw_state == DELETION) | (
            (anw_state == SCORING) & (main == D.MAIN_QUERY_DELETION)
            & ~ins_now)
        ins_now = ins_now & act
        del_now = del_now & act
        diag_now = act & ~ins_now & ~del_now
        # run continuation: extend bit set -> stay in the run
        ins_next = ins_now & ((code & D.BIT_E_EXTEND) != 0)
        del_next = del_now & ((code & D.BIT_F_EXTEND) != 0)
        new_state = torch.where(
            ins_next, INSERTION, torch.where(del_next, DELETION, SCORING))
        anw_state = torch.where(act, new_state, anw_state)
    else:
        ins_now = act & (main == D.MAIN_QUERY_INSERTION)
        diag_now = act & ((main == D.MAIN_DIAG_MATCH)
                          | (main == D.MAIN_DIAG_MISMATCH))
        del_now = act & (main == D.MAIN_QUERY_DELETION)

    del_now = del_now | forced_del
    emit = torch.where(
        ins_now, 3, torch.where(del_now, 2, torch.where(diag_now, 1, 0))
    ).to(torch.int32)
    if is_local:
        cost = torch.where(
            diag_now,
            torch.where(main == D.MAIN_DIAG_MATCH, p.match, p.mismatch),
            torch.where(emit > 0, p.gap, 0),
        )
        rem = rem - cost.to(rem.dtype)
    j = j - (ins_now | diag_now).to(j.dtype)
    i = i - (del_now | diag_now).to(i.dtype)
    if is_local:
        done = done | ((emit > 0) & (rem <= 0))
        done = done | ((i == m) & (emit == 0))  # never-started lanes
    return emit, i, j, rem, anw_state, done


def walk_rows(algorithm: Algorithm, dirs_shape) -> int:
    """M: the DP rows a dirs tensor holds."""
    if algorithm.is_banded:
        return dirs_shape[0] * BANDED_ROWS
    return dirs_shape[0] * dirs_shape[2]


def walk_steps(algorithm: Algorithm, params: AlignmentParams,
               dirs_shape) -> int:
    """T: the packed stream's length in moves, a bound on any path rounded
    up to 16.  Stagger dirs (stripes, W, S, B): M + N, for M = stripes*S
    rows and at most N = spw*W - S + 1 columns.  Banded dirs (MW, B, K8):
    2M + band - 1, for M = 16*MW rows, since a band cell's column is below
    M + band."""
    rows = walk_rows(algorithm, dirs_shape)
    if algorithm.is_banded:
        path = 2 * rows + params.band - 1
    else:
        _, words, s, _ = dirs_shape
        path = rows + words * steps_per_word(algorithm) - s + 1
    return -(-path // MOVES_PER_WORD) * MOVES_PER_WORD


def _pack_moves(codes: torch.Tensor) -> torch.Tensor:
    """(T, B) codes 0..3 -> (T/16, B) int32 words, step t at bits
    2*(t%16) of word t//16."""
    t, b = codes.shape
    shifts = 2 * torch.arange(MOVES_PER_WORD, dtype=torch.int64,
                              device=codes.device)[None, :, None]
    words = (codes.to(torch.int64).view(t // MOVES_PER_WORD, MOVES_PER_WORD,
                                        b) << shifts).sum(1)
    return to_int32_words(words)


def _code_reader(algorithm, params, dirs, stripe_s):
    """code_at(i, j): each lane's direction code of its own cell (i, j),
    (B,) int32, by a per-lane gather; clamped reads of cells outside the
    dirs are never used by a live lane."""
    flat = dirs.reshape(-1)
    dev = dirs.device
    if algorithm.is_banded:
        mw, b, k8 = dirs.shape
        rows = mw * BANDED_ROWS
        lanes = torch.arange(b, device=dev)

        def code_at(i, j):
            ii = (i - 1).clamp(0, rows - 1).long()
            slot = (j - i + params.band).long()
            inside = (slot >= 0) & (slot < k8)
            word = flat[((ii // BANDED_ROWS) * b + lanes) * k8
                        + slot.clamp(0, k8 - 1)]
            code = (word >> (2 * (ii % BANDED_ROWS)).to(word.dtype)) & 3
            # a slot outside the frame reads 0, as the JAX walkers' masked
            # sums do (a live lane never gets there)
            return torch.where(inside, code, 0)

        return code_at
    stripes, words, s, b = dirs.shape
    assert s == stripe_s, (dirs.shape, stripe_s)
    bits = bits_per_cell(algorithm)
    spw = steps_per_word(algorithm)
    rows = stripes * s
    cols = words * spw - s + 1
    lanes = torch.arange(b, device=dev)

    def code_at(i, j):
        ii = (i - 1).clamp(0, rows - 1).long()
        k = (j - 1).clamp(0, cols - 1).long() + ii % s
        word = flat[(((ii // s) * words + k // spw) * s + ii % s) * b + lanes]
        return (word >> (bits * (k % spw)).to(word.dtype)) & ((1 << bits) - 1)

    return code_at


def device_walk_reference(
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs: torch.Tensor,
    start_row: torch.Tensor, start_col: torch.Tensor, scores: torch.Tensor,
    stripe_s: int,
    ev_max: int = EV_MAX,
):
    """Plain PyTorch version of the walk kernel, over all lanes at once.
    dirs (stripes, W, S, B) int32 stagger words (LNW, LSW, ANW) or (MW, B,
    K8) banded words (BSW, band = params.band; stripe_s is not read);
    start_row, start_col, scores (B,) int32.  Returns (packed (T16, B)
    int32, slots (ev_max, B) uint16, nev (B,) int32), equal to the
    kernel's outputs (slots past a lane's nev are 0 here and undefined
    there)."""
    b = dirs.shape[1] if algorithm.is_banded else dirs.shape[3]
    dev = dirs.device
    i32 = torch.int32
    code_at = _code_reader(algorithm, params, dirs, stripe_s)
    t_max = walk_steps(algorithm, params, dirs.shape)
    lanes = torch.arange(b, device=dev)
    i = start_row.to(i32).clone()
    j = start_col.to(i32).clone()
    rem = scores.to(i32).clone()
    done = (rem <= 0) if algorithm.is_local else torch.zeros(
        b, dtype=torch.bool, device=dev)
    anw = torch.zeros(b, dtype=i32, device=dev)
    codes = torch.zeros((t_max, b), dtype=i32, device=dev)
    slots = torch.zeros((ev_max, b), dtype=i32, device=dev)
    nev = torch.zeros(b, dtype=i32, device=dev)
    pos = torch.zeros(b, dtype=torch.int64, device=dev)

    def record(emit, row_before):
        nonlocal nev, pos
        moved = emit > 0
        codes[pos[moved], lanes[moved]] = emit[moved]
        ev = emit >= 2
        put = ev & (nev < ev_max)
        slots[nev[put].long(), lanes[put]] = (
            (row_before << 1) | (emit == 3).to(i32))[put]
        nev = nev + ev.to(i32)
        pos = pos + moved.to(torch.int64)

    for _ in range(t_max):
        live = ~done & (i > 0)
        if not bool(live.any()):
            break
        row_before = i
        emit, i, j, rem, anw, done_step = decide_step(
            algorithm, params, code_at(i, j), row_before, i, j, rem, anw,
            done | ~live)
        done = torch.where(live, done_step, done)
        record(emit, row_before)
    if not algorithm.is_local:
        zero = torch.zeros(b, dtype=i32, device=dev)
        for _ in range(t_max):  # border flush: row 0, insertions while j > 0
            flush = j > 0
            if not bool(flush.any()):
                break
            record(torch.where(flush, 3, 0).to(i32), zero)
            j = j - flush.to(i32)
    return _pack_moves(codes), slots.to(torch.uint16), nev


def same_walk(got, want) -> bool:
    """Whether two walks' (packed, slots, nev) agree as the contract
    defines them: packed word for word, nev, and each lane's slots below
    min(nev, ev_max) (the kernel leaves the rest unwritten)."""
    ev_max = want[1].shape[0]
    kept = (torch.arange(ev_max, device=want[2].device)[:, None]
            < want[2][None, :])
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[1].to(torch.int32)[kept],
                            want[1].to(torch.int32)[kept]))


def lane_moves(packed: torch.Tensor) -> torch.Tensor:
    """(B,) moves of each lane of a (T16, B) packed stream."""
    return sum(((packed >> (2 * k)) & 3).ne(0).sum(0)
               for k in range(MOVES_PER_WORD))


def event_capacity(batch: int, ev_max: int = EV_MAX,
                   cap_per_lane: int | None = None) -> int:
    """Slots of the flat event buffer: _compact_events's
    B * min(cap_per_lane, ev_max)."""
    return batch * min(cap_per_lane or EV_CAP_PER_LANE, ev_max)


def compact_events_reference(slots: torch.Tensor, nev: torch.Tensor,
                             ev_max: int = EV_MAX,
                             cap_per_lane: int | None = None):
    """Plain PyTorch version of the compaction kernel.  Returns (flat
    (cap,) uint16, nev (B,) int32, max_nev, total) with lane b's events at
    flat[offs[b]:offs[b] + nev[b]] (offs the exclusive prefix sum of nev),
    events past ev_max as 0, everything clipped at cap and 0 from total
    on.  Overflow (max_nev > ev_max or total > cap) means the caller
    replays the packed stream instead."""
    b = nev.shape[0]
    dev = nev.device
    cap = event_capacity(b, ev_max, cap_per_lane)
    n64 = nev.to(torch.int64)
    offs = torch.cumsum(n64, 0) - n64
    s = torch.arange(ev_max, device=dev)[:, None]
    at = offs[None, :] + s
    keep = (s < n64[None, :]) & (at < cap)
    flat = torch.zeros(cap, dtype=torch.int32, device=dev)
    flat[at[keep]] = slots.to(torch.int32)[keep]
    max_nev = (nev.max() if b else torch.zeros((), device=dev)).to(
        torch.int32)
    return flat.to(torch.uint16), nev, max_nev, n64.sum().to(torch.int32)


def unpack_moves(packed: np.ndarray, steps: int) -> np.ndarray:
    """(T16, B) packed words -> (steps, B) uint8 codes."""
    t16, b = packed.shape
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :, None]
    codes = (
        (packed.astype(np.uint32)[:, None, :] >> shifts) & 3
    ).reshape(t16 * 16, b)
    return codes[:steps].astype(np.uint8)


@dataclasses.dataclass
class WalkHandle:
    """A dispatched walk.  `fetch` holds host tensors (pinned copies being
    filled by async D2H on CUDA, the tensors themselves on CPU) of the
    events -- flat, nev, max_nev, total, in events mode -- or, in moves
    mode, of the packed stream, then the extras; `done` is the CUDA event
    that marks the copies complete.  Otherwise `packed` stays on the
    device for the stream form."""

    events: bool
    packed: torch.Tensor
    fetch: tuple
    done: object  # torch.cuda.Event | None
    ev_max: int
    moves: bool = False  # the packed stream rides the copies

    def finalize(self):
        """device_walk_finalize_events of this walk."""
        return device_walk_finalize_events(self)


def copy_to_host(tensors, device: torch.device):
    """Enqueue non-blocking D2H copies into pinned buffers on the current
    stream; returns (host tensors, event).  CPU tensors pass through."""
    if device.type == "cpu":
        return tuple(tensors), None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def device_walk_dispatch_events(
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs: torch.Tensor,
    start_row: torch.Tensor, start_col: torch.Tensor, scores: torch.Tensor,
    stripe_s: int,
    walker: str = "xla",
    extras: tuple = (),
    ev_max: int = EV_MAX,
) -> WalkHandle:
    """Enqueue the walk and, in events mode, the compaction behind the
    bucket's fill, then non-blocking copies of the events and `extras`
    (the bucket's scores, and its start cells where the host does not know
    them).  Nothing waits.  `walker` is "xla" or "pallas": the JAX
    package's two walk engines give the same moves, and both run the one
    CUDA walk here (the plain walk on CPU tensors).

    dirs are stagger words (stripes, W, S, B) or, for BSW, banded words
    (MW, B, K8).  Events mode when rows < 2**14 and the path bound
    (walk_steps) < 2**12; the stream form otherwise, and on overflow
    (device_walk_finalize_events)."""
    from tpu_align_torch.traceback import walk_kernel

    if walker not in ("xla", "pallas"):
        raise ValueError(f"unknown walker {walker!r}")
    packed, slots, nev = walk_kernel.device_walk(
        algorithm, params, dirs, start_row, start_col, scores, stripe_s,
        ev_max=ev_max)
    events = (walk_rows(algorithm, dirs.shape) < EVENT_ROW_LIMIT
              and walk_steps(algorithm, params, dirs.shape)
              < EVENT_PATH_LIMIT)
    fetch = tuple(extras)
    if events:
        fetch = walk_kernel.compact_events(slots, nev, ev_max) + fetch
    host, done = copy_to_host(fetch, dirs.device)
    return WalkHandle(events, packed, host, done, ev_max)


def device_walk_finalize_events(handle: WalkHandle):
    """Wait for a dispatched walk.  Returns ("events", flat np.uint16,
    nev (B,), *extras) or ("stream", packed (T16, B) np.int32, steps,
    *extras): the stream in moves mode, which copied it with the extras,
    and when events mode was not chosen or a lane overflowed ev_max or the
    flat buffer, where it is copied from the device here, synchronously."""
    if handle.done is not None:
        handle.done.synchronize()
    got = [t.numpy() for t in handle.fetch]
    if handle.moves:
        packed, *extras = got
        return ("stream", packed, packed.shape[0] * MOVES_PER_WORD, *extras)
    if handle.events:
        flat, nev, max_nev, total = got[:4]
        extras = got[4:]
        if int(max_nev) <= handle.ev_max and int(total) <= flat.size:
            return ("events", flat, nev, *extras)
    else:
        extras = got
    return stream_form(handle, extras)


def stream_form(handle: WalkHandle, extras) -> tuple:
    """("stream", packed (T16, B) np.int32, steps, *extras) of a finished
    walk: its packed stream copied from the device, synchronously."""
    global stream_finalized
    stream_finalized += 1
    packed = handle.packed.cpu().numpy()
    return ("stream", packed, packed.shape[0] * MOVES_PER_WORD, *extras)


def device_walk_dispatch(
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs: torch.Tensor,
    start_row: torch.Tensor, start_col: torch.Tensor, scores: torch.Tensor,
    stripe_s: int,
    extras: tuple = (),
) -> WalkHandle:
    """Enqueue the walk behind the bucket's fill in moves mode: no
    compaction; non-blocking copies of the dense packed stream (T16, B)
    int32 and `extras` (e.g. the bucket's scores and start cells).
    Nothing waits.  dirs and the (B,) int32 start cells and scores as in
    device_walk_dispatch_events, whose handle this is with the events
    turned off and the packed stream among the copies."""
    from tpu_align_torch.traceback import walk_kernel

    packed, _, _ = walk_kernel.device_walk(
        algorithm, params, dirs, start_row, start_col, scores, stripe_s)
    host, done = copy_to_host((packed,) + tuple(extras), dirs.device)
    return WalkHandle(False, packed, host, done, EV_MAX, moves=True)


def device_walk_finalize(handle: WalkHandle):
    """Wait for a walk dispatched in moves mode.  Returns (packed (T16, B)
    np.int32, steps, *extras as numpy arrays).

    steps is the stream's length in moves, T16 * 16: the path bound
    walk_steps, as stream_form returns it.  In the JAX package it is the
    phase count that its lanes share, since its walk moves all lanes a
    row at a time; the port walks each lane on its own, its moves dense
    from step 0, so what the two packages share is each lane's move
    sequence with the no-move codes dropped, not the raw words."""
    if not handle.moves:
        raise ValueError("device_walk_finalize takes a moves-mode walk "
                         "(device_walk_dispatch); an events-mode walk "
                         "finalizes with device_walk_finalize_events")
    return device_walk_finalize_events(handle)[1:]


def device_traceback_moves(
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs: torch.Tensor,
    start_row: torch.Tensor, start_col: torch.Tensor, scores: torch.Tensor,
    stripe_s: int,
):
    """Run the device walk in moves mode and wait: (packed (T16, B)
    np.int32, steps).  Only the packed moves cross to the host."""
    return device_walk_finalize(device_walk_dispatch(
        algorithm, params, dirs, start_row, start_col, scores, stripe_s))


def finalize_any(handle, scores=None, srow=None, scol=None):
    """Finalize a handle (a WalkHandle of either mode -- a moves-mode walk
    comes back in the stream form -- or distributed.sharding's
    ShardedWalk, whose shards it joins) into a normalized tuple:
    ("events", flat np.uint16, nev, sc, sr, sj) or
    ("stream", packed (T16, B) np.int32, steps, sc, sr, sj).

    scores/srow/scol fill in whatever did not ride the handle's copies as
    extras; numpy arrays pass through as-is (global walks: the engine
    passes the bucket's host-side qry_len/ref_len -- the global start
    coordinates -- so only the scores cross the bus)."""
    out = handle.finalize()
    kind, payload, rest = out[0], out[1:3], out[3:]
    if len(rest) == 3:
        sc, sr, sj = (np.asarray(a) for a in rest)
    elif len(rest) == 1 and srow is not None and scol is not None:
        sc = np.asarray(rest[0])
        sr, sj = np.asarray(srow), np.asarray(scol)
    else:
        sc, sr, sj = (t.cpu().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t) for t in (scores, srow, scol))
    return (kind, *payload, sc, sr, sj)


def _native():
    from tpu_align_torch import native

    native.require("the native replay; use_native=False takes the Python "
                   "replay")
    return native


def bucket_blocks_from_finalized(algorithm, bucket, params, fin):
    """Fused fast path: event streams -> final formatted blocks in ONE
    native pass (ta_replay_events_blocks; no intermediate string buffer).
    Returns (pair_ids, scores, chunk, spans) for
    _BlockCollector.add_chunk, or None when the finalized result is a
    stream (the caller takes bucket_arrays_from_finalized)."""
    if fin[0] != "events":
        return None
    native = _native()
    _, flat, nev, sc, sr, sj = fin
    nb = bucket.num_real
    ids = bucket.pair_ids[:nb]
    p = params
    ev_off = np.zeros(nev.shape[0] + 1, np.int64)
    np.cumsum(nev, out=ev_off[1:])
    dst_off = total = None
    if not algorithm.is_local:
        # Global walks: block lengths derive from the events alone, so the
        # chunk is written DENSE at exact final offsets (no stride holes,
        # no scratch copy) and the collector's final gather coalesces the
        # whole chunk into one memcpy.
        lens = native.native_events_block_lens(flat, ev_off[:nb + 1],
                                               sr[:nb], ids, sc[:nb])
        dst_off = np.zeros(nb, np.int64)
        np.cumsum(lens[:-1], out=dst_off[1:])
        total = int(dst_off[-1] + lens[-1]) if nb else 0
    chunk, spans = native.native_replay_events_blocks(
        flat, ev_off[:nb + 1], bucket.ref_tokens[:nb],
        bucket.qry_tokens[:nb], sr[:nb], sj[:nb], sc[:nb], ids,
        local=algorithm.is_local,
        match=p.match, mismatch=p.mismatch, gap=p.gap,
        dst_off=dst_off, total=total,
    )
    return ids, sc[:nb], chunk, spans


def bucket_arrays_from_finalized(algorithm, bucket, params, fin,
                                 use_native: bool = True):
    """Replay a finalized walk (finalize_any's tuple).  With use_native
    (the default): (scores, out_buf (nb, 3, stride) uint8, out_lens (nb,)
    int32) from the native replayers, for the native block formatter or
    results_from_arrays; raises RuntimeError when the native library
    cannot load.  With use_native=False: list[AlignmentResult] from the
    Python replay (_events_to_codes, unpack_moves, moves_to_result), the
    JAX package's list form."""
    if not use_native:
        return _replay_python(algorithm, bucket, params, fin)
    native = _native()
    nb = bucket.num_real
    if fin[0] == "events":
        _, flat, nev, sc, sr, sj = fin
        ev_off = np.zeros(nev.shape[0] + 1, np.int64)
        np.cumsum(nev, out=ev_off[1:])
        p = params
        out_buf, out_lens = native.native_replay_events(
            flat, ev_off[:nb + 1], bucket.ref_tokens[:nb],
            bucket.qry_tokens[:nb], sr[:nb], sj[:nb], sc[:nb],
            local=algorithm.is_local,
            match=p.match, mismatch=p.mismatch, gap=p.gap,
        )
    else:
        _, packed, _, sc, sr, sj = fin
        out_buf, out_lens = native.native_replay_moves(
            packed, bucket.ref_tokens[:nb], bucket.qry_tokens[:nb],
            sr[:nb], sj[:nb], sc[:nb], local=algorithm.is_local,
        )
    return sc[:nb], out_buf, out_lens


def _replay_python(algorithm, bucket, params, fin) -> list[AlignmentResult]:
    """The Python replay of a finalized walk, pair by pair."""
    nb = bucket.num_real
    if fin[0] == "events":
        _, flat, nev, sc, sr, sj = fin
        ev_off = np.zeros(nev.shape[0] + 1, np.int64)
        np.cumsum(nev, out=ev_off[1:])
        codes = _events_to_codes(flat, ev_off, sr, sj, sc, bucket,
                                 algorithm, params)
    else:
        _, packed, steps, sc, sr, sj = fin
        codes = unpack_moves(packed, steps)
    results = []
    for row in range(nb):
        rlen = int(bucket.ref_len[row])
        qlen = int(bucket.qry_len[row])
        # latin-1, as results_from_arrays decodes the native replay's bytes
        ref = bucket.ref_tokens[row, :rlen].tobytes().decode("latin-1")
        qry = bucket.qry_tokens[row, :qlen].tobytes().decode("latin-1")
        results.append(moves_to_result(
            algorithm, int(bucket.pair_ids[row]), int(sc[row]),
            codes[:, row], ref, qry, int(sr[row]), int(sj[row])))
    return results


def moves_to_result(
    algorithm: Algorithm,
    pair_num: int,
    score: int,
    moves,  # (T,) uint8 codes 0..3, in walk order (backward)
    ref: str,
    qry: str,
    start_row: int,
    start_col: int,
) -> AlignmentResult:
    """Replay one lane's move stream into the three output lines.

    The stream is in walk order (end -> start), no-move codes skipped;
    emission mirrors the dirs walkers (traceback/host.py), so the output
    is byte-identical.  A local lane with score <= 0 is an empty block."""
    if algorithm.is_local and score <= 0:
        return AlignmentResult(pair_num, score)
    i, j = start_row, start_col
    out_r, out_m, out_q = [], [], []
    for mv in moves:
        if mv == 0:
            continue
        if mv == 1:  # diagonal
            rc, qc = ref[j - 1], qry[i - 1]
            out_r.append(rc)
            out_m.append(D.REL_MATCH if rc == qc else D.REL_MISMATCH)
            out_q.append(qc)
            i -= 1
            j -= 1
        elif mv == 2:  # query deletion
            out_r.append(D.GAP_CHAR)
            out_m.append(D.REL_GAP)
            out_q.append(qry[i - 1])
            i -= 1
        else:  # query insertion
            out_r.append(ref[j - 1])
            out_m.append(D.REL_GAP)
            out_q.append(D.GAP_CHAR)
            j -= 1
    return AlignmentResult(
        pair_num, score,
        "".join(reversed(out_r)),
        "".join(reversed(out_m)),
        "".join(reversed(out_q)),
    )


def _events_to_codes(flat, ev_off, sr, sj, sc, bucket, algorithm, params):
    """The Python counterpart of native_replay_events' expansion: flat
    per-lane event payloads ((row << 1 | is_ins) uint16, lane b's events
    at flat[ev_off[b]:ev_off[b + 1]]) -> dense (T, nb) move codes, the
    diagonals between events filled in, with the local re-scoring stop
    (native/tpualign.cpp replay_events_range)."""
    nb = bucket.num_real
    local = algorithm.is_local
    t_cap = bucket.qry_tokens.shape[1] + bucket.ref_tokens.shape[1] + 1
    codes = np.zeros((t_cap, nb), np.uint8)
    for b in range(nb):
        rem = int(sc[b])
        if local and rem <= 0:
            continue
        r, c = int(sr[b]), int(sj[b])
        ref = bucket.ref_tokens[b]
        qry = bucket.qry_tokens[b]
        t = 0
        done = False

        def diag():
            nonlocal r, c, t, rem, done
            codes[t, b] = 1
            t += 1
            if local:
                rem -= (params.match if ref[c - 1] == qry[r - 1]
                        else params.mismatch)
                if rem <= 0:
                    done = True
            r -= 1
            c -= 1

        for k in range(int(ev_off[b]), int(ev_off[b + 1])):
            if done:
                break
            p = int(flat[k])
            if p == 0:
                break
            i_e = p >> 1
            while r > i_e and not done:
                diag()
            if done:
                break
            codes[t, b] = 3 if (p & 1) else 2
            t += 1
            if p & 1:
                c -= 1
            else:
                r -= 1
            if local:
                rem -= params.gap
                if rem <= 0:
                    done = True
        if local:
            while not done and r > 0 and c > 0:
                diag()
        else:
            while r > 0:
                diag()
    return codes


def device_traceback_bucket_arrays(
    algorithm: Algorithm,
    bucket,
    scores, srow, scol, dirs,
    params: AlignmentParams,
    stripe_s: int,
    handle=None,
    use_native: bool = True,
):
    """A bucket's device traceback in one call: the walk (dispatched here
    in moves mode, with scores and start cells as extras, unless `handle`
    holds a walk from device_walk_dispatch or device_walk_dispatch_events),
    then the replay.  Returns bucket_arrays_from_finalized's result: the
    native arrays (scores, out_buf, out_lens), or with use_native=False a
    list[AlignmentResult].  dirs, scores, srow and scol are tensors on the
    walk's device; only the moves (or events) and those three cross to
    the host."""
    if handle is None:
        handle = device_walk_dispatch(
            algorithm, params, dirs, srow, scol, scores, stripe_s,
            extras=(scores, srow, scol))
    fin = finalize_any(handle, scores, srow, scol)
    return bucket_arrays_from_finalized(algorithm, bucket, params, fin,
                                        use_native=use_native)


def device_traceback_bucket(
    algorithm: Algorithm,
    bucket,
    scores, srow, scol, dirs,
    params: AlignmentParams,
    stripe_s: int,
    handle=None,
    use_native: bool = True,
) -> list[AlignmentResult]:
    """device_traceback_bucket_arrays as one AlignmentResult a real pair
    (pair_num = original dataset index): the native replay, which raises
    without its library, or with use_native=False the Python replay."""
    out = device_traceback_bucket_arrays(
        algorithm, bucket, scores, srow, scol, dirs, params, stripe_s,
        handle=handle, use_native=use_native)
    if isinstance(out, list):
        return out
    sc, out_buf, out_lens = out
    return results_from_arrays(bucket.pair_ids, sc, out_buf, out_lens,
                               bucket.num_real)
