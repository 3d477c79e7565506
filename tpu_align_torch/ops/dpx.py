"""The DPX op layer: the 36 fused min/max/add intrinsics of the reference's
FakeDPX idiom (c++/FakeDPX.hpp:12-127), ported from tpu_align/ops/dpx.py.

Hopper has them in hardware: csrc/dpx.cuh maps each function onto its
sm_90 intrinsic (`__vimax3_s32`, `__vibmax_s16x2`, `__viaddmax_u16x2`,
...), and csrc/dpx_apply.cu applies one of them elementwise to arrays.
Each function here is that kernel's wrapper: on CUDA tensors it launches
`ta_torch_dpx_apply` (and counts the launch in `launches`); on CPU
tensors and Python ints it runs the plain PyTorch version, which repeats
the JAX module's arithmetic.

As in the JAX module:
  * `*_s32` functions take and return int32, `*_u32` uint32;
  * `*_s16x2` / `*_u16x2` take and return uint32 words holding two packed
    16-bit lanes, hi in bits 31:16 (cuda/LNW/LinearNeedlemanWunschV19.cu
    :17-24), each lane computed on its own, adds wrapping in 16 bits;
  * `vib*` functions return (value, pred) -- (value, pred_hi, pred_lo)
    for the packed ones -- with bool predicates that are True when the
    FIRST argument wins, ties included (`a >= b`, `a <= b` for min;
    FakeDPX.cpp:145-153).
PyTorch implements few operators for uint32, so the plain versions
compute on int64 lanes and convert at the end.
"""

from __future__ import annotations

import torch

from tpu_align_torch.kernels import _build

launches = 0  # ta_torch_dpx_apply launches

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


# ---------------------------------------------------------------------------
# lanes: int64 tensors holding 32- or 16-bit lane values
# ---------------------------------------------------------------------------


def _i64(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(torch.int64)


def _s32(x) -> torch.Tensor:
    """Signed 32-bit lane values of int32, uint32 or int arguments."""
    return ((_i64(x) + 2**31) & _M32) - 2**31


def _u32(x) -> torch.Tensor:
    return _i64(x) & _M32


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 2**31) & _M32) - 2**31


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    return _wrap32(v).to(torch.int32)


def _to_u32(v: torch.Tensor) -> torch.Tensor:
    return (v & _M32).to(torch.uint32)


def _sext16(v: torch.Tensor) -> torch.Tensor:
    v = v & _M16
    return v - ((v & 0x8000) << 1)


def _halves_s(x):
    v = _u32(x)
    return _sext16(v >> 16), _sext16(v)


def _halves_u(x):
    v = _u32(x)
    return (v >> 16) & _M16, v & _M16


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return _to_u32(((hi & _M16) << 16) | (lo & _M16))


def pack_s16x2(hi, lo) -> torch.Tensor:
    """Two int16 lanes -> one uint32 word, hi in bits 31:16, lo in 15:0
    (pack_s16x2 of cuda/LNW/LinearNeedlemanWunschV19.cu:17-19)."""
    return _pack(_s32(hi), _s32(lo))


def unpack_s16x2(x) -> tuple[torch.Tensor, torch.Tensor]:
    """One uint32 word -> its two sign-extended lanes (hi, lo) as int32."""
    hi, lo = _halves_s(x)
    return hi.to(torch.int32), lo.to(torch.int32)


# ---------------------------------------------------------------------------
# the plain versions, one lane function each
# ---------------------------------------------------------------------------


def _max(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


def _min(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(out, x)
    return out


def _relu(v):
    return torch.clamp_min(v, 0)


def _add16(x, y):
    """int16 wraparound add of two signed lanes (halfword registers)."""
    return _sext16(x + y)


def _ge(x, y):
    return torch.where(x >= y, x, y), x >= y


def _le(x, y):
    return torch.where(x <= y, x, y), x <= y


# name -> (lane kind, number of arguments, lane function); the order is
# the op code of csrc/dpx_apply.cu
_TABLE = {
    "vimax3_s32": ("s32", 3, _max),
    "vimin3_s32": ("s32", 3, _min),
    "vimax3_u32": ("u32", 3, _max),
    "vimin3_u32": ("u32", 3, _min),
    "vimax3_s16x2": ("s16x2", 3, _max),
    "vimin3_s16x2": ("s16x2", 3, _min),
    "vimax3_u16x2": ("u16x2", 3, _max),
    "vimin3_u16x2": ("u16x2", 3, _min),
    "vimax_s32_relu": ("s32", 2, lambda x, y: _relu(_max(x, y))),
    "vimin_s32_relu": ("s32", 2, lambda x, y: _relu(_min(x, y))),
    "vimax_s16x2_relu": ("s16x2", 2, lambda x, y: _relu(_max(x, y))),
    "vimin_s16x2_relu": ("s16x2", 2, lambda x, y: _relu(_min(x, y))),
    "vimax3_s32_relu": ("s32", 3, lambda x, y, z: _relu(_max(x, y, z))),
    "vimin3_s32_relu": ("s32", 3, lambda x, y, z: _relu(_min(x, y, z))),
    "vimax3_s16x2_relu": ("s16x2", 3, lambda x, y, z: _relu(_max(x, y, z))),
    "vimin3_s16x2_relu": ("s16x2", 3, lambda x, y, z: _relu(_min(x, y, z))),
    "vibmax_s32": ("s32", 2, _ge),
    "vibmin_s32": ("s32", 2, _le),
    "vibmax_u32": ("u32", 2, _ge),
    "vibmin_u32": ("u32", 2, _le),
    "vibmax_s16x2": ("s16x2", 2, _ge),
    "vibmin_s16x2": ("s16x2", 2, _le),
    "vibmax_u16x2": ("u16x2", 2, _ge),
    "vibmin_u16x2": ("u16x2", 2, _le),
    "viaddmax_s32": ("s32", 3, lambda x, y, z: _max(_wrap32(x + y), z)),
    "viaddmin_s32": ("s32", 3, lambda x, y, z: _min(_wrap32(x + y), z)),
    "viaddmax_u32": ("u32", 3, lambda x, y, z: _max((x + y) & _M32, z)),
    "viaddmin_u32": ("u32", 3, lambda x, y, z: _min((x + y) & _M32, z)),
    "viaddmax_s16x2": ("s16x2", 3, lambda x, y, z: _max(_add16(x, y), z)),
    "viaddmin_s16x2": ("s16x2", 3, lambda x, y, z: _min(_add16(x, y), z)),
    "viaddmax_u16x2": ("u16x2", 3, lambda x, y, z: _max((x + y) & _M16, z)),
    "viaddmin_u16x2": ("u16x2", 3, lambda x, y, z: _min((x + y) & _M16, z)),
    "viaddmax_s32_relu": ("s32", 3,
                          lambda x, y, z: _relu(_max(_wrap32(x + y), z))),
    "viaddmin_s32_relu": ("s32", 3,
                          lambda x, y, z: _relu(_min(_wrap32(x + y), z))),
    "viaddmax_s16x2_relu": ("s16x2", 3,
                            lambda x, y, z: _relu(_max(_add16(x, y), z))),
    "viaddmin_s16x2_relu": ("s16x2", 3,
                            lambda x, y, z: _relu(_min(_add16(x, y), z))),
}
OPS = tuple(_TABLE)  # the op codes of ta_torch_dpx_apply


def reference(name: str, *args):
    """The plain PyTorch version of DPX function `name` on any device."""
    kind, nargs, fn = _TABLE[name]
    if len(args) != nargs:
        raise TypeError(f"{name} takes {nargs} arguments, got {len(args)}")
    pred = name.startswith("vib")
    if kind in ("s32", "u32"):
        lanes = [_s32(a) if kind == "s32" else _u32(a) for a in args]
        out = fn(*lanes)
        value = out[0] if pred else out
        value = _to_i32(value) if kind == "s32" else _to_u32(value)
        return (value, out[1]) if pred else value
    halves = _halves_s if kind == "s16x2" else _halves_u
    his, los = zip(*(halves(a) for a in args))
    hi, lo = fn(*his), fn(*los)
    if pred:
        return _pack(hi[0], lo[0]), hi[1], lo[1]
    return _pack(hi, lo)


def _bits(x, device) -> torch.Tensor:
    """An argument's 32 bits as an int32 tensor on `device`."""
    if isinstance(x, torch.Tensor) and x.dtype in (torch.int32,
                                                   torch.uint32):
        return x.view(torch.int32)
    return _to_i32(_i64(x).to(device))


def apply(name: str, *args):
    """DPX function `name` on its arguments' device: CUDA tensors launch
    csrc/dpx_apply.cu (or raise), anything else runs `reference`."""
    global launches
    on = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(on) > 1:
        raise ValueError(f"{name}: arguments on {sorted(map(str, on))}")
    device = on.pop() if on else torch.device("cpu")
    if device.type == "cpu":
        return reference(name, *args)
    if device.type != "cuda":
        raise ValueError(f"no DPX kernel for device {device}")
    kind, nargs, _ = _TABLE[name]
    if len(args) != nargs:
        raise TypeError(f"{name} takes {nargs} arguments, got {len(args)}")
    bits = torch.broadcast_tensors(*(_bits(a, device) for a in args))
    bits = [t.contiguous() for t in bits]
    n = bits[0].numel()
    out = torch.empty_like(bits[0])
    pred = name.startswith("vib")
    x2 = kind in ("s16x2", "u16x2")
    p_hi = torch.empty(bits[0].shape, dtype=torch.bool, device=device) \
        if pred else None
    p_lo = torch.empty_like(p_hi) if pred and x2 else None
    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.ta_torch_dpx_apply(
            OPS.index(name), *(t.data_ptr() for t in bits),
            *([None] * (3 - nargs)), out.data_ptr(),
            None if p_hi is None else p_hi.data_ptr(),
            None if p_lo is None else p_lo.data_ptr(), n,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dpx kernel launch failed ({name}): CUDA error "
                           f"{rc}")
    launches += 1
    value = out if kind == "s32" else out.view(torch.uint32)
    if not pred:
        return value
    return (value, p_hi, p_lo) if x2 else (value, p_hi)


def _define(name: str):
    if _TABLE[name][1] == 2:
        def fn(a, b):
            return apply(name, a, b)
    else:
        def fn(a, b, c):
            return apply(name, a, b, c)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = (f"DPX __{name} (csrc/dpx.cuh); tpu_align/ops/dpx.py "
                  f"{name}.")
    return fn


vimax3_s32 = _define("vimax3_s32")
vimin3_s32 = _define("vimin3_s32")
vimax3_u32 = _define("vimax3_u32")
vimin3_u32 = _define("vimin3_u32")
vimax3_s16x2 = _define("vimax3_s16x2")
vimin3_s16x2 = _define("vimin3_s16x2")
vimax3_u16x2 = _define("vimax3_u16x2")
vimin3_u16x2 = _define("vimin3_u16x2")
vimax_s32_relu = _define("vimax_s32_relu")
vimin_s32_relu = _define("vimin_s32_relu")
vimax_s16x2_relu = _define("vimax_s16x2_relu")
vimin_s16x2_relu = _define("vimin_s16x2_relu")
vimax3_s32_relu = _define("vimax3_s32_relu")
vimin3_s32_relu = _define("vimin3_s32_relu")
vimax3_s16x2_relu = _define("vimax3_s16x2_relu")
vimin3_s16x2_relu = _define("vimin3_s16x2_relu")
vibmax_s32 = _define("vibmax_s32")
vibmin_s32 = _define("vibmin_s32")
vibmax_u32 = _define("vibmax_u32")
vibmin_u32 = _define("vibmin_u32")
vibmax_s16x2 = _define("vibmax_s16x2")
vibmin_s16x2 = _define("vibmin_s16x2")
vibmax_u16x2 = _define("vibmax_u16x2")
vibmin_u16x2 = _define("vibmin_u16x2")
viaddmax_s32 = _define("viaddmax_s32")
viaddmin_s32 = _define("viaddmin_s32")
viaddmax_u32 = _define("viaddmax_u32")
viaddmin_u32 = _define("viaddmin_u32")
viaddmax_s16x2 = _define("viaddmax_s16x2")
viaddmin_s16x2 = _define("viaddmin_s16x2")
viaddmax_u16x2 = _define("viaddmax_u16x2")
viaddmin_u16x2 = _define("viaddmin_u16x2")
viaddmax_s32_relu = _define("viaddmax_s32_relu")
viaddmin_s32_relu = _define("viaddmin_s32_relu")
viaddmax_s16x2_relu = _define("viaddmax_s16x2_relu")
viaddmin_s16x2_relu = _define("viaddmin_s16x2_relu")
