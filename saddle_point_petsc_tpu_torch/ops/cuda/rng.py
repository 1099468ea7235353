"""Kernel RN, counter-based standard-normal draws, behind a PyTorch entry
point, with its plain CPU twin.

- `normal_(out, seed=0, leaf=0)`: fills the contiguous float32 or float64
  tensor `out` in place with standard normals and returns it;
- `normal_like(t, seed=0, leaf=0)`: a new tensor of t's shape, dtype and
  device, filled so.

Element k of the draw, in flat C order, depends only on (seed, leaf, k):
half of the Philox4x32-10 block (Salmon et al., SC'11; Random123) of
counter (p mod 2^32, p div 2^32, seed div 2^32, 0), p = k div 2, under key
(seed mod 2^32, leaf), turned into two 53-bit uniforms and by Box-Muller
into two normals, in f64 (a float32 draw is the f64 one rounded);
csrc/normal_draw.cu states the formulas. `seed` is an int in [0, 2^64),
`leaf` in [0, 2^32).

It replaces no TPU kernel: the JAX package draws with jax.random.normal
(Threefry, counter-based). On CUDA tensors `normal_` launches the CUDA
kernel in csrc/normal_draw.cu, built at first use by `_build`; on CPU
tensors it runs the plain twin, numpy uint64 arithmetic (a product of two
32-bit words is exact there), which gives the kernel's Philox words and
uniforms bit for bit and its normals to a few ulp (numpy's log, sin and cos
against the card's). Each launch adds 1, in `utils.monitor.counters`, to
`RN.launches` and to `RN.launches.float32` or `RN.launches.float64`; the
twin counts nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.utils import monitor

_DTYPES = (torch.float32, torch.float64)
_DTYPE_KEY = {torch.float32: "RN.launches.float32", torch.float64: "RN.launches.float64"}
_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))  # Philox4x32 multipliers
_W = (0x9E3779B9, 0xBB67AE85)  # the key's Weyl increments
_LO = np.uint64(0xFFFFFFFF)
_CHUNK = 1 << 20  # pairs the twin draws at a time, to bound its temporaries


def _words(seed, leaf):
    """(key0, key1, counter word 2) of a draw: see the module docstring."""
    if not (isinstance(seed, int) and 0 <= seed < 1 << 64):
        raise ValueError(f"seed {seed!r}: need an int in [0, 2**64)")
    if not (isinstance(leaf, int) and 0 <= leaf < 1 << 32):
        raise ValueError(f"leaf {leaf!r}: need an int in [0, 2**32)")
    return seed & 0xFFFFFFFF, leaf, seed >> 32


def philox4x32(counter, key, rounds=10):
    """The Philox4x32 blocks of `counter` (uint32 array (..., 4)) under `key`
    (two ints), as a uint32 array (..., 4): the twin's generator."""
    c = [np.asarray(counter, dtype=np.uint32)[..., i].astype(np.uint64) for i in range(4)]
    k0, k1 = int(key[0]), int(key[1])
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W[0]) & 0xFFFFFFFF, (k1 + _W[1]) & 0xFFFFFFFF
        p0, p1 = _M[0] * c[0], _M[1] * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & _LO,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & _LO]
    return np.stack(c, axis=-1).astype(np.uint32)


def philox_words_plain(pairs, seed=0, leaf=0, start=0):
    """The Philox words of pairs start .. start + pairs - 1 of a draw, a
    uint32 array (pairs, 4)."""
    k0, k1, c2 = _words(seed, leaf)
    p = np.arange(start, start + pairs, dtype=np.uint64)
    counter = np.stack([p & _LO, p >> np.uint64(32), np.full_like(p, c2), np.zeros_like(p)], axis=-1)
    return philox4x32(counter, (k0, k1))


def _uniforms(w):
    """(u1 in (0, 1], u2 in [0, 1)) of Philox words w (pairs, 4), in f64."""
    w = w.astype(np.uint64)
    a = ((w[:, 0] >> np.uint64(5)) << np.uint64(26)) | (w[:, 1] >> np.uint64(6))
    b = ((w[:, 2] >> np.uint64(5)) << np.uint64(26)) | (w[:, 3] >> np.uint64(6))
    return (a.astype(np.float64) + 1.0) * 2.0**-53, b.astype(np.float64) * 2.0**-53


def normal_plain(n, seed=0, leaf=0):
    """The first n values of a draw, a float64 numpy array: the twin."""
    out = np.empty(n, dtype=np.float64)
    for start in range(0, (n + 1) // 2, _CHUNK):
        pairs = min(_CHUNK, (n + 1) // 2 - start)
        u1, u2 = _uniforms(philox_words_plain(pairs, seed, leaf, start))
        r, t = np.sqrt(-2.0 * np.log(u1)), (2.0 * np.pi) * u2
        z = np.stack([r * np.cos(t), r * np.sin(t)], axis=-1).reshape(-1)
        out[2 * start : 2 * start + 2 * pairs] = z[: n - 2 * start]
    return out


def _check(out):
    if not isinstance(out, torch.Tensor):
        raise TypeError("normal_ takes a torch tensor")
    if out.dtype not in _DTYPES:
        raise TypeError(f"normal_ draws float32 or float64, not {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("normal_ needs a contiguous tensor")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {out.device}")
    if out.device.type == "cuda" and out.data_ptr() % (2 * out.element_size()):
        raise ValueError("normal_ stores a pair at a time: the tensor's start must be aligned to two elements")


_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("normal_draw")
        ptr, i64, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32
        for name in ("normal_draw_f32", "normal_draw_f64", "normal_draw_words"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i64, u32, u32, u32, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn_name, out, count, seed, leaf):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(lib, fn_name)(out.data_ptr(), count, *_words(seed, leaf), stream)
    _build.check(lib, "normal_draw", rc)


def normal_(out, seed=0, leaf=0):
    """Fill `out` with the draw of (seed, leaf) and return it; see the
    module docstring."""
    _check(out)
    if out.device.type == "cpu":
        out.copy_(torch.from_numpy(normal_plain(out.numel(), seed, leaf)).view(out.shape))
        return out
    _launch("normal_draw_f32" if out.dtype == torch.float32 else "normal_draw_f64", out, out.numel(), seed, leaf)
    monitor.count("RN.launches")
    monitor.count(_DTYPE_KEY[out.dtype])
    return out


def normal_like(t, seed=0, leaf=0):
    """A new tensor of t's shape, dtype and device holding the draw of
    (seed, leaf)."""
    return normal_(torch.empty(t.shape, dtype=t.dtype, device=t.device), seed, leaf)


def philox_words(pairs, seed=0, leaf=0, device="cuda"):
    """The kernel's Philox words of pairs 0 .. pairs - 1 of a draw, an int32
    tensor (pairs, 4) on the card holding the uint32 bits (for the tests;
    `philox_words_plain` is the twin's). Counts no launch."""
    out = torch.empty((pairs, 4), dtype=torch.int32, device=device)
    if out.device.type != "cuda":
        raise ValueError(f"philox_words runs the kernel: need a CUDA device, not {out.device}")
    _launch("normal_draw_words", out, pairs, seed, leaf)
    return out
