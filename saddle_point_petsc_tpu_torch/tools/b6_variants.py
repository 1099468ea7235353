"""Time kernel B6's paths, and variants of its source, on one CUDA card.

    python -m saddle_point_petsc_tpu_torch.tools.b6_variants [--side 1025] [--k 8]

On the DIA operator of assemble_poisson_csr at side^2 nodes (21 bands,
natural order) with k columns, in f32 and f64, with X row-major ("rows")
and as the transpose of a (k, n) batch ("(k,n).T"), it times each of the
kernel's paths (strided, rows, blocked) where they apply, as
csrc/dia_spmm.cu builds them, and each variant below: a copy of a source
with a few lines changed, built with the same nvcc flags into
csrc/_build/. The sources are csrc/dia_spmm.cu and tools/dia_spmm_window.cu
(X staged in shared memory, a design the port does not use). Variants
marked exact must give the plain version's bits; the ablations drop the
loads of X or of the bands (each replaced by a value computed in
registers), or the arithmetic, and show which stream holds a path back.
Every number is the median of 60 launches timed with CUDA events; the
cases run in turn, then again in reverse, and each keeps the better
median. Prints one line per case beside the bound (bytes over 3.35 TB/s)
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import statistics
import subprocess

import torch

from saddle_point_petsc_tpu_torch.csrc import BUILD_DIR, CSRC, compile_once
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.cuda import _build, dia_spmm

PEAK_BYTES_PER_S = 3.35e12

_WINDOW = "tools/dia_spmm_window.cu"  # relative to the package
_X_STRIDED = "acc[c] = add_rn(acc[c], mul_rn(a, xj[c * g.xs_col]));"
_BAND_STRIDED = "const T a = __ldcs(data + (int64_t)d * g.n + i);"
_X_WINDOW = (
    "__pipeline_memcpy_async(dc + (j0 - w0), xc + j0, kChunk * sizeof(T));",
    "__pipeline_memcpy_async(dc + (j0 + m - w0), xc + j0 + m, sizeof(T));",
    "__pipeline_memcpy_async(xw + tc * P + (w - w0), x + w * g.xs_row + tc * g.xs_col, sizeof(T));",
)
_BAND_WINDOW = "__pipeline_memcpy_async(dw + e * TILE + w, band + i, sizeof(T));"
_APPLY_WINDOW = [(f"apply<T, {s}, {e}>(acc[c], xs, av, cnt, live);", ";")
                 for s in (0, 1) for e in ("true", "false")]

# name -> (source, the path it is timed on, exact: must give the plain
# version's bits, the source edits as (old, new) pairs). The window source
# runs its one kernel whatever path it is given; it is timed as "blocked",
# the path whose plan it takes.
VARIANTS = {
    "blocked 3 blocks/SM": ("csrc/dia_spmm.cu", "blocked", True, [
        ("__launch_bounds__(kThreads)\ndia_spmm_blocked", "__launch_bounds__(kThreads, 3)\ndia_spmm_blocked")]),
    "blocked f32 16-byte X loads": ("csrc/dia_spmm.cu", "blocked", True, [
        ("struct Blk<float> { static constexpr int R = 4, V = 2, NV = 12; };",
         "struct Blk<float> { static constexpr int R = 4, V = 4, NV = 16; };")]),
    "strided no X loads": ("csrc/dia_spmm.cu", "strided", False, [
        (_X_STRIDED, "acc[c] = add_rn(acc[c], mul_rn(a, T(c + 1)));")]),
    "strided no band loads": ("csrc/dia_spmm.cu", "strided", False, [
        (_BAND_STRIDED, "const T a = T(d + 1);")]),
    "window": (_WINDOW, "blocked", True, []),
    "window no X copies": (_WINDOW, "blocked", False, [(old, ";") for old in _X_WINDOW]),
    "window no band copies": (_WINDOW, "blocked", False, [
        (_BAND_WINDOW, "dw[e * TILE + w] = T(e + 1);")]),
    "window no arithmetic": (_WINDOW, "blocked", False, _APPLY_WINDOW),
}


def _variant_source(source, edits):
    text = (CSRC.parent / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not match exactly once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_variant(source, edits):
    """Build `source` (a path in the package) with `edits` applied into its
    own library; returns (bound library, nvcc's ptxas report)."""
    text = _variant_source(source, edits)
    digest = hashlib.sha256((text + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    src, out = BUILD_DIR / f"dia_spmm_variant_{digest}.cu", BUILD_DIR / f"libdia_spmm_variant_{digest}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    _, log = compile_once(f"dia_spmm_variant_{digest}", out,
                          lambda tmp: (_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", tmp, str(src)))
    return dia_spmm._bind(ctypes.CDLL(str(out))), log


def _ptxas(log):
    return [line.split(":", 1)[1].strip() for line in log.splitlines() if "Used" in line]


def _median_ms(fn, n=60, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # the host runs ahead: the events time the device
    pairs = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=1025, help="nodes per side of the grid")
    ap.add_argument("--k", type=int, default=8, help="columns of X")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b6_variants: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    sources = {"as built": ("csrc/dia_spmm.cu", []),
               **{name: (v[0], v[3]) for name, v in VARIANTS.items()}}
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = {name: pool.submit(_build_variant, *src) for name, src in sources.items()}
        libs, logs = {}, {}
        for name, fut in built.items():
            libs[name], logs[name] = fut.result()
    for name, log in logs.items():
        print(f"{name}: {_ptxas(log)}")

    csr, _, _, _ = poisson.assemble_poisson_csr(args.side - 1, args.side - 1, device=dev)
    A = sparse.csr_to_dia(csr)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k = args.k
    for dtype in (torch.float32, torch.float64):
        data = A.data.to(dtype)
        nd, n = data.shape
        es = torch.finfo(dtype).bits // 8
        bound_us = (nd + 2 * k) * n * es / PEAK_BYTES_PER_S * 1e6
        Xb = torch.randn((k, n), generator=gen, dtype=dtype, device=dev)
        for layout, X in (("(k,n).T", Xb.T), ("rows", Xb.T.contiguous())):
            want = dia_spmm.dia_spmm_plain(data, X, A.offsets)
            paths = ("strided", "rows") if layout == "rows" else ("strided", "blocked")
            cases = [(f"as built, {p}", libs["as built"], p, True) for p in paths]
            cases += [(name, libs[name], path, exact) for name, (_, path, exact, _) in VARIANTS.items()
                      if path in paths or path == "blocked" and name.startswith("window")]
            runs = [(lambda lib=lib, p=p: dia_spmm._launch(data, X, A.offsets, path=p, lib=lib))
                    for _, lib, p, _ in cases]
            for (label, _, _, exact), run in zip(cases, runs):
                if exact and not torch.equal(run(), want):
                    raise AssertionError(f"{label}: not the plain version's bits")
            times = [_median_ms(run) for run in runs]
            times = [min(a, b) for a, b in zip(times, reversed([_median_ms(r) for r in reversed(runs)]))]
            for (label, _, _, exact), t in zip(cases, times):
                print(f"B6 {str(dtype)[6:]:<7} {layout:<8} k={k} {label:<28} {t * 1e3:8.2f} us "
                      f"({bound_us / (t * 1e3):.2f} of the {bound_us:.1f} us bound)"
                      f"{'' if exact else ' [ablation: wrong sums]'}  ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
