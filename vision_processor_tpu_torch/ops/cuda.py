"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` and linked into one
shared library with a plain C interface, loaded with ``ctypes``: the
sources compile in parallel, one ``nvcc`` each, from the repository's
sources alone, in seconds. The first launch in a process builds the
library into ``build/vptpu_torch_kernels/`` (a directory that
``.gitignore`` lists), keyed by a hash of the sources, with the
``-Xptxas -v`` report beside it. A source in :data:`SHAPED` is built
instead into one library per call shape, the shape's constants given as
``-D`` macros (:func:`shaped_lib`), on the shape's first call or ahead
of it (:func:`build`).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises :class:`KernelError` on
anything but 0, as the build does when a kernel cannot be compiled or
loaded. Each wrapper (ops/warp.py, ops/blob_fused.py, ops/topk.py,
ops/gather_corners.py, ops/combo_fused.py, ops/corner_stack.py,
ops/resample_packed.py, ops/band_warp.py) counts its own launches in
:data:`LAUNCHES`, so a caller can show that a run went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vptpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

# launches per kernel wrapper; reset with reset_launches()
LAUNCHES: dict[str, int] = {
    "band_pass": 0,
    "blob_response_fused": 0,
    "row_topk": 0,
    "query_select_topk": 0,
    "gather_corners": 0,
    "circularity_fused": 0,
    "combo_chain": 0,
    "corner_stack": 0,
    "resample_packed": 0,
    "band_warp": 0,
    "row_topk_blk": 0,
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # src, pos, out, ch, R, C, n_out, stream
    "vp_band_pass": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, R, L, m, vals, idx, stream
    "vp_row_topk": [_P, _I, _I, _I, _P, _P, _P],
    # q, r2, b, rank, Q, K, m, by_rank, vals, idx, stream
    "vp_query_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # stack, idx, n_out, out, stream
    "vp_gather_corners": [_P, _P, _L, _P, _P],
    # maps, A, C, anchor_pos, ring_count, anchor_valid, combo_max, pattern,
    # threads, outf, outi, stream
    "vp_combo_chain": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    # src, mode, H, W, out, stream
    "vp_corner_stack": [_P, _I, _I, _I, _P, _P],
    # src, mode, fmt, H, W, px, py, pstride, n, out, stream
    "vp_resample_packed": [_P, _I, _I, _I, _I, _P, _P, _I, _L, _P, _P],
    # src, pos, r0, out, ch, R, C, n_out, win, stream
    "vp_band_warp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the same arguments: E1's loads and finite flags alone, for timing
    "vp_band_warp_staging": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, R, L, m, blk, warps, vals, idx, stream
    "vp_row_topk_blk": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    # out: registers a thread, most threads a block
    "vp_row_topk_blk_attrs": [_P],
}
# sources built once per call shape (ops/blob_fused.py kernel_defines),
# and the entries their libraries may hold
SHAPED = {
    "blob_fused.cu": {
        # flat, H, W, o, r, dr, tile_h, tile_w, smem, inv_rr, inv_n, th,
        # ms, circ, m0, m1, m2, count, stream
        "vp_blob_response": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P,
                             _P, _P, _P, _P, _P, _P, _P],
        # flat, H, W, o, r, tile_h, tile_w, smem, inv_rr, circ, stream
        "vp_circularity": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P],
    },
}
_shaped: dict = {}  # (source, defines) -> loaded library


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch. The apps' per-frame
    error handling lets it through: the detection path cannot run without
    its kernels."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[Path]:
    """The sources of the one library that :func:`lib` loads."""
    return sorted(p for p in CSRC.glob("*.cu") if p.name not in SHAPED)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _target(srcs: list[Path], defines: tuple[str, ...] = ()):
    """(library path, sources, -D flags): the path keyed by a hash of the
    sources, the flags and the defines."""
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS + list(defines)).encode())
    stem = srcs[0].stem if defines else "vptpu_torch_kernels"
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so", srcs, defines


def shaped_target(src: str, defines: dict):
    """The target of ``csrc/<src>`` (a :data:`SHAPED` source) built with
    ``defines``."""
    flags = tuple(f"-D{k}={v}" for k, v in sorted(defines.items()))
    return _target([CSRC / src], flags)


def report(path: Path) -> str:
    """The ``-Xptxas -v`` report of a built library."""
    log = path.with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def _build(targets) -> float:
    """Build every target not on disk yet, each once however often it is
    named: one nvcc per source of each, all started together, then one link
    each, each library's ptxas report beside it. Returns the seconds
    taken."""
    todo = list({t[0]: t for t in targets if not t[0].exists()}.values())
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = [(out, s, defines, BUILD_DIR / f"{s.stem}.{out.stem}.{os.getpid()}.o")
            for out, srcs, defines in todo for s in srcs]
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(o), str(s)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _, s, defines, o in jobs
        ]
        logs: dict = {out: [] for out, _, _ in todo}
        failed = []
        for (out, s, defines, _), proc in zip(jobs, procs):
            stdout, stderr = proc.communicate()
            name = " ".join([s.name, *defines])
            logs[out].append(f"== {name}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode})")
        if failed:
            raise KernelError(f"nvcc failed: {', '.join(failed)}\n"
                              + "\n".join(ln for v in logs.values() for ln in v))
        for out, _, _ in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            objs = [str(o) for o_out, _, _, o in jobs if o_out == out]
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise KernelError(f"nvcc link failed ({link.returncode}):\n"
                                  f"{link.stdout}\n{link.stderr}")
            out.with_suffix(".ptxas.txt").write_text("\n".join(logs[out]))
            os.replace(tmp, out)
    finally:
        for *_, o in jobs:
            o.unlink(missing_ok=True)
    return time.perf_counter() - t0


def build(shapes=()) -> Path:
    """Compile csrc/*.cu into the one library, and each (SHAPED source,
    defines) of ``shapes`` into its own, all at once (each cached by source
    hash): one nvcc per source, all started together, then one link per
    library. Returns the one library's path."""
    main = _target(sources())
    cached = main[0].exists()
    seconds = _build([main, *(shaped_target(src, d) for src, d in shapes)])
    BUILD_INFO.update(path=str(main[0]), seconds=seconds, cached=cached,
                      ptxas=report(main[0]))
    return main[0]


def _load(path: Path, signatures: dict, every: bool = True):
    """Load a built library and type its entries (``every``: all of
    ``signatures``, else those it holds)."""
    try:
        handle = ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelError(f"cannot load the kernel library: {exc}") from exc
    for name, args in signatures.items():
        if every or hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return handle


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build(), _SIGNATURES)
    return _lib


def shaped_lib(src: str, defines: dict):
    """The library of ``csrc/<src>`` (a :data:`SHAPED` source) built with
    ``defines`` as -D macros (built on first use)."""
    key = (src, tuple(sorted(defines.items())))
    with _lock:
        handle = _shaped.get(key)
        if handle is None:
            target = shaped_target(src, defines)
            _build([target])
            handle = _shaped[key] = _load(target[0], SHAPED[src], every=False)
    return handle


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed: cudaError {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Wrapper-side argument check: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
