"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` and linked into one
shared library with a plain C interface, loaded with ``ctypes``: the
sources compile in parallel, one ``nvcc`` each, from the repository's
sources alone, in seconds. The first launch in a process builds the
library into ``build/vptpu_torch_kernels/`` (a directory that
``.gitignore`` lists), keyed by a hash of the sources.

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
    # flat, H, W, o, r, inv_rr, n_spans, dys, hws, inv_n, th,
    # circ_ext, ms, circ, m0, m1, m2, stream
    "vp_blob_response": [_P, _I, _I, _I, _I, _F, _I, _P, _P, _F, _P,
                         _P, _P, _P, _P, _P, _P, _P],
    # x, R, L, m, vals, idx, stream
    "vp_row_topk": [_P, _I, _I, _I, _P, _P, _P],
    # q, r2, b, rank, Q, K, m, by_rank, vals, idx, stream
    "vp_query_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # stack, idx, n_out, out, stream
    "vp_gather_corners": [_P, _P, _L, _P, _P],
    # flat, H, W, o, r, inv_rr, circ, stream
    "vp_circularity": [_P, _I, _I, _I, _I, _F, _P, _P],
    # maps, A, C, anchor_pos, ring_count, anchor_valid, combo_max, pattern,
    # outf, outi, stream
    "vp_combo_chain": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # src, mode, H, W, out, stream
    "vp_corner_stack": [_P, _I, _I, _I, _P, _P],
    # src, mode, fmt, H, W, px, py, pstride, n, out, stream
    "vp_resample_packed": [_P, _I, _I, _I, _I, _P, _P, _I, _L, _P, _P],
    # src, pos, r0, out, ch, R, C, n_out, win, stream
    "vp_band_warp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, R, L, m, blk, vals, idx, stream
    "vp_row_topk_blk": [_P, _I, _I, _I, _I, _P, _P, _P],
}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch. The apps' per-frame
    error handling lets it through: the detection path cannot run without
    its kernels."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (cached by source hash):
    one nvcc per source, all started together, then one link."""
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    out = BUILD_DIR / f"libvptpu_torch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(srcs, objs)
        ]
        logs, failed = [], []
        for s, proc in zip(srcs, procs):
            stdout, stderr = proc.communicate()
            logs.append(f"== {s.name}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{s.name} ({proc.returncode})")
        if failed:
            raise KernelError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(logs))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD_INFO.update(
        path=str(out), seconds=time.perf_counter() - t0, cached=False,
        ptxas="\n".join(logs),
    )
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError as exc:
                raise KernelError(f"cannot load the kernel library: {exc}") from exc
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


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
