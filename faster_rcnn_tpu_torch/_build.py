"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every source in ``csrc/*.cu`` is compiled to an object by its own ``nvcc``
process, all started together, for ``sm_90a``; the objects are linked into
one shared library with a plain C interface. The library goes to
``faster_rcnn_tpu_torch/_build/`` (listed in .gitignore) under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is compiled when the package is imported:
the first kernel launch builds.

Each wrapper counts its launches in :data:`LAUNCHES`, so a run can show
that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("conv1.cu", "roi_align.cu", "nms.cu", "topk.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# NMS compares iou > thresh against the plain version bit for bit: no FMA
# contraction may change the rounding of its IoU arithmetic.
EXTRA_FLAGS = {"nms.cu": ["--fmad=false"]}

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"conv1": 0, "roi_align": 0, "roi_align_bwd": 0, "nms": 0, "topk": 0}

_lib: ctypes.CDLL | None = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "frcnn_conv1_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "frcnn_conv1_f32": [_P, _P, _P, _I, _I, _I, _P],
    "frcnn_roi_align_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "frcnn_roi_align_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "frcnn_roi_align_bwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "frcnn_roi_align_bwd_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "frcnn_nms_keep_mask": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
    "frcnn_nms_smem_bytes": [_I, _I],
    "frcnn_topk_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "frcnn_cuda_error_string": [_I],
}
_RESTYPES = {"frcnn_nms_smem_bytes": ctypes.c_size_t,
             "frcnn_cuda_error_string": ctypes.c_char_p}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((FLAGS, EXTRA_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; return its
    path. Records timing and the ptxas report in :data:`build_info`."""
    out = BUILD_DIR / f"libfrcnn_kernels_{_digest()}.so"
    if out.exists():
        build_info.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{src}.{os.getpid()}.o"
        cmd = [nvcc, *FLAGS, *EXTRA_FLAGS.get(src, []), "-I", str(CSRC),
               "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, _, p in procs:
        logs[src] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    os.replace(tmp, out)
    build_info.update(cached=False, seconds=time.perf_counter() - t0, ptxas=logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = handle
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().frcnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
