"""ctypes binding for the native C++ image loader.

Counterpart of faster_rcnn_tpu/data/native_loader.py. Compiles
``native/image_loader.cpp`` on first use (g++ -O3, linked against libjpeg)
and exposes :func:`load_canvas_native` and :func:`load_canvas_native_u8`:
decode + bicubic resize + flip (+ BGR/mean preprocess) + canvas pad in one
C call. ctypes releases the GIL for the call's duration, so the
TrainLoader's worker threads decode in parallel while the GPU computes.

The library goes to ``faster_rcnn_tpu_torch/_build/`` (listed in
.gitignore) under a name keyed by a hash of the source and the command, as
the CUDA kernels' library is (``_build.py``), and of the host's CPU, so
that the JAX package's build and this one never share a file, an edited
source rebuilds, and a library built for another CPU is never loaded.

This is a host decoder, not a device kernel. ``available()`` is False when
g++ or libjpeg is missing, at the build or when the library is loaded (the
failure is printed, and kept in :data:`build_info`), and the loaders return
None for a file that is not a JPEG; callers then use the PIL path
(data/voc.py ImageRecord.load_pixels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "image_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]
_LIBS = ["-ljpeg"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the first use found: "library" (its path) or "error" (why the build
# failed, so that PIL decodes)
build_info: dict = {}


def _host_cpu() -> str:
    """This host's CPU as ``-march=native`` sees it: the machine and, on
    Linux, the instruction-set flags of /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith(("flags", "Features"))), "")
    except OSError:
        flags = ""
    return f"{platform.machine()} {platform.processor()} {flags.strip()}"


def library_path() -> Path:
    """Where the library for this source, command and host CPU is (or will
    be) built. The CPU is in the key because ``-march=native`` builds for
    it: a library copied from a host with other instructions would load
    here and then die of SIGILL in a loader thread, where no fallback can
    catch it; this host builds its own instead."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(repr((_CMD, _LIBS, _host_cpu())).encode())
    return BUILD_DIR / f"_image_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile to a temporary name and rename, so that a concurrent process
    never loads a half-written library. Returns the error, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(_CMD + [str(_SRC), "-o", str(tmp)] + _LIBS, check=True,
                       capture_output=True, text=True)
    except FileNotFoundError as e:
        return str(e)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        lines = (e.stderr or "").strip().splitlines()
        return f"{e}: {lines[0] if lines else ''}"
    os.replace(tmp, out)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None or "error" in build_info:
            return _lib
        so = library_path()
        if not so.exists():
            err = _build(so)
            if err is not None:
                build_info["error"] = err
                print(f"native_loader: build failed ({err}); using PIL fallback")
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:  # built where libjpeg's library was, not here
            build_info["error"] = f"loading {so.name} failed: {e}"
            print(f"native_loader: {build_info['error']}; using PIL fallback")
            return None
        for name, ptr in (("frcnn_load_image", ctypes.c_float),
                          ("frcnn_load_image_u8", ctypes.c_uint8)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ptr)] + [ctypes.c_int] * 5
        build_info["library"] = str(so)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _load_canvas(path: str, dtype, canvas_h: int, canvas_w: int, target_h: int,
                 target_w: int, flip: bool) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None or not path.lower().endswith((".jpg", ".jpeg")):
        return None
    out = np.empty((canvas_h, canvas_w, 3), dtype)
    fn, ptr = ((lib.frcnn_load_image_u8, ctypes.c_uint8) if dtype == np.uint8
               else (lib.frcnn_load_image, ctypes.c_float))
    rc = fn(path.encode(), out.ctypes.data_as(ctypes.POINTER(ptr)),
            canvas_h, canvas_w, target_h, target_w, int(flip))
    return out if rc == 0 else None


def load_canvas_native(path: str, canvas_h: int, canvas_w: int, target_h: int,
                       target_w: int, flip: bool = False) -> Optional[np.ndarray]:
    """Full native pipeline -> (canvas_h, canvas_w, 3) float32 preprocessed
    canvas, or None if unavailable / not decodable (caller falls back)."""
    return _load_canvas(path, np.float32, canvas_h, canvas_w, target_h, target_w, flip)


def load_canvas_native_u8(path: str, canvas_h: int, canvas_w: int, target_h: int,
                          target_w: int, flip: bool = False) -> Optional[np.ndarray]:
    """Native decode+resize+flip+pad -> (canvas_h, canvas_w, 3) RAW RGB uint8
    canvas (no preprocessing: that runs on the device, in
    train/pipeline.ingest_images). None if unavailable (caller falls back)."""
    return _load_canvas(path, np.uint8, canvas_h, canvas_w, target_h, target_w, flip)
