"""ctypes bindings to the native I/O library: a zlib PNG decoder, a
threaded prefetching frame loader and a binary PLY writer (port of
staticfusion_tpu/io/native.py).

The sources are `csrc/io/*.cpp` of this package (byte copies of the
repository's `native/`).  The first call that needs the library compiles
them with g++ into `libsfio_<hash>.so` in the kernels' build directory
(`kernels/_build.py::build_dir`: `build/torch_kernels/` in a writable
checkout, else the per-user cache), through the same pid-tagged temporary
file and `os.replace` as the CUDA kernels, so processes that build at once
never load a half-written file.  Importing this module builds nothing.  A
failed build raises with g++'s output; nothing falls back silently.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from staticfusion_tpu_torch.kernels import _build

IO_SRC = _build.CSRC / "io"
# native/Makefile's flags (without -Wall).
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LD_FLAGS = ["-lz", "-lpthread"]

_lib = None

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_PF = ctypes.POINTER(ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int)
# name: (restype, argtypes)
_SIGNATURES = {
    "sf_decode_png": (_I, [ctypes.c_char_p, ctypes.POINTER(_P), _PI, _PI,
                           _PI, _PI]),
    "sf_free": (None, [_P]),
    "sf_loader_create": (_P, [ctypes.POINTER(ctypes.c_char_p),
                              ctypes.POINTER(ctypes.c_char_p), _I, _I, _F,
                              _I, _I]),
    "sf_loader_get": (_I, [_P, _I, _PF, _PF, _PI, _PI]),
    "sf_loader_destroy": (None, [_P]),
    "sf_write_ply": (_L, [ctypes.c_char_p, _L, _PF, _PF, _PF, _PF, _PF,
                          ctypes.POINTER(ctypes.c_uint8), _F]),
}


def _sources():
    return sorted(IO_SRC.glob("*.cpp"))


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++") or ""):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found (set CXX): the native I/O library is "
                       "built from staticfusion_tpu_torch/csrc/io at first "
                       "use")


def library_path() -> Path:
    h = _build.source_hash(_sources())
    return _build.build_dir() / f"libsfio_{h}.so"


def build() -> Path:
    """Compile csrc/io/*.cpp into the hashed library unless it exists."""
    def make(tmp: Path) -> None:
        srcs = _sources()
        if not srcs:
            raise RuntimeError(f"no C++ sources in {IO_SRC}: the package "
                               "was installed without its csrc/io/ package "
                               "data")
        _build._run_all([[_cxx(), *CXX_FLAGS, "-o", str(tmp),
                          *map(str, srcs), *LD_FLAGS]], tool="g++")
    return _build.install(library_path(), make)


def load() -> ctypes.CDLL:
    """The native I/O library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def decode_png(path: str) -> Optional[np.ndarray]:
    """(H, W) or (H, W, C), uint8 or uint16; None when the decoder rejects
    the file."""
    lib = load()
    out = ctypes.c_void_p()
    w, h, ch, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.sf_decode_png(os.fsencode(path), ctypes.byref(out),
                           ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(ch), ctypes.byref(bd))
    if rc != 0:
        return None
    n = w.value * h.value * ch.value
    ctype = ctypes.c_uint16 if bd.value == 16 else ctypes.c_uint8
    buf = np.ctypeslib.as_array(ctypes.cast(out, ctypes.POINTER(ctype)),
                                (n,)).copy()
    lib.sf_free(out)
    if ch.value == 1:
        return buf.reshape(h.value, w.value)
    return buf.reshape(h.value, w.value, ch.value)


def _png_size(path: str):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n":
        raise IOError(f"{path}: not a PNG file")
    return (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"))


class NativeFrameLoader:
    """Threaded prefetching loader over (rgb, depth) PNG path pairs: each
    frame comes back subsampled by `res_factor`, rgb in [0, 1] and depth
    times `depth_to_mm`.  Consume frames in ascending order."""

    def __init__(self, rgb_paths, depth_paths, res_factor=2,
                 depth_to_mm=0.2, queue_depth=8, n_threads=2):
        self._lib = load()
        n = len(rgb_paths)
        rgb = (ctypes.c_char_p * n)(*map(os.fsencode, rgb_paths))
        dep = (ctypes.c_char_p * n)(*map(os.fsencode, depth_paths))
        self._h = self._lib.sf_loader_create(rgb, dep, n, res_factor,
                                             depth_to_mm, queue_depth,
                                             n_threads)
        self.n = n
        self.res_factor = res_factor
        self._rgb_paths = list(rgb_paths)

    def get(self, idx: int, rows: int, cols: int):
        # The library waits for frame idx and copies the whole decoded
        # frame into the buffers, so the index and the size (from the
        # PNG's header) are checked first.
        if not 0 <= idx < self.n:
            raise IndexError(f"frame {idx} of {self.n}")
        pw, ph = _png_size(self._rgb_paths[idx])
        if (ph // self.res_factor, pw // self.res_factor) != (rows, cols):
            raise ValueError(f"frame {idx} is {ph}x{pw} / {self.res_factor}, "
                             f"not {rows}x{cols}")
        rgb = np.empty((rows, cols, 3), np.float32)
        depth = np.empty((rows, cols), np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.sf_loader_get(self._h, idx,
                                     rgb.ctypes.data_as(_PF),
                                     depth.ctypes.data_as(_PF),
                                     ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"native loader failed on frame {idx}: {rc}")
        if (h.value, w.value) != (rows, cols):
            raise IOError(f"frame {idx} decoded {h.value}x{w.value}, "
                          f"expected {rows}x{cols}")
        return rgb, depth

    def close(self):
        if self._h:
            self._lib.sf_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_ply_native(path: str, smap, conf_threshold: float) -> int:
    """Write the surfels of `smap` (the port's SurfelMap, tensors on any
    device) that are valid and above `conf_threshold` as binary PLY;
    returns the vertex count."""
    lib = load()

    def host(t, dtype):
        return np.ascontiguousarray(t.detach().cpu().numpy(), dtype)

    pos, conf, color, normal, radius = (
        host(t, np.float32) for t in (smap.pos, smap.conf, smap.color,
                                      smap.normal, smap.radius))
    valid = host(smap.valid, np.uint8)
    n = lib.sf_write_ply(os.fsencode(path), pos.shape[0],
                         *(a.ctypes.data_as(_PF)
                           for a in (pos, conf, color, normal, radius)),
                         valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         conf_threshold)
    if n < 0:
        raise IOError(f"cannot write {path}")
    return n
