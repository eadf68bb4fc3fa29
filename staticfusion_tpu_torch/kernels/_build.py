"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` of the package with nvcc (one
process per source, in parallel) into one shared library with a plain C
interface, at first use, and loads it with ctypes.  The library goes to
`build/torch_kernels/` at the repository root when the package sits in a
checkout whose root is writable; an installed package (or a read-only
checkout) builds into the per-user cache directory
`$XDG_CACHE_HOME/staticfusion_tpu_torch/kernels` (`~/.cache` when the
variable is unset).  The library's name carries a hash of the sources, so
an edited source rebuilds and an unchanged one loads the existing file.
A failed build raises with nvcc's output.  `install` (a pid-tagged
temporary file, then `os.replace`) and `build_dir` are shared with the
native I/O library's build (`io/native.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# The repository root, when the package sits in a checkout.
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sf_preprocess": [_P, _P, _P, _P, _I, _I, _F, _F, _P],
    "sf_spd_solve": [_P, _P, _P, _I, _I, _F, _I, _P],
    "sf_irls_max_blocks": [_I],
    "sf_irls_solve": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                      _P, _P, _F, _P, _P, _F, _F, _I, _P, _P, _I, _F, _F,
                      _F, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash(paths=None) -> str:
    """Hash of the sources' names and bytes (default: the CUDA sources)."""
    h = hashlib.sha256()
    for p in _sources() if paths is None else paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from staticfusion_tpu_torch/csrc at first "
                       "use")


def user_cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "staticfusion_tpu_torch" / "kernels"


def _writable(d: Path) -> bool:
    """True when `d` exists or can be made, and a file can be created in
    it (tried, not inferred from the mode bits)."""
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=d):
            pass
    except OSError:
        return False
    return True


def build_dir() -> Path:
    """`BUILD_DIR` in a checkout (a `pyproject.toml` at the repository
    root) that is writable, else the per-user cache directory."""
    if (REPO_ROOT / "pyproject.toml").is_file() and _writable(BUILD_DIR):
        return BUILD_DIR
    return user_cache_dir()


def library_path() -> Path:
    return build_dir() / f"libsf_kernels_{source_hash()}.so"


def _run_all(cmds, tool: str = "nvcc") -> None:
    """Run the commands at once and wait for every one; raise with the
    output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + log)
    if failed:
        raise RuntimeError(f"{tool} failed:\n" + "\n".join(failed))


def install(out: Path, make) -> Path:
    """Build the library `out` unless it exists.  `make(tmp)` writes it to
    `tmp`, a name tagged with this process's id in the same directory
    (other files it makes carry the same tag, and it removes them), which
    then replaces `out` in one `os.replace`: processes that build at once
    never load a half-written file, and the last one's copy stays."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.tmp{os.getpid()}.so"
    try:
        make(tmp)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    per source, all started together, then one link."""
    def make(tmp: Path) -> None:
        srcs = sorted(CSRC.glob("*.cu"))
        if not srcs:
            raise RuntimeError(f"no CUDA sources in {CSRC}: the package was "
                               "installed without its csrc/ package data")
        nvcc = _nvcc()
        objs = [tmp.parent / f"{tmp.stem}.{p.stem}.o" for p in srcs]
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                      for p, o in zip(srcs, objs)])
            _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    return install(library_path(), make)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def on_cuda(t) -> bool:
    """Dispatch rule of the kernel wrappers: True for a CUDA tensor (run the
    CUDA kernel), False for a CPU tensor (run the plain version); any other
    device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}: the port runs on "
                         "CUDA (kernels) or the CPU (plain versions)")
    return t.device.type == "cuda"


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
