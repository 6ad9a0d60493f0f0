"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` (one ``nvcc`` per
source, all started together) and linked into one shared library with a
plain C interface.  The library's name carries a hash of the sources
and flags, so a rebuild happens only when they change; it lives in the
package's ``_build/`` directory (not committed).  The build runs at first
use, never at import.  A missing ``nvcc`` or a failed build raises
``RuntimeError`` with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}
# the wrappers' launch counters and their ctypes bindings are shared by
# every thread that calls a kernel (the HTTP server runs requests on many)
count_lock = threading.Lock()
bind_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    default toolkit location.  Raises RuntimeError when there is none."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(CUDA_HOME_DEFAULT) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{CUDA_HOME_DEFAULT}/bin): the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir) / f"libatt_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list) -> None:
    """Run the commands side by side; raise with the first failure's
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (stdout, stderr) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless a library of the
    same sources already exists; returns its path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [s for s in sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        objs = [str(Path(tmp_dir) / f"{s.stem}.o") for s in cu]
        _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", o, str(s)]
              for s, o in zip(cu, objs)])
        tmp = str(Path(tmp_dir) / out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a loader never sees half a file
    return out


def load_library(build_dir=None) -> ctypes.CDLL:
    """The built kernel library, building it first when needed; in
    ``BUILD_DIR`` as it stands at the call unless ``build_dir`` is given
    (``utils.serving.enable_compilation_cache`` moves it)."""
    with _lock:
        build_dir = BUILD_DIR if build_dir is None else build_dir
        key = str(build_dir)
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(build(build_dir)))
        return _loaded[key]


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise ValueError when an input of ``kernel`` requires grad: a
    kernel's outputs carry no autograd graph and no kernel has a backward
    pass, so a gradient through it would be cut without a word.  The plain
    versions keep their autograd."""
    if any(getattr(t, "requires_grad", False) for t in inputs):
        raise ValueError(
            f"{kernel}: an input requires grad, and the kernel has no "
            "backward pass (its outputs would carry no gradient); detach the "
            "input, or differentiate through the plain version")


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.att_error_string.argtypes = [ctypes.c_int]
        lib.att_error_string.restype = ctypes.c_char_p
        msg = lib.att_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
