"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into `_build/lib<name>-<hash>.so`,
a shared library with a plain C interface that `ctypes` loads (no PyTorch
headers, so a build takes seconds). The hash covers the source and the
flags, so an edited source never loads a stale library. Nothing here runs
at import time: the first kernel launch builds its library, and
`build_all()` builds every library at once, one `nvcc` process per source.

The same cache builds the one host library of the port, the native point
cloud loader: `runtime/pointcloud_loader.cc` (shared with the JAX package,
which builds it into `runtime/`; the port never writes there) compiles
with the host's C++ compiler into `_build/libpointcloud_loader-<hash>.so`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# host C++ libraries: name -> source
HOST_SOURCES = {"pointcloud_loader": Path(__file__).resolve().parents[2] / "runtime" / "pointcloud_loader.cc"}
_HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
# CUDA sources of the experiments: kernels that the package replaced, kept
# to be timed beside their successors; name -> source, built as the kernels
EXPERIMENT_SOURCES = {"blocked_bwd_per_piece": Path(__file__).resolve().parents[1] / "experiments"
                      / "blocked_bwd_per_piece.cu"}

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg available to later kernels.
_COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-library extra flags. NMS and the matcher must equal their plain
# versions bit for bit (keep masks; IoUs compared with ==), so no
# multiply-add contraction and IEEE division (no --use_fast_math); so must
# the InstanceNorm's apply pass for equal statistics, and the voxelizer's
# cells, floored from (p - offset) / voxel_size as the plain version does.
EXTRA_FLAGS = {
    "scatter": (),
    "nms": ("-fmad=false", "-prec-div=true"),
    "matcher": ("-fmad=false", "-prec-div=true"),
    "fence": (),
    "instance_norm": ("-fmad=false", "-prec-div=true"),
    "voxelize": ("-fmad=false", "-prec-div=true"),
}


class LaunchCounter:
    """A plain count of a kernel's launches; its wrapper adds one where it
    launches the kernel and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


def nvcc_path() -> str:
    """The `nvcc` to build with: $CUDA_HOME/bin, PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cxx_path() -> str:
    """The host C++ compiler: $CXX, then `g++` on PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")
    return found


def _recipe(name: str) -> tuple[Path, tuple[str, ...]]:
    """(source, flags) of one library."""
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], _HOST_FLAGS
    if name in EXPERIMENT_SOURCES:
        return EXPERIMENT_SOURCES[name], _COMMON_FLAGS
    return CSRC / f"{name}.cu", _COMMON_FLAGS + EXTRA_FLAGS[name]


def _library_path(name: str) -> Path:
    source, flags = _recipe(name)
    digest = hashlib.sha256(source.read_bytes() + b"\0" + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start the compiler for one library unless it is built; None if it is."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    source, flags = _recipe(name)
    compiler = cxx_path() if name in HOST_SOURCES else nvcc_path()
    cmd = [compiler, *flags, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    (out.with_suffix(".log")).write_text(log)
    return log


def build_all(names=tuple(EXTRA_FLAGS)) -> dict[str, str]:
    """Build every named library in parallel; returns each build's compiler
    log (`-Xptxas -v`: registers, shared memory, spills), or the log of the
    earlier build where the library was already there."""
    started = {name: _start(name) for name in names}
    logs = {}
    for name, job in started.items():
        if job is None:
            log_file = _library_path(name).with_suffix(".log")
            logs[name] = log_file.read_text() if log_file.exists() else "(built earlier)"
        else:
            logs[name] = _finish(name, *job)
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build library `name` if needed and load it (once per process)."""
    job = _start(name)
    if job is not None:
        _finish(name, *job)
    return ctypes.CDLL(str(_library_path(name)))
