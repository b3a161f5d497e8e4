"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The libraries go to ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source rebuilds and an
unchanged one is reused.  ``build_all`` starts one nvcc per source at once.
Nothing builds at import: the first ``library(name)`` call does.

``launch_counts`` holds one plain integer per kernel.  Each wrapper in
``kernels/<name>/kernel.py`` adds one where it launches its kernel and
nowhere else, so a caller can zero the counts, drive a path, and read which
kernels that path really ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("gaussian_block", "fused_assemble_id", "zmu_update", "laplacian_block",
           "flash_attention", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: dict[str, int] = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    # The shared headers count too: an edit of one rebuilds every source.
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every missing library, one nvcc per source, all at once.

    Returns {name: ptxas report} for the sources built by this call.  Raises
    RuntimeError with nvcc's output if any build fails.
    """
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.is_file():
            build_all((name,))
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def function(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """C entry point ``symbol`` of kernel library ``name``, with its types
    declared (ctypes would otherwise pass every pointer as a 32-bit int)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
