"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/vsearch_tpu_torch/lib<source>.so`` (a
git-ignored directory) at first use, then loaded with ctypes.  A source
may hold more than one kernel (``SOURCES``: K1 and K4 share one body, K2
and K2m's 32-bit body are two instantiations of one template beside K2m's
16-bit body, K3 and K7 are the two backtracks).
Nothing here runs when a module is imported: the CPU tests import every
module on a machine without nvcc or a card.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets it, drives the main path and reads it to show which kernels ran.
``PLAIN_CALLS`` counts the calls a wrapper served with the plain PyTorch
version instead (tensors on the CPU), so a CPU run can show the same.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from .. import native

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = native.BUILD_DIR
# kernel -> the csrc/ source that holds it
SOURCES = {"score_dense": "score_dense", "score_ranked": "score_dense",
           "nw_rowscan": "nw_rowscan", "nw_rowscan_mr": "nw_rowscan",
           "nw_rowscan_mr16": "nw_rowscan",
           "nw_backtrack": "nw_backtrack", "nw_stats": "nw_stats",
           "nw_wavefront": "nw_wavefront",
           "nw_backtrack_flat": "nw_backtrack"}
KERNELS = tuple(SOURCES)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_CALLS: Dict[str, int] = {k: 0 for k in KERNELS}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def so_path(source: str) -> pathlib.Path:
    return BUILD_DIR / ("lib%s.so" % source)


def _stale(source: str) -> bool:
    so = so_path(source)
    return (not so.exists()
            or so.stat().st_mtime < (CSRC / (source + ".cu")).stat().st_mtime)


def build(kernels: Iterable[str] = KERNELS, force: bool = False
          ) -> Dict[str, dict]:
    """Compile the sources of the named kernels, one nvcc process per
    source, all started together.  Returns {source: {"seconds", "ptxas"}}
    for what was built; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in dict.fromkeys(SOURCES[k] for k in kernels):
        if not force and not _stale(name):
            continue
        tmp = so_path(name).with_name("lib%s.so.%d" % (name, os.getpid()))
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp),
                                        str(CSRC / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    out = {}
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, log))
            continue
        os.replace(tmp, so_path(name))
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(kernel: str) -> ctypes.CDLL:
    """The loaded library holding a kernel, built first if missing or
    stale."""
    source = SOURCES[kernel]
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            if _stale(source):
                build([kernel])
            lib = ctypes.CDLL(str(so_path(source)))
            _libs[source] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (name, rc))


def stream_ptr(device) -> Optional[int]:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
