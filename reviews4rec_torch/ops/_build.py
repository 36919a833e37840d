"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` on its own into
`build/kernels/lib<name>-<hash>.so` at the root of the checkout, with a
plain C interface that `ctypes` loads. The hash covers the source, the
headers of `csrc/` and the flags, so an edited source builds anew and an
unchanged one is reused. `build()` starts one `nvcc` per source, all at
once, and waits for them together.
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
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of reviews4rec_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the headers a source may include
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named source that has no library yet, in parallel.
    Returns the seconds each compile took (0 for one already built);
    raises with the compiler's output if one fails. Each library's
    `ptxas` report (registers, shared memory, spills) is kept beside it
    as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, lib, log, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, lib, log, t0) in jobs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{log.read_text()}")
            continue
        os.replace(tmp, lib)  # a library is visible only once complete
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    with _LOCK:
        if name not in _LOADED:
            build([name])
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]
