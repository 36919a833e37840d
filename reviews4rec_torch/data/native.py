"""ctypes bridge to the native (C++/OpenMP) record materializer.

The port's own copy of `reviews4rec_tpu/data/native.py`. It builds
`reviews4rec_torch/csrc/materialize.cc` with g++ (`-O3 -fopenmp`, a
plain `extern "C"` interface, no pybind11) at first use into
`build/native/libmaterialize-<hash>.so` at the root of the checkout; the
hash covers the source and the flags, so an edited source builds anew.
`materialize_records` returns None when the toolchain is missing or the
build failed, and the caller falls back to the numpy materializer, as
the JAX package does; `available()` says which of the two will run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "materialize.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmaterialize-{digest[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, out)  # a library is visible only once complete


def _load() -> ctypes.CDLL:
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _FAILED:
            raise RuntimeError("native materializer build failed earlier")
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.materialize_num_threads.restype = ctypes.c_int
            lib.materialize_records.restype = ctypes.c_int
            lib.materialize_records.argtypes = [
                _I32, _I64,                      # tokens, rev_off
                _I32, _I64, _I32,                # u_revs, u_off, u_other
                _I32, _I64, _I32,                # i_revs, i_off, i_other
                ctypes.c_int64,                  # n_examples
                _I32, _I32, _I32, _I32, _I32,    # user item ui iu this_rev
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # layout
                ctypes.c_int32, ctypes.c_int32,  # pad ids
                _I32, _I32, _I32, _I32, _I32,    # outputs
            ]
            _LIB = lib
        except Exception:
            _FAILED = True
            raise
        return _LIB


def available() -> bool:
    """Whether the native materializer builds and loads here."""
    try:
        _load()
        return True
    except Exception:
        return False


def num_threads() -> int:
    """The OpenMP threads a call runs on."""
    return int(_load().materialize_num_threads())


def materialize_records(flat: Dict, user, item, ui_idx, iu_idx, this_rev,
                        rows: int, words: int, slots: int,
                        user_pad: int, item_pad: int
                        ) -> Optional[Dict[str, np.ndarray]]:
    """The record tensors of `corpus.ReviewDataset._python_text`, built
    by the C++ materializer; None when it is not available."""
    try:
        lib = _load()
    except Exception:
        return None

    n = int(user.shape[0])
    user_doc = np.zeros((n, rows, words), np.int32)
    item_doc = np.zeros((n, rows, words), np.int32)
    this_doc = np.zeros((n, rows, words), np.int32)
    who_gave = np.zeros((n, slots), np.int32)
    reviewed = np.zeros((n, slots), np.int32)

    # contiguous copies, alive for the duration of the call
    keep = [np.ascontiguousarray(flat[k], np.int32) for k in
            ("tokens", "u_revs", "u_other", "i_revs", "i_other")]
    keep64 = [np.ascontiguousarray(flat[k], np.int64) for k in
              ("rev_off", "u_off", "i_off")]
    ex = [np.ascontiguousarray(a, np.int32)
          for a in (user, item, ui_idx, iu_idx, this_rev)]

    rc = lib.materialize_records(
        keep[0].ctypes.data_as(_I32), keep64[0].ctypes.data_as(_I64),
        keep[1].ctypes.data_as(_I32), keep64[1].ctypes.data_as(_I64),
        keep[2].ctypes.data_as(_I32),
        keep[3].ctypes.data_as(_I32), keep64[2].ctypes.data_as(_I64),
        keep[4].ctypes.data_as(_I32),
        ctypes.c_int64(n),
        ex[0].ctypes.data_as(_I32), ex[1].ctypes.data_as(_I32),
        ex[2].ctypes.data_as(_I32), ex[3].ctypes.data_as(_I32),
        ex[4].ctypes.data_as(_I32),
        rows, words, slots, user_pad, item_pad,
        user_doc.ctypes.data_as(_I32), item_doc.ctypes.data_as(_I32),
        this_doc.ctypes.data_as(_I32), who_gave.ctypes.data_as(_I32),
        reviewed.ctypes.data_as(_I32))
    if rc != 0:
        return None
    return {"user_doc": user_doc, "item_doc": item_doc,
            "this_doc": this_doc, "users_who_gave": who_gave,
            "items_reviewed": reviewed}
