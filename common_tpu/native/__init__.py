"""Native (C++) host-side components, loaded via ctypes.

The JAX rebuild keeps inference on-device, so the host-native layer
(reference: the whole C++ core) serves what still runs hot on the host:
the exact-enumeration oracle machinery (partition enumeration /
canonicalization / ranking).  Compiled on first use with g++ into a
cached shared object; everything degrades gracefully to the pure-Python
implementations in testutil.py when no toolchain is present (set
COMMON_TPU_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "partition.cpp")
_SRCS = [os.path.join(_HERE, n) for n in ("partition.cpp", "loader.cpp")]
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_tag() -> Optional[str]:
    h = hashlib.sha256()
    try:
        for src in _SRCS:
            with open(src, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    return h.hexdigest()[:16]


def _build() -> Optional[str]:
    tag = _source_tag()
    prebuilt = os.path.join(_HERE, "partition_prebuilt.so")
    if os.path.exists(prebuilt):  # `python setup.py build_native`
        # Only trust the prebuilt if its sidecar hash matches the current
        # source (a stale oracle is worse than a rebuild); with no source
        # shipped at all (bare wheel), the prebuilt is the only option.
        try:
            with open(prebuilt + ".hash") as f:
                built_tag = f.read().strip()
        except OSError:
            built_tag = None
        if tag is None or built_tag == tag:
            return prebuilt
    if tag is None:
        return None  # no source, no matching prebuilt -> Python fallback
    cache_dir = os.environ.get(
        "COMMON_TPU_NATIVE_CACHE",
        os.path.join(tempfile.gettempdir(), "common_tpu_native"),
    )
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"partition_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
           + _SRCS + ["-o", tmp])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so_path)
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("COMMON_TPU_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.ct_bell.restype = ctypes.c_uint64
    lib.ct_bell.argtypes = [ctypes.c_int]
    lib.ct_enumerate.restype = ctypes.c_uint64
    lib.ct_enumerate.argtypes = [ctypes.c_int, i32p]
    lib.ct_canonicalize.restype = None
    lib.ct_canonicalize.argtypes = [i32p, ctypes.c_int64, ctypes.c_int, i32p]
    lib.ct_rank.restype = None
    lib.ct_rank.argtypes = [i32p, ctypes.c_int64, ctypes.c_int, i64p]
    # CSV loader (loader.cpp) — guarded: a prebuilt .so from an older
    # source set may lack the symbols
    try:
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.ct_csv_shape.restype = ctypes.c_long
        lib.ct_csv_shape.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)
        ]
        lib.ct_csv_load_f32.restype = ctypes.c_long
        lib.ct_csv_load_f32.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_long, ctypes.c_long,
            ctypes.c_int,
        ]
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def bell(n: int) -> int:
    """Bell number B(n) (partition count)."""
    lib = _load()
    if lib is not None and 0 < n <= 25:
        return int(lib.ct_bell(n))
    # Python fallback: Bell triangle
    row = [1]
    for _ in range(n - 1):
        nxt = [row[-1]]
        for v in row:
            nxt.append(nxt[-1] + v)
        row = nxt
    return row[0]


def enumerate_partitions(n: int) -> np.ndarray:
    """All canonical set partitions of n entities, lex order: [Bell(n), n]."""
    lib = _load()
    b = bell(n)
    if lib is not None and n <= 20:
        out = np.empty((b, n), np.int32)
        got = int(lib.ct_enumerate(n, out))
        assert got == b, (got, b)
        return out
    # fallback defers to testutil's generator (import here: no cycle at load)
    from common_tpu import testutil

    return np.array(list(testutil.permutation_iter(n)), np.int32).reshape(b, n)


def canonicalize_batch(assignments) -> np.ndarray:
    """First-occurrence relabel of a batch of assignment vectors [S, n]."""
    arr = np.ascontiguousarray(np.asarray(assignments, np.int32))
    if arr.ndim == 1:
        arr = arr[None, :]
    s, n = arr.shape
    lib = _load()
    out = np.empty_like(arr)
    if lib is not None:
        lib.ct_canonicalize(arr, s, n, out)
        return out
    for r in range(s):
        relabel = {}
        for t, a in enumerate(arr[r].tolist()):
            if a not in relabel:
                relabel[a] = len(relabel)
            out[r, t] = relabel[a]
    return out


def rank_partitions(canonical) -> np.ndarray:
    """Lex rank of canonical RGS vectors within enumerate_partitions order."""
    arr = np.ascontiguousarray(np.asarray(canonical, np.int32))
    if arr.ndim == 1:
        arr = arr[None, :]
    s, n = arr.shape
    lib = _load()
    out = np.empty(s, np.int64)
    if lib is not None:
        lib.ct_rank(arr, s, n, out)
        return out
    # fallback: completion-table ranking in numpy
    w = n + 2
    d = np.ones((n + 1, w), np.uint64)
    for i in range(n - 1, -1, -1):
        for j in range(w - 2, -1, -1):
            d[i, j] = np.uint64(j + 1) * d[i + 1, j] + d[i + 1, j + 1]
    for r in range(s):
        rank = 0
        maxg = 0
        row = arr[r]
        for i in range(1, n):
            for c in range(int(row[i])):
                rank += int(d[i + 1, max(c, maxg)])
            maxg = max(maxg, int(row[i]))
        out[r] = rank
    return out
