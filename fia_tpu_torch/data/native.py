"""ctypes bindings for the native data-path library (port of
``fia_tpu/data/native.py``; the library is ``native/fia_native.cpp``).

A fast TSV rating parser and CSR index construction, with the same API
as the reference's (``available``, ``parse_tsv``, ``build_csr``) and the
same numpy fallback, which gives the same arrays: the framework runs
without the library, and ``FIA_NATIVE=0`` forces the fallback.

The library is this package's own build of the source, made at first use
with ``native/Makefile``'s compiler and flags (``$CXX``, default ``g++``)
into ``fia_tpu_torch/_build/`` (listed in ``.gitignore``). It is named by
a hash of the source, the compiler, the flags and the host CPU, since
``-march=native`` builds for the CPU it runs on: a build directory carried
to another host rebuilds rather than loading a library for another CPU.
The compiler writes a per-process temporary name, renamed into place, so
processes that build at once never load a partial file. Nothing is
written under ``native/``, and the reference's ``native/libfia_native.so``
is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "fia_native.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "fia_tpu_torch", "_build")
#: ``native/Makefile``'s CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
BUILD_TIMEOUT_S = 120

_lib = None
_tried = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _host_cpu() -> str:
    """The host CPU's model name and feature flags (``/proc/cpuinfo``),
    or the machine type where that cannot be read."""
    model, flags = "", ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key == "model name" and not model:
                    model = value.strip()
                elif key in ("flags", "Features") and not flags:
                    flags = value.strip()
                if model and flags:
                    break
    except OSError:
        pass
    return f"{platform.machine()}|{model}|{flags}"


def library_path() -> str:
    """Path of this host's build of ``native/fia_native.cpp``."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((_cxx(),) + CXXFLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR, f"libfia_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless this host's build exists; returns its
    path. Raises if the compiler fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_cxx(), *CXXFLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed ({_cxx()} exit "
                           f"{proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, so)  # atomic: a reader never sees a partial file
    return so


def _load():
    global _lib, _tried
    if os.environ.get("FIA_NATIVE", "1") == "0":
        return None
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
        lib.fia_count_rows.restype = ctypes.c_int64
        lib.fia_count_rows.argtypes = [ctypes.c_char_p]
        lib.fia_parse_tsv.restype = ctypes.c_int64
        lib.fia_parse_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.fia_build_csr.restype = ctypes.c_int32
        lib.fia_build_csr.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError):
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_tsv_numpy(path: str, max_rows: int | None = None):
    """The fallback parser: ``np.loadtxt``."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    if max_rows is not None:
        raw = raw[:max_rows]
    return (raw[:, 0].astype(np.int32), raw[:, 1].astype(np.int32),
            raw[:, 2].astype(np.float32))


def build_csr_numpy(ids: np.ndarray, num_groups: int):
    """The fallback CSR construction: a stable argsort."""
    ids = np.ascontiguousarray(ids, np.int32)
    order = np.argsort(ids, kind="stable").astype(np.int64)
    counts = np.bincount(ids, minlength=num_groups)
    indptr = np.zeros(num_groups + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, order


def parse_tsv(path: str, max_rows: int | None = None):
    """(users, items, ratings) arrays from a ratings TSV file."""
    lib = _load()
    if lib is None:
        return parse_tsv_numpy(path, max_rows)

    n = lib.fia_count_rows(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    if max_rows is not None:
        n = min(n, max_rows)
    users = np.empty(n, np.int32)
    items = np.empty(n, np.int32)
    ratings = np.empty(n, np.float32)
    got = lib.fia_parse_tsv(
        path.encode(), n,
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ratings.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got < 0:
        raise IOError(f"cannot read {path}")
    return users[:got], items[:got], ratings[:got]


def build_csr(ids: np.ndarray, num_groups: int):
    """(indptr, indices) grouping row positions by id; stable order."""
    ids = np.ascontiguousarray(ids, np.int32)
    lib = _load()
    if lib is None:
        return build_csr_numpy(ids, num_groups)
    indptr = np.empty(num_groups + 1, np.int64)
    indices = np.empty(len(ids), np.int64)
    rc = lib.fia_build_csr(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ids), num_groups,
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError("id out of range in build_csr")
    return indptr, indices
