"""Shared plumbing for the hand-written score kernels (port of
``fia_tpu/influence/kernels/common.py:52-73, 96-102``): the per-query
operand pack, the score epilogue, and the build-and-load of the CUDA
libraries.

Kernel sources live in ``csrc/``. Each is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``: a few seconds a source, against minutes for an
extension that includes PyTorch's headers. Libraries are built at first
use into ``fia_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, so an edited source rebuilds and a
fresh checkout builds from its own sources. Nothing is built or loaded
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from fia_tpu_torch.utils import io

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# where nvcc is looked for after $CUDA_HOME/bin, before $PATH
NVCC_DIRS = ("/usr/local/cuda/bin",)

_LOADED: dict = {}  # (name, symbol) -> ctypes function


def query_matrix(ihvp, reg_dot, n_t) -> torch.Tensor:
    """Augmented per-query operand ``B = [ihvp | reg_dot | n_t]``,
    (T, d + 2) float32, contiguous. The kernel divides by the n_t
    column (rather than multiplying by a reciprocal) to keep the
    epilogue the same arithmetic as the plain version."""
    return torch.cat(
        [ihvp, reg_dot[:, None], n_t[:, None]], dim=1
    ).to(torch.float32).contiguous()


def score_epilogue(gdot, e, wv, Bt, d: int) -> torch.Tensor:
    """(S,) scores from the per-row gradient·iHVP dot and each row's B
    row ``Bt``: wv · (2 e gdot + reg_dot) / n_t."""
    return wv * (2.0 * e * gdot + Bt[:, d]) / Bt[:, d + 1]


def count_launch(module) -> None:
    """Count one launch of ``module``'s kernel: in ``module.launches``,
    or in ``module.captured`` while the current stream is capturing a
    CUDA graph (the launch is recorded, not run)."""
    if torch.cuda.is_current_stream_capturing():
        module.captured += 1
    else:
        module.launches += 1


#: cudaGetErrorString's text of the codes a kernel launch can return: a
#: launch error of the kernel itself (a bad configuration, too many
#: resources) stays unclassified by the reliability taxonomy and rises,
#: while a sticky error left by earlier work classifies as a lost device
CUDA_ERRORS = {
    1: "invalid argument",
    2: "out of memory",
    9: "invalid configuration argument",
    98: "invalid device function",
    209: "no kernel image is available for execution on the device",
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    701: "too many resources requested for launch",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    718: "invalid program counter",
    719: "unspecified launch failure",
    900: "operation not permitted when stream is capturing",
    901: "operation failed due to a previous error during capture",
}


def launch_error(name: str, rc: int) -> RuntimeError:
    """The error a wrapper raises when its C entry returns ``rc`` != 0:
    the code with its CUDA text. The taxonomy reads a sticky error here
    as a lost device, as in PyTorch's own CUDA errors, and leaves every
    other code unclassified (out of memory included), so a kernel that
    cannot launch rises."""
    text = CUDA_ERRORS.get(int(rc), "unrecognised CUDA error")
    return RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                        f"({text})")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``$PATH``; raises when there is none."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(os.path.join(os.environ["CUDA_HOME"], "bin"))
    dirs.extend(NVCC_DIRS)
    for d in dirs:
        path = os.path.join(d, "nvcc")
        if os.access(path, os.X_OK):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, "
            f"{', '.join(NVCC_DIRS)} and $PATH): the CUDA kernels cannot "
            "be built"
        )
    return path


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu``, keyed by a hash
    of the source and the flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict[str, float]:
    """Build the libraries of ``names`` that are not built yet, one
    ``nvcc`` each, all started together. Returns the seconds each took
    (0.0 for one already built). ``nvcc``'s output, with ``ptxas``'s
    register and spill report, is kept beside each library
    (:func:`build_log`). Raises if any build fails."""
    todo = {}
    for name in names:
        so = library_path(name)
        if not os.path.exists(so):
            todo[name] = so
    if not todo:
        return {name: 0.0 for name in names}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    secs, failed = {name: 0.0 for name in names}, []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        io.save_text_atomic(so + ".log", log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """``nvcc``'s output from building ``csrc/<name>.cu``."""
    with open(library_path(name) + ".log") as f:
        return f.read()


def load_function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, built if need
    be, with ``argtypes`` set and an ``int`` (cudaError_t) result;
    loaded once a process."""
    fn = _LOADED.get((name, symbol))
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(library_path(name)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LOADED[(name, symbol)] = fn
    return fn
