"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, and loaded with ctypes; the Python wrappers
pass raw device pointers and PyTorch's current stream.  The libraries are
built at first use, all ``nvcc`` processes started together, into
``build/repro_torch_kernels/`` at the repository root.  A library's file
name carries a hash of every source in ``csrc/``, so an edited source is
rebuilt and an unchanged one is loaded as it is.

No source includes PyTorch's headers: a file that does compiles for minutes,
one with a plain C interface in seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("moe_ffn", "gqa_decode", "flash_prefill", "paged_decode",
           "paged_mla_decode", "expert_gather")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha1()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel library that is not built yet (one ``nvcc`` per
    source, all running at once) and load them all.  Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    outs = {name: BUILD_DIR / f"{name}-{tag}.so" for name in KERNELS}
    procs = {}
    for name, out in outs.items():
        if name in _libs or out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if log.strip():
            (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name, out in outs.items():
        if name not in _libs:
            lib = ctypes.CDLL(str(out))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return dict(_libs)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all of them at first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def function(name: str, symbol: str, argtypes):
    """A launch function of one kernel library, its ctypes signature set
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(lib(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch function reported a CUDA error."""
    if err != 0:
        msg = lib(name).repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def require_operands(kernel: str, dtype: torch.dtype, device: torch.device,
                     **tensors) -> None:
    """Raise unless every tensor is contiguous, of `dtype` and on `device`
    — what the kernels take."""
    for name, t in tensors.items():
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous "
                             f"{dtype} tensor on {device}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
