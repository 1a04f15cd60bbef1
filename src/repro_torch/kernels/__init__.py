"""Build and load the port's hand-written CUDA kernels.

Every kernel source is `csrc/<name>.cu`, a file with a plain C interface
that may include the shared headers `csrc/*.cuh`.  It is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library under `build/` beside
this file (listed in `.gitignore`) at first use, and loaded with `ctypes`.
The library's name carries a digest of the source, every header and the
flags, so an edited source or header is rebuilt and a stale library never
loads.  With a persistent cache directory (`use_cache_dir`, the training
job's `--compile-cache`) the libraries go under it instead, in a directory
named by the nvcc version, the target and a digest of every source, and a
library found there is loaded without running nvcc (`cache_hits` counts
those loads).  Nothing here runs at import: the CPU-only test machine has
no `nvcc`.

There is no fallback: a missing compiler, a failed build or a failed
launch raises.

Also here: the argument checks the kernels' wrappers share (the streaming
kernels' bucket table is in `buckets.py`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# -split-compile=0: the front end and ptxas work on a source's kernels in
# parallel, a job a core; flash_attention.cu's 16 kernels would otherwise
# take most of a build
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH)."""
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand, "bin", "nvcc")
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


# the persistent cache: its root (None: build under BUILD_DIR) and the
# libraries this process loaded from it instead of building
_CACHE = {"root": None, "hits": 0}


def use_cache_dir(root) -> Path:
    """Build into and load from the persistent cache under `root` from now
    on (libraries already loaded stay loaded).  Returns `root`, absolute."""
    _CACHE["root"] = Path(root).resolve()
    _CACHE["root"].mkdir(parents=True, exist_ok=True)
    return _CACHE["root"]


def cache_hits() -> int:
    """Libraries this process loaded from the persistent cache."""
    return _CACHE["hits"]


@functools.cache
def _toolchain_key() -> str:
    """The cache directory's name: nvcc's version, the target and a digest
    of every source and header."""
    out = subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    found = re.search(r"\bV(\d+(?:\.\d+)+)", out)    # "... release 12.4, V12.4.131"
    version = found.group(1) if found else "unknown"
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode() + src.read_bytes())
    return f"nvcc-{version}-sm_90a-{digest.hexdigest()[:16]}"


def library_path(name: str) -> Path:
    """The library of `name`: under BUILD_DIR, or the persistent cache."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(repr(NVCC_FLAGS).encode())
    where = BUILD_DIR if _CACHE["root"] is None else _CACHE["root"] / _toolchain_key()
    return where / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for `name` (None when its library is already built)."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, cmd


def _finish(started) -> str:
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names) -> dict:
    """Build every named kernel library, one nvcc each, all started together.
    Returns {name: compiler log} for the libraries built by this call."""
    started = {n: _start(n) for n in names}
    logs = {}
    try:
        for n, s in started.items():
            if s is not None:
                logs[n] = _finish(s)
                started[n] = None
    finally:
        for s in started.values():   # a failed build: stop the others
            if s is not None:
                s[0].kill()
                s[0].wait()
                if os.path.exists(s[1]):
                    os.unlink(s[1])
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed (once per process)."""
    path = library_path(name)
    if _CACHE["root"] is not None and path.exists():
        _CACHE["hits"] += 1
    build_all([name])
    return ctypes.CDLL(str(path))


def check_operands(kernel: str, device, float_args: dict, f32_args=None):
    """Raise unless every tensor is contiguous and lies on the CUDA
    `device`, every `float_args` tensor is float32 or bfloat16 and every
    `f32_args` tensor float32."""
    f32_args = f32_args or {}
    for name, t in {**float_args, **f32_args}.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel}: {name} must lie on the CUDA device "
                             f"{device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    for name, t in float_args.items():
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    for name, t in f32_args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got {t.dtype}")


def check_no_grad(kernel: str, *tensors):
    """Raise when autograd would need a gradient through `kernel`: the
    forward-only kernels (rmsnorm, flash_attention) have no backward, and
    a tensor on the card never silently takes the plain version instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad() or inference_mode()")


def check_launch(lib: ctypes.CDLL, err: int, kernel: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        fn = lib.repro_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
