"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library with
a plain C interface, loaded with :mod:`ctypes`.  Sources build in parallel
(one ``nvcc`` per source, all started together) into :data:`BUILD_DIR`,
next to the sources and listed in ``.gitignore``.  A library's file name
carries a digest of its source, the shared headers and the flags, so a
changed source is rebuilt and a stale library is never loaded.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` — the port holds
its kernels bit for bit against their plain PyTorch versions, so no product
is contracted into a fused multiply-add behind the source's back; the few
the reference forms are written out as ``__fmaf_rn``.  No
``--use_fast_math``: divisions stay IEEE divisions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("l1_topk2", "centroid_update", "serve_fused", "fleet_fused",
           "fleet_priority", "pairwise_l1", "flash_attn", "decode_gqa",
           "rglru_scan", "flash_attn_bwd", "rglru_scan_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha1()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler output of library ``name``'s build, kept beside it
    (built first if it is not yet)."""
    log = lib_path(name).with_suffix(".log")
    if not log.exists():
        build((name,))
    return log.read_text()


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel.  Returns ``{name: compiler output}`` of this call's builds
    (``-Xptxas -v`` prints registers, shared memory and spills per kernel),
    each also kept beside its library (:func:`build_log`); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def stream_handle(device) -> ctypes.c_void_p:
    """The raw handle of PyTorch's current CUDA stream on ``device``, read
    without building a ``torch.cuda.Stream`` (a fraction of a microsecond
    of host time where ``torch.cuda.current_stream`` takes several:
    ``tools/kernel_device_times.py --only A``)."""
    import torch

    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def no_grad_inputs(kernel: str, *tensors) -> None:
    """Raise if autograd would need a gradient of one of ``tensors``: a
    kernel launched through ctypes builds no graph, so its output would
    silently drop that gradient."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: call it under "
                           f"torch.no_grad() or on inputs that need no "
                           f"gradient")


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
