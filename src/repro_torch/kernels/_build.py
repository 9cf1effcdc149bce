"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

The libraries go to ``kernels/build/<hash>/``, keyed by a hash of every
source under ``csrc/`` and the flags, so an edited source builds anew and an
unchanged one is built once. Beside each goes ``lib<name>.log``, nvcc's
output, where ptxas reports every kernel's registers and spills
(``ptxas_usage`` reads it). A failed build raises with nvcc's output:
nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def build_all() -> Path:
    """Compile every source that is not built yet; return the build dir."""
    out_dir = BUILD_ROOT / source_hash()
    todo = [src for src in sources()
            if not (out_dir / f"lib{src.stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, tmp, cmd, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        (out_dir / f"lib{src.stem}.log").write_text(log)
        os.replace(tmp, out_dir / f"lib{src.stem}.so")   # atomic publish
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out_dir


def ptxas_usage(build_dir: Path) -> Dict[str, List[dict]]:
    """Per library, each kernel entry's registers and spill bytes, as
    ptxas reported them when the library was built."""
    out = {}
    for log in sorted(build_dir.glob("lib*.log")):
        entries = []
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entries.append({"entry": m.group(1)})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entries:
                entries[-1]["spill_store_bytes"] = int(m.group(1))
                entries[-1]["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entries:
                entries[-1]["registers"] = int(m.group(1))
        out[log.stem[3:]] = entries
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building the kernels first."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if the C entry point ``name`` returned a CUDA error code."""
    if code != 0:
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        msg = err(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launch: the
    raw handle, without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream(device).cuda_stream`` builds per call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def refuse_autograd(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise where grad mode is on and an input requires grad: the kernel
    ``name`` has no backward, and its output would carry no graph (a
    gradient that silently never arrives)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; {why}")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is contiguous and on the current CUDA
    device; return that device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev
