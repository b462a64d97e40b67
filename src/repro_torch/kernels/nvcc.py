"""Build a kernel source with `nvcc` into a shared library with a plain C
interface, once per source/flags hash.

Each kernel module (`bfc_step`, `flash_attention`, `rglru`, `rwkv6`) calls
`build(source)` at first use and loads the result with `ctypes`. The
library goes to `build/` beside the source's package (git-ignored).
Nothing here runs at import time: the CPU tests import the kernel modules
on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source path -> {"path": library, "log": what nvcc printed (the ptxas
# register/spill report; empty when an earlier build was reused)}
build_info: dict = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from their csrc/*.cu at first use on a "
                           "CUDA machine")
    return found


def build(source: Path) -> Path:
    """Compile `source` (a `csrc/*.cu` file) and return the library's path.
    Concurrent builds each write a private temporary file and rename it
    into place."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    build_dir = source.parent.parent / "build"
    out = build_dir / f"lib{source.stem}-{tag}.so"
    if out.exists():
        build_info.setdefault(str(source), {"path": out, "log": ""})
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    build_info[str(source)] = {"path": out,
                               "log": proc.stdout + proc.stderr}
    return out
