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
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

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


def kernel_name(symbol: str) -> str:
    """`flash_fwd_bf16_kernel<256>` from a mangled kernel name: the last
    component of its nested name, with its template arguments when they
    are integer or bool literals or `float`; a symbol of another form is
    returned unchanged."""
    if not symbol.startswith("_ZN"):
        return symbol
    i, name = 3, ""
    while (m := re.match(r"\d+", symbol[i:])):
        i += len(m.group())
        name, i = symbol[i:i + int(m.group())], i + int(m.group())
    if symbol[i:i + 1] == "E":
        return name
    args = re.match(r"I((?:L[a-z]\d+E|f)+)E", symbol[i:])
    if not args:
        return symbol
    return name + "<" + ", ".join(
        v or "float" for v in re.findall(r"L[a-z](\d+)E|f",
                                         args.group(1))) + ">"


def ptxas_report(log: str) -> tuple[list[str], bool, bool]:
    """From what nvcc printed: ptxas's register, spill, warning and
    performance lines, each as "<kernel>: <line>"; whether any kernel
    spills; whether ptxas serialised any kernel's wgmma (C7520, a wgmma
    issue or wait in a divergent path)."""
    lines, spilled, fn = [], False, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif re.search(r"spill|registers|arning|Performance|ignored|C75\d\d",
                       line):
            lines.append(f"{fn}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spilled = spilled or bool(m and (int(m.group(1))
                                             or int(m.group(2))))
    serialized = any("C7520" in x or "serialized" in x for x in lines)
    return lines, spilled, serialized


class Sass(NamedTuple):
    """Instruction counts of one kernel's SASS."""
    hgmma: int          # warpgroup tensor-core products (wgmma)
    hmma: int           # warp tensor-core products (mma.sync)
    local: int          # local-memory loads and stores (LDL/STL)


def sass_counts(lib: Path) -> dict:
    """{kernel: Sass} in the SASS of a built library (`cuobjdump -sass`)."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = [0, 0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
            counts[fn][2] += bool(re.search(r"\b(LDL|STL)\b", line))
    return {fn: Sass(*c) for fn, c in counts.items()}
