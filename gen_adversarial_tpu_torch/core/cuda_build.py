"""Build the port's CUDA sources into plain-C shared libraries with `nvcc`
and load them with ctypes.

Every source under `csrc/` exposes `extern "C"` launchers that take raw
pointers, sizes and a stream; nothing includes PyTorch's headers, so a build
takes seconds. A library is built at first use, from the sources in the
package only, into `_build/` beside the package (listed in `.gitignore`),
under a name that hashes the source and the flags: an edited source builds
anew, an unchanged one is loaded as it is. Several sources build in parallel,
one `nvcc` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """One loaded library and how it was built."""
    lib: ctypes.CDLL
    seconds: float  # nvcc wall time; 0.0 when an earlier build was loaded
    log: str        # nvcc's stderr (ptxas -v resource usage); "" when loaded


_loaded: dict[str, Built] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def _start(nvcc: str, source: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(out), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(*names: str) -> dict[str, Built]:
    """Build (if needed) and load `csrc/<name>.cu` for each name; the builds
    that are needed run in parallel. Raises RuntimeError with nvcc's output
    if a build fails."""
    with _lock:
        todo = {}
        for name in names:
            if name in _loaded:
                continue
            source = CSRC_DIR / f"{name}.cu"
            target = _target(source)
            if target.is_file():
                _loaded[name] = Built(ctypes.CDLL(str(target)), 0.0, "")
            else:
                todo[name] = (source, target)
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            jobs = {}
            for name, (source, target) in todo.items():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                jobs[name] = (_start(nvcc, source, Path(tmp)), Path(tmp), target)
            failures = []
            for name, (proc, tmp, target) in jobs.items():
                out, err = proc.communicate()
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failures.append(f"nvcc failed on csrc/{name}.cu "
                                    f"(exit {proc.returncode}):\n{out}{err}")
                    continue
                os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
                _loaded[name] = Built(ctypes.CDLL(str(target)), seconds, out + err)
            if failures:
                raise RuntimeError("\n".join(failures))
        return {name: _loaded[name] for name in names}


_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spill bytes from `-Xptxas -v`
    (the largest values over the kernels in the log)."""
    regs = smem = spill = 0
    for line in log.splitlines():
        if m := _PTXAS_REGS.search(line):
            regs = max(regs, int(m.group(1)))
            if s := _PTXAS_SMEM.search(line):
                smem = max(smem, int(s.group(1)))
        if m := _PTXAS_SPILL.search(line):
            spill = max(spill, int(m.group(1)) + int(m.group(2)))
    return {"registers": regs, "smem_bytes": smem, "spill_bytes": spill}
