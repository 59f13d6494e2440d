"""Build and load the port's hand-written CUDA kernels.

Each source in ``ngp_tpu_torch/csrc/`` exports a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries land in ``build/ngp_tpu_torch/`` at the repository
root (git-ignored), named by a hash of the source and the flags, so an
unchanged source is compiled once per checkout. Nothing is built when a
module is imported: :meth:`CudaKernel.library` builds at first use, and
:func:`build_all` builds every registered source in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ngp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

KERNELS: list["CudaKernel"] = []


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


class CudaKernel:
    """One CUDA source, its C functions' ctypes signatures, and a count of
    launches per kernel entry point (``launches[name]``) that the Python
    wrappers keep: each adds one where it launches its kernel, nowhere
    else."""

    def __init__(self, source: str, signatures: dict, entries: tuple):
        self.source = CSRC / source
        self.signatures = signatures  # name -> (restype, [argtypes])
        self.launches = dict.fromkeys(entries, 0)
        self._lib = None
        KERNELS.append(self)

    @property
    def name(self) -> str:
        return self.source.stem

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists;
        returns the running process (or None) and the output path."""
        out = self.lib_path()
        if out.exists():
            return None, out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        proc.tmp_path = tmp
        return proc, out

    @staticmethod
    def finish_build(proc, out: Path) -> str:
        """Wait for ``proc``; move its library into place; return the
        compiler's log (``-Xptxas=-v`` register and spill counts)."""
        if proc is None:
            return ""
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        os.replace(proc.tmp_path, out)
        out.with_suffix(".log").write_text(log)
        return log

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            proc, out = self.start_build()
            self.finish_build(proc, out)
            lib = ctypes.CDLL(str(out))
            for fn, (restype, argtypes) in self.signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            self._lib = lib
        return self._lib


KERNEL_MODULES = ("ngp_tpu_torch.ops.hashgrid", "ngp_tpu_torch.ops.segsum")


def _register_all():
    for mod in KERNEL_MODULES:
        importlib.import_module(mod)  # registers its CudaKernel


def reset_launches():
    """Set every kernel entry point's launch count to 0."""
    _register_all()
    for k in KERNELS:
        k.launches = dict.fromkeys(k.launches, 0)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel entry point since the last reset."""
    _register_all()
    return {name: n for k in KERNELS for name, n in k.launches.items()}


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one ``nvcc`` each, all started
    together) and load them; returns each compiler log."""
    _register_all()
    started = [(k, *k.start_build()) for k in KERNELS]
    logs = {k.name: CudaKernel.finish_build(p, out) for k, p, out in started}
    for k in KERNELS:
        k.library()
    return logs
