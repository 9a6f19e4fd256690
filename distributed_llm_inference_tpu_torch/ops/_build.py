"""Build and load the port's CUDA kernels (no JAX counterpart: Pallas kernels
are traced by JAX itself).

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds. The shared library lands in a
directory ``build/`` beside the package, named by a hash of the source, of
every ``csrc/*.cuh`` header and of the flags, at first use; ``ctypes`` loads
it. Beside it the compiler's ``-Xptxas -v`` report (registers, shared
memory and spills of every kernel instance) is kept as ``.log``. Nothing
here runs at import time: the CPU tests import every module on a machine
with no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
KERNEL_SOURCES = (
    "flash_attention", "int4_matmul", "paged_attention", "quant_attention",
    "latent_attention", "ragged_attention", "sink_attention",
)
# --split-compile=4: the optimizer runs on up to 4 threads a source, so the
# sources that hold many kernel instances (the fused step's 24 a policy) do
# not set the build's length alone (chip_smoke.py prints it, `build_s`).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--split-compile=4", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels cannot be built here"
    )


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    # The report first, then the library (atomic: a concurrent process sees
    # all or nothing, and a library's report is there before it is).
    report = tmp.with_suffix(".logtmp")
    report.write_bytes(log)
    os.replace(report, out.with_suffix(".log"))
    os.replace(tmp, out)


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together. Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    paths: Dict[str, Path] = {}
    for name in names:
        src, out = _target(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        started.append((name, proc, tmp, out))
    for item in started:
        _finish(*item)
    return paths


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of ``csrc/<name>.cu``'s build (each kernel
    instance's registers, shared memory and spills), built first if its
    hash is not in the build directory yet."""
    return build_all([name])[name].with_suffix(".log").read_text(
        errors="replace")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if its hash is
    not in the build directory yet."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _libs[name] = lib
    return lib
