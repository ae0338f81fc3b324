"""Build the port's CUDA sources with ``nvcc`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point, so it compiles in seconds
without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I <generated headers> -o <name>-<hash>.so csrc/<name>.cu

The library lands in ``build/torch_kernels/`` at the repository root, named
by a hash of the source, the headers it may include (``csrc/*.cuh`` and the
generated ones) and the flags, so an edited source rebuilds and an unchanged
one is reused.  The compiler's output (``-Xptxas -v``: registers, shared
memory, spills) is kept beside it as ``<name>-<hash>.log``.  A header that is
generated (:data:`GENERATED_HEADERS`: the sorting networks of the
k-th-smallest kernel) is written beside the library before the compiler runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from mmwave_radar_processing_tpu_torch.ops.kernels import sorting_network
from mmwave_radar_processing_tpu_torch.utils.logger import get_logger
from mmwave_radar_processing_tpu_torch.utils.profiling import setup_span

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source name -> {header file name: function that returns its text}
GENERATED_HEADERS = {
    "os_rank_select": {sorting_network.HEADER_NAME: sorting_network.header},
}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        f"nvcc not found on PATH or at {candidate}: the CUDA kernels of "
        "mmwave_radar_processing_tpu_torch are compiled at first use and need "
        "the CUDA toolkit (set CUDA_HOME to its root)")


def generated_headers(name: str) -> dict:
    """``{file name: text}`` of the headers generated for ``csrc/<name>.cu``."""
    return {file: make() for file, make in GENERATED_HEADERS.get(name, {}).items()}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on its source, its headers and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    for file, text in sorted(generated_headers(name).items()):
        digest.update(file.encode() + text.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent builders never see a
    # half-written library
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    include = []
    headers = generated_headers(name)
    if headers:
        # keyed like the library: concurrent builds write the same text
        include_dir = lib.with_suffix(".include")
        include_dir.mkdir(exist_ok=True)
        for file, text in headers.items():
            (include_dir / file).write_text(text)
        include = ["-I", str(include_dir)]
    cmd = [find_nvcc(), *NVCC_FLAGS, *include, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    with setup_span(f"nvcc.{name}"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    get_logger(__name__).info("built %s with nvcc in %.2f s", lib.name,
                              time.perf_counter() - t0)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with setup_span(f"kernel.{name}"):
        return ctypes.CDLL(str(build(name)))
