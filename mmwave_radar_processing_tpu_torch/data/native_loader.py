"""The NPY bulk loader of the port (JAX: ``data/native_loader.py``): split re/im batches into buffers the caller owns.

``native/npy_loader.cpp`` (the repository's C++ loader, read and never
written) is compiled with ``g++`` at first use into ``build/torch_native/``,
named by a hash of the source and the flags, and loaded with ``ctypes``.  A
build goes to a private name and is renamed into place, so processes that
build at once never load a half-written library.  A failed build raises with
the compiler's output: nothing falls back quietly.

:func:`load_frames_split` fills float32 tensors ``(re, im)`` through their
``data_ptr()``; ``ctypes`` releases the interpreter lock during the call, so
a loading thread runs beside Python.  ``backend="numpy"`` is the loader's
plain version (``np.load`` frame by frame), bit-equal to the native one,
which the tests hold it to.

:class:`SplitFramePrefetcher` loads batch ``k + 1`` on a host thread while
the caller works on batch ``k``, into two reused slots (pinned host memory
when the batches go to a CUDA device).  A slot is refilled only after the
caller's :meth:`~SplitFramePrefetcher.release` event for the batch it held
has completed, i.e. after that batch's host-to-device copy.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "npy_loader.cpp"
BUILD_DIR = REPO_ROOT / "build" / "torch_native"
#: no ``-march=native``: the library is built on the machine that loads it,
#: but a build directory may be shared by hosts of another CPU
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BACKENDS = ("native", "numpy")
#: the dtypes the native parser reads (little-endian, C order)
_NPY_DESCRS = ("<c8", "<c16", "<f4", "<f8")


def library_path() -> Path:
    """Where the loader builds to: keyed on its source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libnpy_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/npy_loader.cpp`` unless its library is already built; raises on failure."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the NPY loader of "
                           f"mmwave_radar_processing_tpu_torch is compiled at first use "
                           f"({' '.join(cmd)})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the NPY loader:\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the native loader; one handle per process."""
    lib = ctypes.CDLL(str(build()))
    lib.mrp_npy_info.restype = ctypes.c_int
    lib.mrp_npy_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.mrp_load_frames_split.restype = ctypes.c_int
    lib.mrp_load_frames_split.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
    return lib


def npy_info(path: str) -> Tuple[Tuple[int, ...], int]:
    """``(shape, dtype code)`` of one NPY file from the native header parser.

    Codes: 1 complex64, 2 complex128, 3 float32, 4 float64.
    """
    shape = (ctypes.c_long * 8)()
    dtype = ctypes.c_int()
    ndim = load().mrp_npy_info(os.fsencode(path), shape, ctypes.byref(dtype))
    if ndim < 0:
        raise IOError(f"failed to parse NPY header: {path}")
    return tuple(shape[i] for i in range(ndim)), dtype.value


def _check_out(out, n: int, frame_shape: Tuple[int, ...]):
    want = (n, *frame_shape)
    for plane in out:
        if not (isinstance(plane, torch.Tensor) and plane.dtype == torch.float32
                and plane.device.type == "cpu" and plane.is_contiguous()
                and tuple(plane.shape) == want):
            raise ValueError(f"out must be two contiguous float32 CPU tensors of shape "
                             f"{want}")


def _load_numpy(paths: Sequence[str], frame_shape, re: torch.Tensor, im: torch.Tensor):
    """The plain version: ``np.load`` each frame; refuses what the native parser refuses."""
    re_np, im_np = re.numpy(), im.numpy()
    for i, path in enumerate(paths):
        try:
            arr = np.load(path, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise IOError(f"failed to load {path}: {e}") from e
        fortran = arr.ndim > 1 and arr.flags.f_contiguous and not arr.flags.c_contiguous
        if arr.dtype.str not in _NPY_DESCRS or fortran or arr.size != re_np[i].size:
            raise IOError(f"{path}: {arr.dtype.str} {arr.shape} is not a C-order "
                          f"frame of {frame_shape}")
        arr = arr.reshape(frame_shape)
        re_np[i] = np.real(arr)
        im_np[i] = np.imag(arr) if np.iscomplexobj(arr) else 0.0


def load_frames_split(
    paths: Sequence[str],
    frame_shape: Tuple[int, ...],
    nthreads: int = 8,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    backend: str = "native",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load NPY frames into split ``(re, im)`` float32 planes ``[len(paths), *frame_shape]``.

    Args:
        paths: NPY files, one frame each, each of ``prod(frame_shape)``
            complex64, complex128, float32 or float64 values (a real frame
            gives ``im = 0``).
        frame_shape: per-frame shape, e.g. ``(4, 63, 210)``.
        nthreads: the native loader's thread-pool size.
        out: the caller's contiguous float32 CPU tensors to fill (pinned
            memory works alike); new ones when ``None``.
        backend: ``"native"`` (the C++ loader) or ``"numpy"`` (its plain version).

    Raises ``IOError`` when a file is missing, malformed or of another size.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    n, frame_shape = len(paths), tuple(frame_shape)
    if out is None:
        out = tuple(torch.empty((n, *frame_shape), dtype=torch.float32) for _ in range(2))
    _check_out(out, n, frame_shape)
    re, im = out
    if backend == "numpy":
        _load_numpy(paths, frame_shape, re, im)
        return re, im
    lib = load()
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    loaded = lib.mrp_load_frames_split(blob, n, re.data_ptr(), im.data_ptr(),
                                       int(np.prod(frame_shape)), nthreads)
    if loaded != n:
        raise IOError(f"native loader loaded {loaded} of {n} frames "
                      f"(a file missing, malformed or not of {frame_shape})")
    return re, im


class SplitFramePrefetcher:
    """Double-buffered background loader of ``(re, im)`` batches, in order.

    While the caller works on batch ``k`` the next one loads on a host
    thread into the other of two reused slots.  Iteration yields views
    ``[b, *frame_shape]`` of a slot (the last batch may be shorter).  A view
    stays valid until the caller asks for the next batch, or, when the caller
    hands :meth:`release` an event (a CUDA event recorded behind the batch's
    copy to the device), until that event has completed: the loader waits on
    it before refilling the slot.

    ``pin_memory=True`` allocates the slots in pinned memory (it needs a
    CUDA device and raises without one).  :attr:`load_seconds` holds the
    loader's host seconds for each batch.
    """

    def __init__(self, paths: List[str], frame_shape, batch: int = 256, nthreads: int = 8,
                 *, pin_memory: bool = False, backend: str = "native"):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.paths = list(paths)
        self.frame_shape = tuple(frame_shape)
        self.batch = batch
        self.nthreads = nthreads
        self.pin_memory = pin_memory
        self.backend = backend
        self.load_seconds: List[float] = []
        self._release: List[Optional[object]] = [None, None]
        self._current = None

    def release(self, event) -> None:
        """The last batch yielded may be overwritten once ``event`` (``.synchronize()``) has completed."""
        if self._current is None:
            raise RuntimeError("release() before a batch was yielded")
        self._release[self._current] = event

    def _fill(self, chunk, slot) -> Tuple[torch.Tensor, torch.Tensor]:
        pending = self._release[slot]
        if pending is not None:
            pending.synchronize()  # the slot's last batch has reached the device
            self._release[slot] = None
        t0 = time.perf_counter()
        re, im = (plane[:len(chunk)] for plane in self._slots[slot])
        load_frames_split(chunk, self.frame_shape, self.nthreads, out=(re, im),
                          backend=self.backend)
        self.load_seconds.append(time.perf_counter() - t0)
        return re, im

    def __iter__(self):
        chunks = [self.paths[i:i + self.batch] for i in range(0, len(self.paths), self.batch)]
        if not chunks:
            return
        rows = min(self.batch, len(self.paths))
        self._slots = [tuple(torch.empty((rows, *self.frame_shape), dtype=torch.float32,
                                         pin_memory=self.pin_memory) for _ in range(2))
                       for _ in range(min(2, len(chunks)))]
        self._release = [None, None]
        self.load_seconds = []
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._fill, chunks[0], 0)
            for k in range(len(chunks)):
                current = future.result()
                if k + 1 < len(chunks):
                    # the slot of batch k - 1, released when the caller asked for batch k
                    future = pool.submit(self._fill, chunks[k + 1], (k + 1) % 2)
                self._current = k % 2
                yield current
