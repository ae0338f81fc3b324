#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's point-cloud path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``).  It imports no JAX.  Phases, each of which raises on
failure (exit code != 0):

1. environment: a CUDA device, the card's name and power limit
   (``nvidia-smi``), the pipeline built on it with TF32 off;
2. build: ``nvcc`` compiles the OS-CFAR kernel from ``csrc/`` (timed);
3. kernel: the CUDA kernel's mask equals its plain PyTorch version's, bit for
   bit, on quantized exponential maps (ties forced) at B in {1, 7, 1024} of
   63x70, at the flagship CFAR geometry and a second one, and on maps of
   other sizes (one window exactly, smaller than a window, larger, and the
   largest map of a shipped config, 256x192);
4. slice: ``make_inputs(cfg, 32, seed=7)`` (seeded simulated frames, numpy
   only) through the pipeline on the GPU and on the CPU (the plain path that
   the tests hold to the JAX package); the outputs are finite and of the
   expected shapes, ``count`` and ``valid`` are identical and ``points``
   agree within ``POINTS_ATOL`` (a stricter bar than the ``pointcloud_f32``
   gates of the JAX package's ``utils/verify.py``), and the kernel's launch
   count advanced during the GPU run;
5. throughput at batch 1024 (``bench.py``'s inputs: standard normal planes,
   seed 0), timed with CUDA events after warm-up; the CFAR kernel and its
   plain version timed at [1024, 63, 70], in turns.

Prints JSON lines, then the card's ``nvidia-smi`` line, the kernels line,
and last ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(HERE, "configs", "6843_RadVel_ods_20Hz.cfg")
CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
SECOND_CFAR_PARAMS = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
AZ_IDXS, EL_IDXS = (0, 3, 4, 7), (9, 8, 5, 4)
KERNEL_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/os_cfar_detect.cu"
KERNEL_REPLACES = "mmwave_radar_processing_tpu/ops/pallas/os_cfar.py:135"
#: max |GPU - CPU| of the points: the bar the tests hold the CPU port to vs JAX
POINTS_ATOL = 1e-5


def emit(**fields):
    print(json.dumps(fields), flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def quantized_maps(batch, rows, cols, seed, device):
    """Exponential magnitudes rounded to 1/8: many exact ties across windows."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.exponential(1.0, (batch, rows, cols)) * 8) / 8
    return torch.from_numpy(x.astype(np.float32)).to(device)


def cuda_ms(fn, iters):
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(device):
    """Kernel vs plain version on the same CUDA tensors; returns max |error|."""
    from mmwave_radar_processing_tpu_torch.ops.cfar import (
        os_2d_detect, os_2d_detect_reference,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        os_cfar_2d_detect,
    )

    cases = [(p, (b, 63, 70)) for p in (CFAR_PARAMS, SECOND_CFAR_PARAMS)
             for b in (1, 7, 1024)]
    cases += [(CFAR_PARAMS, (3, 17, 15)),   # exactly one window
              (CFAR_PARAMS, (2, 10, 12)),   # smaller than a window: all False
              (SECOND_CFAR_PARAMS, (5, 64, 128)),
              (CFAR_PARAMS, (2, 256, 192))]  # 196 KB: above the 48 KB default
    max_err = 0
    for i, (params, shape) in enumerate(cases):
        x = quantized_maps(*shape, seed=i, device=device)
        before = os_cfar_2d_detect.launches
        got = os_2d_detect(x, **params)
        torch.cuda.synchronize()
        if os_cfar_2d_detect.launches != before + 1:
            raise RuntimeError(f"kernel launch not counted for {shape}")
        want = os_2d_detect_reference(x, **params)
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"kernel != plain version at {shape} {params}: "
                f"{int((got != want).sum())} cells differ")
        if shape[1:] == (63, 70) and not bool(want.any()):
            raise RuntimeError(f"no detections at {shape}: a vacuous check")
        emit(phase="kernel", shape=list(shape), cfar=params,
             detections=int(want.sum()), equal=True)
    return float(max_err)


def check_slice(cfg, gpu_pipeline, device):
    """Port on the GPU vs port on the CPU on simulated frames; returns launches."""
    from mmwave_radar_processing_tpu_torch import (
        PointCloudBatch, build_point_cloud_pipeline, make_inputs,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        os_cfar_2d_detect,
    )

    raw_re, raw_im, _ = make_inputs(cfg, 32, seed=7)
    re_gpu = torch.from_numpy(raw_re).to(device)
    im_gpu = torch.from_numpy(raw_im).to(device)
    torch.cuda.synchronize()

    os_cfar_2d_detect.launches = 0
    out_gpu = gpu_pipeline(re_gpu, im_gpu)
    torch.cuda.synchronize()
    launches = os_cfar_2d_detect.launches
    if launches < 1:
        raise RuntimeError("the main path never launched the OS-CFAR kernel")

    cpu_pipeline = build_point_cloud_pipeline(
        cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
        cfar_params=CFAR_PARAMS, max_dets=128, device="cpu")
    out_cpu = cpu_pipeline(torch.from_numpy(raw_re), torch.from_numpy(raw_im))

    expected = {"points": (32, 128, 4), "valid": (32, 128), "count": (32,)}
    for name, shape in expected.items():
        got = tuple(getattr(out_gpu, name).shape)
        if got != shape:
            raise RuntimeError(f"{name}: shape {got}, expected {shape}")
    if not bool(torch.isfinite(out_gpu.points).all()):
        raise RuntimeError("non-finite points on the GPU")
    if int(out_gpu.count.sum()) == 0:
        raise RuntimeError("no detections on the GPU: a vacuous check")
    gpu = PointCloudBatch(*(t.cpu() for t in out_gpu))
    same_frames = int(((gpu.count == out_cpu.count)
                       & (gpu.valid == out_cpu.valid).all(1)).sum())
    pts_err = float((gpu.points - out_cpu.points).abs().max())
    emit(phase="slice", batch=32, launches=launches,
         frames_identical_count_and_valid=same_frames,
         points_max_abs_diff=pts_err, points_atol=POINTS_ATOL,
         mean_count=float(gpu.count.float().mean()))
    if not (torch.equal(gpu.count, out_cpu.count)
            and torch.equal(gpu.valid, out_cpu.valid)):
        raise RuntimeError(f"GPU port differs from the CPU port in count or "
                           f"valid: {32 - same_frames} of 32 frames")
    if not pts_err <= POINTS_ATOL:
        raise RuntimeError(f"GPU points differ from the CPU port's by {pts_err}")
    return launches


def measure_throughput(cfg, gpu_pipeline, device, batch=1024, iters=20):
    rng = np.random.default_rng(0)
    shape = (batch, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw_re = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    raw_im = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    for _ in range(3):
        gpu_pipeline(raw_re, raw_im)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ms = cuda_ms(lambda: gpu_pipeline(raw_re, raw_im), iters)
    emit(phase="throughput", batch=batch, iters=iters, ms_per_batch=ms,
         frames_per_s=batch / (ms / 1e3),
         input_mb=2 * raw_re.numel() * 4 / 1e6,
         peak_mem_mb=torch.cuda.max_memory_allocated(device) / 1e6)


def time_cfar(device, batch=1024):
    """Kernel and plain version at [batch, 63, 70], in turns: plain, kernel, kernel, plain."""
    from mmwave_radar_processing_tpu_torch.ops.cfar import (
        os_2d_detect, os_2d_detect_reference,
    )

    x = quantized_maps(batch, 63, 70, seed=11, device=device)
    kernel = lambda: os_2d_detect(x, **CFAR_PARAMS)  # noqa: E731
    plain = lambda: os_2d_detect_reference(x, **CFAR_PARAMS)  # noqa: E731
    for fn in (kernel, plain):
        fn()
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_ms(kernel if name == "kernel" else plain, 50))
    res = {name: sum(t) / len(t) for name, t in times.items()}
    emit(phase="cfar_timing", shape=[batch, 63, 70], kernel_ms=res["kernel"],
         plain_ms=res["plain"], turns=times)
    return res["kernel"], res["plain"]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from mmwave_radar_processing_tpu_torch import build_point_cloud_pipeline, load_cfg
    from mmwave_radar_processing_tpu_torch.ops.kernels import _build

    device = torch.device("cuda", 0)
    card = gpu_name_and_power_limit()
    emit(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    cfg = load_cfg(FLAGSHIP_CFG, array_geometry="ods", array_direction="down")
    gpu_pipeline = build_point_cloud_pipeline(
        cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
        cfar_params=CFAR_PARAMS, max_dets=128, device=device)
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is on: the port runs full float32 only")

    t0 = time.perf_counter()
    lib = _build.build("os_cfar_detect")
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, library=os.path.relpath(lib, HERE),
         ptxas=[ln for ln in lib.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln])

    max_err = check_kernel(device)
    launches = check_slice(cfg, gpu_pipeline, device)
    measure_throughput(cfg, gpu_pipeline, device)
    kernel_ms, plain_ms = time_cfar(device)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "os_cfar_2d_detect", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
