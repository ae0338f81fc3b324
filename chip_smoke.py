#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's point-cloud, velocity, combined and beamforming paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``).  It imports no JAX.  Phases, each of which raises on
failure (exit code != 0):

1. environment: a CUDA device, the card's name and power limit
   (``nvidia-smi``), the pipelines built on it with TF32 off;
2. build: ``nvcc`` compiles every kernel source in ``csrc/``, one process
   each, started together (timed; ptxas registers and spills printed);
3. CFAR kernel: its mask equals its plain PyTorch version's, bit for bit, on
   quantized exponential maps (ties forced) at B in {1, 7, 1024} of 63x70,
   at the flagship CFAR geometry and a second one, and on maps of other
   sizes (one window exactly, smaller than a window, larger, and the largest
   map of a shipped config, 256x192);
4. response kernel: the Doppler-azimuth responses equal their plain version,
   bit for bit, at B in {1, 7, 1024} of [12, 19*70] with 60 angle bins, at
   the zoom width nv = 140, at an odd small shape, in the paired (group)
   layout, and the paired layout equals the unpaired one;
5. point-cloud slice: ``make_inputs(cfg, 32, seed=7)`` (seeded simulated
   frames, numpy only) through the pipeline on the GPU and on the CPU (the
   plain path that the tests hold to the JAX package): ``count`` and
   ``valid`` identical, ``points`` within ``POINTS_ATOL``;
6. velocity slice, coarse and precise: the same frames and altitudes on the
   GPU and on the CPU with the same RANSAC draws (made on the CPU from a
   seeded generator): ``vx`` within ``VX_ATOL`` on every frame, ``velocity``
   within 1e-4 and R^2 and inlier fractions within 1e-3 on at least 31 of
   32 frames (a borderline peak may flip between cuBLAS and the CPU);
7. combined slice: both halves to the bars of phases 5 and 6;
8. beamforming kernels: the Capon and Bartlett kernels against their plain
   versions on the same CUDA tensors (rtol ``BEAMFORM_RTOL``; Bartlett also
   atol 1e-4 times the map's maximum, and also against the snapshot form
   ``mean_k |a^H x_k|^2``) at [B, 4, 63, 70] with 64 angles for B in
   {1, 7, 1024}, at A = 12 (the processors' aperture), A = 7 with the
   2048-angle azimuth-elevation grid, A = 16 and an odd small shape;
9. beamforming slice: the same 32 frames through ``build_capon_pipeline``
   (``capon`` and ``bartlett``) on the GPU and on the CPU port, then both
   processors on 3 frames (the 12-antenna and the 4-antenna heatmap, and
   the azimuth-elevation heatmap at each frame's strongest range gate),
   each within rtol ``MAP_RTOL`` and atol 1e-4 times the map's maximum;
10. throughput at batch 1024 (``bench.py``'s inputs: standard normal planes,
   seed 0, altitude 1.2) of the point-cloud, velocity, combined, capon and
   bartlett paths, timed with CUDA events after warm-up, with peak device
   memory, and the beamforming paths' range DFT alone;
11. each kernel and its plain version timed at the main path's shapes, in
   turns (plain, kernel, kernel, plain).

Each path is run on the GPU with the launch counts set to 0 just before and
read just after; a path that never launched its kernels fails.  Prints JSON
lines, then the card's ``nvidia-smi`` line, the kernels line, and last
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(HERE, "configs", "6843_RadVel_ods_20Hz.cfg")
CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
SECOND_CFAR_PARAMS = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
AZ_IDXS, EL_IDXS = (0, 3, 4, 7), (9, 8, 5, 4)
KERNEL_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/os_cfar_detect.cu"
KERNEL_REPLACES = "mmwave_radar_processing_tpu/ops/pallas/os_cfar.py:135"
RESP_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/doppler_az_responses.cu"
RESP_REPLACES = {
    "set_responses_pallas_batch": "mmwave_radar_processing_tpu/ops/pallas/doppler_az.py:88",
    "set_responses_pallas": "mmwave_radar_processing_tpu/ops/pallas/doppler_az.py:149",
    "group_responses_pallas_batch":
        "mmwave_radar_processing_tpu/ops/pallas/doppler_az.py:224",
}
BEAMFORM_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/beamform_power.cu"
BEAMFORM_REPLACES = {
    "capon_power_pallas": "mmwave_radar_processing_tpu/ops/pallas/capon.py:129",
    "bartlett_power_pallas_cov": "mmwave_radar_processing_tpu/ops/pallas/capon.py:208",
    "bartlett_power": "mmwave_radar_processing_tpu/ops/pallas/beamform.py:50",
}
#: beamforming kernel vs its plain version: the JAX package's kernel-vs-oracle
#: bar (tests/test_beamform.py:380,426); Bartlett's covariance form cancels at
#: deep nulls, so it also gets an atol of 1e-4 times the map's maximum
BEAMFORM_RTOL = 5e-5
#: beamforming maps, GPU vs CPU port: the bar the tests hold the CPU port to
#: vs JAX (rtol, and atol 1e-4 times the map's maximum)
MAP_RTOL = 1e-4
LOADING = 1e-2
SETS = ((0, 3, 4, 7), (1, 2, 5, 6), (10, 11, 6, 7), (9, 8, 5, 4))
#: max |GPU - CPU| of the points: the bar the tests hold the CPU port to vs JAX
POINTS_ATOL = 1e-5
#: velocity bars (GPU vs CPU port): those the tests hold the CPU port to vs JAX
VX_ATOL, VELOCITY_ATOL, STATS_ATOL = 1e-5, 1e-4, 1e-3
MIN_AGREEING_FRAMES = 31
RANSAC_SEED = 0


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


def response_inputs(batch, n_ch, win_rows, nv, fct, fst, seed, device):
    """Standard normal spectra and a range-window mask divided by its sum."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((2, batch, n_ch, win_rows * nv)).astype(np.float32)
    mask = (rng.random((batch, win_rows)) < 0.7).astype(np.float32)
    wgt = mask / np.maximum(mask.sum(1, keepdims=True), 1.0)
    arrays = [torch.from_numpy(a).to(device) for a in (u[0], u[1], wgt)]
    return (*arrays, fct, fst)


def paired_inputs(args, win_rows, nv):
    """The paired (group) layout of ``args``: [B, 8, W*2nv], factors [Av, 8]."""
    u_re, u_im, wgt, fct, fst = args
    b = u_re.shape[0]
    idx = torch.tensor(SETS, device=u_re.device)

    def pair(u):
        g = u.view(b, -1, win_rows, nv)[:, idx].reshape(b, 2, 2, 4, win_rows, nv)
        return g.permute(0, 1, 3, 4, 2, 5).reshape(b, 8, win_rows * 2 * nv).contiguous()

    cols = [0, 1, 2, 3, 8, 9, 10, 11]
    return (pair(u_re), pair(u_im), wgt, fct[:, cols].contiguous(),
            fst[:, cols].contiguous())


def check_responses(vel_pipeline, device):
    """Response kernel vs plain version on the same CUDA tensors, bit for bit.

    Returns the max |kernel - plain| of the unpaired flagship shapes, the zoom
    width and the paired layout.
    """
    from mmwave_radar_processing_tpu_torch.ops import doppler_az
    from mmwave_radar_processing_tpu_torch.ops.kernels.doppler_az import (
        doppler_az_responses,
    )

    fct, fst = vel_pipeline.fct, vel_pipeline.fst  # [60, 16]: the flagship's factors
    gen = torch.Generator().manual_seed(1)
    odd_f = [torch.randn(9, 16, generator=gen).to(device) for _ in "cs"]
    w = vel_pipeline.win_rows
    cases = [("flagship", (1, 12, w, 70), fct, fst),
             ("flagship", (7, 12, w, 70), fct, fst),
             ("flagship", (1024, 12, w, 70), fct, fst),
             ("zoom", (32, 12, w, 140), fct, fst),
             ("odd", (3, 12, 5, 16), *odd_f)]
    errs = {"flagship": 0.0, "zoom": 0.0, "odd": 0.0, "group": 0.0}
    for i, (kind, (b, c, rows, nv), fc, fs) in enumerate(cases):
        args = response_inputs(b, c, rows, nv, fc, fs, seed=20 + i, device=device)
        before = doppler_az_responses.launches
        got = doppler_az.set_responses(*args, set_idx=SETS, nv=nv)
        torch.cuda.synchronize()
        if doppler_az_responses.launches != before + 1:
            raise RuntimeError(f"response kernel launch not counted at {(b, c, rows, nv)}")
        want = doppler_az.set_responses_reference(*args, set_idx=SETS, nv=nv)
        err = float((got - want).abs().max())
        errs[kind] = max(errs[kind], err)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"response kernel != plain version at {(b, c, rows * nv)}: "
                f"{int((got != want).sum())} values differ, max |diff| {err}")
        if not bool((want > 0).any()):
            raise RuntimeError(f"all-zero responses at {(b, c, rows * nv)}: vacuous")
        emit(phase="response_kernel", shape=[b, c, rows * nv], nv=nv,
             n_angles=fc.shape[0], equal=True)

        if kind == "flagship" and b == 7:  # the paired layout of the same spectra
            paired = paired_inputs(args, rows, nv)
            before = doppler_az_responses.launches
            grouped = doppler_az.group_responses(*paired, n_groups=2, n_rx=4,
                                                 nv2=2 * nv)
            torch.cuda.synchronize()
            if doppler_az_responses.launches != before + 1:
                raise RuntimeError("group response launch not counted")
            plain = doppler_az.set_responses_reference(
                *paired, set_idx=doppler_az.group_set_idx(2, 4), nv=2 * nv)
            errs["group"] = float((grouped - plain).abs().max())
            sets = torch.stack([grouped[:, 0, :, :nv], grouped[:, 0, :, nv:],
                                grouped[:, 1, :, :nv], grouped[:, 1, :, nv:]], dim=1)
            if not (torch.equal(grouped, plain) and torch.equal(sets, got)):
                raise RuntimeError("paired layout differs from its plain version "
                                   "or from the unpaired layout")
            emit(phase="response_kernel", shape=list(paired[0].shape), nv=2 * nv,
                 layout="paired", equal=True, equal_to_unpaired=True)
    return errs


def velocity_agreement(gpu, cpu):
    """Per-frame agreement of two VelocityBatch results; raises on a vx miss."""
    vx_err = (gpu.vx - cpu.vx).abs()
    ok = (gpu.velocity - cpu.velocity).abs().amax(dim=1) <= VELOCITY_ATOL
    for name in ("az_r2", "el_r2", "az_inlier", "el_inlier"):
        ok &= (getattr(gpu, name) - getattr(cpu, name)).abs() <= STATS_ATOL
    agreeing = int(ok.sum())
    if not float(vx_err.max()) <= VX_ATOL:
        raise RuntimeError(f"vx differs between GPU and CPU by {float(vx_err.max())}")
    if agreeing < MIN_AGREEING_FRAMES:
        raise RuntimeError(f"only {agreeing} of {ok.numel()} frames agree "
                           f"(need {MIN_AGREEING_FRAMES})")
    if not (bool(gpu.vx.any()) and (bool(gpu.az_r2.any()) or bool(gpu.el_r2.any()))):
        raise RuntimeError("vx or both R^2 are zero on every frame: a vacuous check")
    for t in gpu:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite velocity outputs on the GPU")
    return {"frames_agreeing": agreeing, "vx_max_abs_diff": float(vx_err.max()),
            "velocity_max_abs_diff": float((gpu.velocity - cpu.velocity).abs().max())}


def check_velocity(cfg, device, frames):
    """Velocity pipeline on the GPU vs the CPU port, coarse and precise.

    Returns the response kernel's launches in each mode's GPU run.
    """
    from mmwave_radar_processing_tpu_torch import VelocityBatch, build_velocity_pipeline
    from mmwave_radar_processing_tpu_torch.ops.kernels.doppler_az import (
        doppler_az_responses,
    )

    cpu_in = [torch.from_numpy(a) for a in frames]
    gpu_in = [t.to(device) for t in cpu_in]
    launches = {}
    for mode, precise in (("coarse", False), ("precise", True)):
        cpu = build_velocity_pipeline(cfg, enable_precise=precise, device="cpu")
        gpu = build_velocity_pipeline(cfg, enable_precise=precise, device=device)
        gumbel = cpu.draw_gumbel(len(frames[0]),
                                 torch.Generator().manual_seed(RANSAC_SEED))
        g_gpu = gumbel.to(device)
        torch.cuda.synchronize()
        doppler_az_responses.launches = 0
        out_gpu = gpu(*gpu_in, gumbel=g_gpu)
        torch.cuda.synchronize()
        launches[mode] = doppler_az_responses.launches
        if launches[mode] < 1:
            raise RuntimeError(f"the {mode} velocity path never launched the "
                               "response kernel")
        out_cpu = cpu(*cpu_in, gumbel=gumbel)
        out_gpu = VelocityBatch(*(t.cpu() for t in out_gpu))
        if tuple(out_gpu.velocity.shape) != (len(frames[0]), 3):
            raise RuntimeError(f"velocity: shape {tuple(out_gpu.velocity.shape)}")
        emit(phase="velocity_slice", mode=mode, batch=len(frames[0]),
             launches=launches[mode], **velocity_agreement(out_gpu, out_cpu),
             vx_nonzero=int((out_gpu.vx != 0).sum()),
             az_r2_nonzero=int((out_gpu.az_r2 != 0).sum()),
             el_r2_nonzero=int((out_gpu.el_r2 != 0).sum()))
    return launches


def check_combined(cfg, device, frames):
    """Combined pipeline on the GPU vs the CPU port; returns (CFAR, response) launches."""
    from mmwave_radar_processing_tpu_torch import (
        PointCloudBatch, VelocityBatch, build_full_pipeline,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels.doppler_az import (
        doppler_az_responses,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        os_cfar_2d_detect,
    )

    kw = dict(az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
              cfar_params=CFAR_PARAMS, max_dets=128)
    cpu = build_full_pipeline(cfg, device="cpu", **kw)
    gpu = build_full_pipeline(cfg, device=device, **kw)
    gumbel = cpu.velocity.draw_gumbel(len(frames[0]),
                                      torch.Generator().manual_seed(RANSAC_SEED))
    cpu_in = [torch.from_numpy(a) for a in frames]
    gpu_in = [t.to(device) for t in cpu_in]
    g_gpu = gumbel.to(device)
    torch.cuda.synchronize()
    os_cfar_2d_detect.launches = doppler_az_responses.launches = 0
    pc_gpu, vel_gpu = gpu(*gpu_in, gumbel=g_gpu)
    torch.cuda.synchronize()
    launches = (os_cfar_2d_detect.launches, doppler_az_responses.launches)
    if min(launches) < 1:
        raise RuntimeError(f"the combined path missed a kernel: launches {launches}")
    pc_cpu, vel_cpu = cpu(*cpu_in, gumbel=gumbel)
    pc_gpu = PointCloudBatch(*(t.cpu() for t in pc_gpu))
    vel_gpu = VelocityBatch(*(t.cpu() for t in vel_gpu))
    if not (torch.equal(pc_gpu.count, pc_cpu.count)
            and torch.equal(pc_gpu.valid, pc_cpu.valid)):
        raise RuntimeError("combined: point-cloud count or valid differ from the CPU")
    pts_err = float((pc_gpu.points - pc_cpu.points).abs().max())
    if not pts_err <= POINTS_ATOL or int(pc_gpu.count.sum()) == 0:
        raise RuntimeError(f"combined: points differ by {pts_err} "
                           f"(count sum {int(pc_gpu.count.sum())})")
    emit(phase="combined_slice", batch=len(frames[0]), cfar_launches=launches[0],
         response_launches=launches[1], points_max_abs_diff=pts_err,
         **velocity_agreement(vel_gpu, vel_cpu))
    return launches


def beamform_inputs(b, a, w, k, m, seed, device):
    """Standard normal complex64 snapshots ``[b, a, w, k]`` and an ``(a, m)`` ULA steering."""
    from mmwave_radar_processing_tpu_torch.ops import beamform

    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((2, b, a, w, k)).astype(np.float32)
    x = torch.complex(torch.from_numpy(planes[0]), torch.from_numpy(planes[1]))
    steer = beamform.steering_ula(np.linspace(-np.pi, np.pi, m, endpoint=False), a)
    return x.to(device), steer.to(device)


def maps_agree(got, want, rtol, atol_of_max, what):
    """Raise unless ``|got - want| <= rtol*|want| + atol_of_max*max|want|``; returns max |diff|."""
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: non-finite values")
    diff = (got - want).abs()
    bound = rtol * want.abs() + atol_of_max * float(want.abs().max())
    if not bool((diff <= bound).all()):
        raise RuntimeError(f"{what}: {int((diff > bound).sum())} values outside rtol "
                           f"{rtol} / atol {atol_of_max}*max, max |diff| {float(diff.max())}")
    return float(diff.max())


def check_beamform(device):
    """Capon and Bartlett kernels vs their plain versions on the same CUDA tensors.

    Returns the max |kernel - plain| of each TPU kernel's entry: Capon and
    Bartlett (covariance form) at the flagship shapes, and Bartlett against
    the snapshot form at the processors' shapes (A = 12, the az-el grid).
    """
    from mmwave_radar_processing_tpu_torch.ops import beamform
    from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as bkernel

    cases = [("flagship", (1, 4, 63, 70, 64)), ("flagship", (7, 4, 63, 70, 64)),
             ("flagship", (1024, 4, 63, 70, 64)), ("processor", (3, 12, 63, 70, 64)),
             ("processor", (3, 7, 1, 70, 2048)), ("a16", (3, 16, 5, 50, 64)),
             ("odd", (2, 5, 3, 33, 31))]
    errs = {name: 0.0 for name in BEAMFORM_REPLACES}
    for i, (kind, shape) in enumerate(cases):
        x, steer = beamform_inputs(*shape, seed=40 + i, device=device)
        for name, launch in (("capon", bkernel.capon_power),
                             ("bartlett", bkernel.bartlett_power)):
            before = launch.launches
            if name == "capon":
                got = beamform.capon_power(x, steer, loading=LOADING)
            else:
                got = beamform.bartlett_power(x, steer)
            torch.cuda.synchronize()
            if launch.launches != before + 1:
                raise RuntimeError(f"{name} kernel launch not counted at {shape}")
            if name == "capon":
                want = beamform.capon_power_reference(x, steer, loading=LOADING)
                err = maps_agree(got, want, BEAMFORM_RTOL, 0.0, f"capon kernel {shape}")
                if kind == "flagship":
                    errs["capon_power_pallas"] = max(errs["capon_power_pallas"], err)
                fields = {}
            else:
                want = beamform.bartlett_power_reference(x, steer)
                err = maps_agree(got, want, BEAMFORM_RTOL, 1e-4, f"bartlett kernel {shape}")
                snap = beamform.bartlett_from_snapshots(x.movedim(1, 2), steer)
                snap_err = maps_agree(got, snap, BEAMFORM_RTOL, 1e-4,
                                      f"bartlett kernel vs snapshot form {shape}")
                if kind == "flagship":
                    errs["bartlett_power_pallas_cov"] = max(
                        errs["bartlett_power_pallas_cov"], err)
                if kind == "processor":
                    errs["bartlett_power"] = max(errs["bartlett_power"], snap_err)
                fields = {"snapshot_form_max_abs_err": snap_err}
            emit(phase="beamform_kernel", kernel=name, shape=list(shape[:4]),
                 n_angles=shape[4], max_abs_err=err,
                 max_rel_err=float(((got - want).abs() / want.abs()).max()),
                 rtol=BEAMFORM_RTOL, **fields)
    return errs


def check_beamform_slice(cfg, device, frames):
    """Beamforming pipelines and processors on the GPU vs the CPU port.

    Returns each run's launches: ``capon`` and ``bartlett`` (pipelines at
    batch 32), ``capon_processor`` and ``bartlett_processor`` (3 frames).
    """
    from mmwave_radar_processing_tpu_torch import (
        BartlettBeamformerProcessor, CaponBeamformerProcessor, build_capon_pipeline,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as bkernel
    from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

    cpu_in = [torch.from_numpy(a) for a in frames[:2]]
    gpu_in = [t.to(device) for t in cpu_in]
    kernels = {"capon": bkernel.capon_power, "bartlett": bkernel.bartlett_power}
    launches = {}
    for method, launch in kernels.items():
        gpu = build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method=method,
                                   loading=LOADING, device=device)
        torch.cuda.synchronize()
        launch.launches = 0
        out = gpu(*gpu_in)
        torch.cuda.synchronize()
        launches[method] = launch.launches
        if launches[method] < 1:
            raise RuntimeError(f"the {method} path never launched its kernel")
        cpu = build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method=method,
                                   loading=LOADING, device="cpu")
        want = cpu(*cpu_in)
        err = maps_agree(out.cpu(), want, MAP_RTOL, 1e-4, f"{method} pipeline")
        emit(phase="beamform_slice", path=method, batch=len(frames[0]),
             launches=launches[method], max_abs_diff=err,
             max_rel_diff=float(((out.cpu() - want).abs() / want.abs()).max()),
             map_max=float(want.max()))

    virt = reformat(torch.complex(*cpu_in)[:3], num_rx=cfg.num_rx_antennas,
                    cfgs_per_loop=cfg.chirp_cfgs_per_loop)  # [3, 12, 63, 70]
    virt_gpu = virt.to(device)
    for cls in (CaponBeamformerProcessor, BartlettBeamformerProcessor):
        launch = kernels[cls._method]
        procs = [(cls(cfg, device=device), cls(cfg, device="cpu")),
                 (cls(cfg, antenna_idxs=AZ_IDXS, device=device),
                  cls(cfg, antenna_idxs=AZ_IDXS, device="cpu"))]
        wants = [[cpu.process(frame) for _, cpu in procs] for frame in virt]
        gates = [int(w[0].amax(dim=1).argmax()) for w in wants]
        torch.cuda.synchronize()
        launch.launches = 0
        outs = [[gpu.process(virt_gpu[i]) for gpu, _ in procs]
                + [procs[0][0].azimuth_elevation_heatmap(virt_gpu[i], gates[i])]
                for i in range(len(virt))]
        torch.cuda.synchronize()
        key = f"{cls._method}_processor"
        launches[key] = launch.launches
        if launches[key] != 3 * len(virt):
            raise RuntimeError(f"{key}: {launches[key]} launches, expected {3 * len(virt)}")
        errs = []
        for i, frame in enumerate(virt):
            for j, want in enumerate(wants[i]):
                errs.append(maps_agree(outs[i][j].cpu(), want, MAP_RTOL, 1e-4,
                                       f"{key} heatmap {j}, frame {i}"))
            az_el = procs[0][1].azimuth_elevation_heatmap(frame, gates[i])
            errs.append(maps_agree(torch.from_numpy(outs[i][2]), torch.from_numpy(az_el),
                                   MAP_RTOL, 1e-4, f"{key} az-el, frame {i}"))
        emit(phase="beamform_processors", processor=cls.__name__, frames=len(virt),
             launches=launches[key], range_gates=gates, max_abs_diff=max(errs),
             heatmap_shapes=[list(t.shape) for t in outs[0][:2]],
             az_el_shape=list(outs[0][2].shape))
    return launches


def time_beamform(capon, raw_re, raw_im):
    """Each beamforming kernel and its plain version on the range DFT of ``raw``, in turns.

    Returns ``{entry: (kernel_ms, plain_ms)}``: Capon and Bartlett
    (covariance form) at [1024, 4, 63, 70], and Bartlett on the same data as
    snapshot blocks [64512, 4, 1, 70] against the snapshot form.
    """
    from mmwave_radar_processing_tpu_torch.ops import beamform

    x = capon.range_dft(raw_re, raw_im)  # [1024, 4, 63, 70]
    steer = capon.steering
    blocks = x.movedim(1, 2).reshape(-1, x.shape[1], 1, x.shape[3]).contiguous()
    cases = {
        "capon_power_pallas": (
            lambda: beamform.capon_power(x, steer, loading=LOADING),
            lambda: beamform.capon_power_reference(x, steer, loading=LOADING), x),
        "bartlett_power_pallas_cov": (
            lambda: beamform.bartlett_power(x, steer),
            lambda: beamform.bartlett_power_reference(x, steer), x),
        "bartlett_power": (
            lambda: beamform.bartlett_power(blocks, steer),
            lambda: beamform.bartlett_from_snapshots(blocks[:, :, 0], steer), blocks),
    }
    res = {}
    for name, (kernel, plain, data) in cases.items():
        for fn in (kernel, plain):
            fn()
        times = {"plain": [], "kernel": []}
        for turn in ("plain", "kernel", "kernel", "plain"):
            times[turn].append(cuda_ms(kernel if turn == "kernel" else plain, 20))
        res[name] = (sum(times["kernel"]) / 2, sum(times["plain"]) / 2)
        emit(phase="beamform_timing", replaces=name, shape=list(data.shape),
             n_angles=steer.shape[1], kernel_ms=res[name][0], plain_ms=res[name][1],
             turns=times)
    return res


def bench_inputs(cfg, device, batch=1024):
    """``bench.py``'s inputs: standard normal planes (seed 0), altitude 1.2."""
    rng = np.random.default_rng(0)
    shape = (batch, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    raw_re = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    raw_im = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    return raw_re, raw_im, torch.full((batch,), 1.2, device=device)


def measure_path(name, fn, device, batch=1024, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ms = cuda_ms(fn, iters)
    emit(phase="throughput", path=name, batch=batch, iters=iters, ms_per_batch=ms,
         frames_per_s=batch / (ms / 1e3),
         peak_mem_mb=torch.cuda.max_memory_allocated(device) / 1e6)


def time_responses(vel_pipeline, device, batch=1024):
    """Kernel and plain version at the main path's shapes, in turns.

    Returns ``{kind: (kernel_ms, plain_ms)}`` for the coarse batch
    ([B, 12, 19*70]), the zoom pass ([B, 12, 19*140]) and the paired layout
    ([B, 8, 19*140]).
    """
    from mmwave_radar_processing_tpu_torch.ops import doppler_az

    w = vel_pipeline.win_rows
    coarse = response_inputs(batch, 12, w, 70, vel_pipeline.fct, vel_pipeline.fst,
                             seed=30, device=device)
    zoom = response_inputs(batch, 12, w, 140, vel_pipeline.fct, vel_pipeline.fst,
                           seed=31, device=device)
    paired = paired_inputs(coarse, w, 70)
    group = dict(set_idx=doppler_az.group_set_idx(2, 4), nv=140)
    cases = {"coarse": (coarse, dict(set_idx=SETS, nv=70)),
             "zoom": (zoom, dict(set_idx=SETS, nv=140)),
             "group": (paired, group)}
    res = {}
    for kind, (args, kw) in cases.items():
        kernel = lambda: doppler_az.set_responses(*args, **kw)  # noqa: E731
        plain = lambda: doppler_az.set_responses_reference(*args, **kw)  # noqa: E731
        for fn in (kernel, plain):
            fn()
        times = {"plain": [], "kernel": []}
        for turn in ("plain", "kernel", "kernel", "plain"):
            times[turn].append(cuda_ms(kernel if turn == "kernel" else plain, 10))
        res[kind] = (sum(times["kernel"]) / 2, sum(times["plain"]) / 2)
        emit(phase="response_timing", layout=kind, shape=list(args[0].shape),
             kernel_ms=res[kind][0], plain_ms=res[kind][1], turns=times)
    return res


def build_kernels():
    """``nvcc`` for each kernel source, all started together; emits each build."""
    from mmwave_radar_processing_tpu_torch.ops.kernels import _build

    names = ("os_cfar_detect", "doppler_az_responses", "beamform_power")

    def timed(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(timed, names)))
    for name, (lib, seconds) in built.items():
        emit(phase="build", kernel=name, seconds=seconds,
             library=os.path.relpath(lib, HERE),
             ptxas=[ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln])
    emit(phase="build", wall_seconds=time.perf_counter() - t0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from mmwave_radar_processing_tpu_torch import (
        build_capon_pipeline, build_full_pipeline, build_point_cloud_pipeline,
        build_velocity_pipeline, load_cfg, make_inputs,
    )

    device = torch.device("cuda", 0)
    card = gpu_name_and_power_limit()
    emit(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    cfg = load_cfg(FLAGSHIP_CFG, array_geometry="ods", array_direction="down")
    pc_kw = dict(az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
                 cfar_params=CFAR_PARAMS, max_dets=128)
    gpu_pipeline = build_point_cloud_pipeline(cfg, device=device, **pc_kw)
    velocity = build_velocity_pipeline(cfg, device=device)
    precise = build_velocity_pipeline(cfg, enable_precise=True, device=device)
    full = build_full_pipeline(cfg, device=device, **pc_kw)
    capon = build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method="capon",
                                 loading=LOADING, device=device)
    bartlett = build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method="bartlett",
                                    device=device)
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is on: the port runs full float32 only")

    build_kernels()
    max_err = check_kernel(device)
    resp_err = check_responses(velocity, device)
    launches = check_slice(cfg, gpu_pipeline, device)
    frames = make_inputs(cfg, 32, seed=7)
    vel_launches = check_velocity(cfg, device, frames)
    comb_launches = check_combined(cfg, device, frames)
    bf_err = check_beamform(device)
    bf_launches = check_beamform_slice(cfg, device, frames)

    raw_re, raw_im, alts = bench_inputs(cfg, device)
    measure_path("pointcloud", lambda: gpu_pipeline(raw_re, raw_im), device)
    measure_path("velocity", lambda: velocity(raw_re, raw_im, alts), device)
    measure_path("velocity_precise", lambda: precise(raw_re, raw_im, alts), device)
    measure_path("combined", lambda: full(raw_re, raw_im, alts), device)
    measure_path("capon", lambda: capon(raw_re, raw_im), device)
    measure_path("bartlett", lambda: bartlett(raw_re, raw_im), device)
    measure_path("beamform_range_dft", lambda: capon.range_dft(raw_re, raw_im), device)
    bf_ms = time_beamform(capon, raw_re, raw_im)
    del raw_re, raw_im, alts
    kernel_ms, plain_ms = time_cfar(device)
    resp_ms = time_responses(velocity, device)

    def response_entry(name, kind, n_launches, err_kind):
        return {"name": f"doppler_az_responses ({name})", "route": "cuda",
                "source": RESP_SOURCE, "replaces": RESP_REPLACES[name],
                "launches": n_launches, "max_abs_err": resp_err[err_kind],
                "ms": resp_ms[kind][0], "plain_ms": resp_ms[kind][1]}

    def beamform_entry(name, n_launches):
        return {"name": name, "route": "cuda", "source": BEAMFORM_SOURCE,
                "replaces": BEAMFORM_REPLACES[name], "launches": n_launches,
                "max_abs_err": bf_err[name], "ms": bf_ms[name][0],
                "plain_ms": bf_ms[name][1]}

    # one CUDA kernel replaces TPU kernels #4-#6: #4 is the coarse response
    # of the velocity and combined runs, #5 the precise run (its zoom pass
    # and its coarse pass), #6 the same kernel in the paired layout, which
    # the main path does not use: its count is the kernel's over all runs
    all_resp = vel_launches["coarse"] + vel_launches["precise"] + comb_launches[1]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "os_cfar_2d_detect", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches + comb_launches[0],
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms},
        response_entry("set_responses_pallas_batch", "coarse",
                       vel_launches["coarse"] + comb_launches[1], "flagship"),
        response_entry("set_responses_pallas", "zoom", vel_launches["precise"],
                       "zoom"),
        response_entry("group_responses_pallas_batch", "group", all_resp, "group"),
        # one CUDA source replaces TPU kernels #7-#9: #7 is the Capon kernel
        # of the capon pipeline and processor runs, #8 the Bartlett kernel of
        # the bartlett pipeline run, #9 the same kernel of the Bartlett
        # processor run (its snapshot-block layout is [N, A, 1, K])
        beamform_entry("capon_power_pallas",
                       bf_launches["capon"] + bf_launches["capon_processor"]),
        beamform_entry("bartlett_power_pallas_cov", bf_launches["bartlett"]),
        beamform_entry("bartlett_power", bf_launches["bartlett_processor"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
