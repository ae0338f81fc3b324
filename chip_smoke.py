#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's point-cloud, velocity, combined, beamforming, detector-API, ground-scan, velocity-object-API and spectral-map paths on one NVIDIA GPU.

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
   at the flagship CFAR geometry and six others (a zero guard, a 3-column
   window, no training columns beside the guard box, no training rows above
   it, a 35-column window whose runs are run-time loops), and on maps of
   other sizes (one window exactly, smaller than a window: no launch, ragged
   tiles, and the largest map of a shipped config, 256x192, which no single
   block's shared memory holds); then the compacting entry of the same
   kernel: its rows, columns, validity and counts equal
   ``mask_to_indices_2d`` of the plain mask, on batches that hold frames
   with no detection, with exactly ``capacity`` and with more;
4. response kernel: the Doppler-azimuth responses equal their plain version,
   bit for bit, at B in {1, 7, 1024} of [12, 19*70] with 60 angle bins, at
   the zoom width nv = 140, at an odd small shape, at angle counts that the
   block of 4 angle bins a thread does not divide (7, 61, 62), with 3 and 5
   antennas a set, in the paired (group) layout, and the paired layout equals
   the unpaired one;
5. point-cloud slice: ``make_inputs(cfg, 32, seed=7)`` (seeded simulated
   frames, numpy only) through the pipeline on the GPU and on the CPU (the
   plain path that the tests hold to the JAX package): ``count`` and
   ``valid`` identical, ``points`` within ``POINTS_ATOL``, and
   ``compare_outputs`` at its raised gates (set IoU >= 0.95, counts within 2
   on >= 95% of frames);
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
   {1, 7, 1024}, at A = 12 (the processors' aperture), A = 7 and A = 12 with
   the 2048-angle azimuth-elevation grid, A = 16, an odd small shape, and the
   shapes that reach the kernel's tile geometry (tiles that straddle frames,
   W = 1 with N not a multiple of the tile, odd K and an x off 16 bytes,
   which take 8-byte copies in place of bulk ones, a config-sized cube of
   256 range bins and 192 chirps, A = 1, rows longer than a stage); then the
   kernel's own tile geometry and copies (its host code) equal the model that
   the CPU tests check, at every (W, K) of a config under ``configs/``;
9. beamforming slice: the same 32 frames through ``build_capon_pipeline``
   (``capon`` and ``bartlett``) on the GPU and on the CPU port, then both
   processors on 3 frames (the 12-antenna and the 4-antenna heatmap, and
   the azimuth-elevation heatmap at each frame's strongest range gate),
   each within rtol ``MAP_RTOL`` and atol 1e-4 times the map's maximum;
10. rank-selection kernels: the OS-CFAR 2D noise map against its plain
   version (slice-stacked training cells, sorted), equal on every cell, on
   the maps of phase 3 (``+inf`` cells added), a geometry with a zero guard,
   1024 maps of 256x192, a 3-column window, a window whose region needs the
   largest sort, maps of several tiles whose core no tile divides in either
   axis, and a map of whole tiles plus one cell; ``os_2d``'s
   thresholds equal ``alpha`` times that noise padded with ``+inf``, and
   ``x > os_2d(x)`` equals the detection kernel's mask bit for bit (the two
   kernels check each other); the k-th smallest along rows against a sort,
   equal on every row, through the kernel that serves each width (the
   sorting network up to 32 columns, the warp-wide sort up to 256, the search
   above), for W in {1, 3, 4, 8, 9, 10, 16, 17, 24, 31, 32, 33, 64, 65, 128,
   129, 152, 220, 256, 257, 300}, k = 1, a middle rank and W, and M in {1, 3,
   259, 1000, 100003}, with ties, ``+inf`` and both zeros;
11. detector slice: the same 32 frames, reformatted, frame by frame through
   ``RangeDetector``, ``RangeDopplerDetector2D`` (OS and CA),
   ``RangeDopplerDetectorSequential``, ``RangeDopplerGroundDetector`` and
   ``PointCloudGenerator`` (2D detector with FFT and with Capon angles;
   ground detector) on the GPU and on the CPU port, fresh stateful objects on
   each side: detection sets identical, the altitude track within
   ``ALTITUDE_ATOL`` and points within ``DETECTOR_POINTS_ATOL`` on at least
   31 of 32 frames;
12. throughput at batch 1024 (``bench.py``'s inputs: standard normal planes,
   seed 0, altitude 1.2) of the point-cloud, velocity, combined, capon and
   bartlett paths, timed with CUDA events after warm-up, with peak device
   memory, and the beamforming paths' range DFT alone; ``os_2d`` plus the
   compare at 1024 maps; ``PointCloudGenerator.process`` frame by frame
   over 256 frames (host-limited by nature) with the device's busy share;
13. each kernel and its plain version timed at the main path's shapes, in
   turns (plain, kernel, kernel, plain), ``torch.kthvalue`` beside the k-th
   smallest kernel as its library yardstick, the compacting detection entry
   beside the mask entry followed by ``mask_to_indices_2d`` (these two
   kernels and the beamforming kernels behind a busy device, so that the
   time is the device's, with the launch-to-launch time beside it), and each
   kernel's bound and ``share`` (bound / time): the
   larger of its bytes (inputs read once, outputs written once) over
   ``HBM_BYTES_PER_S`` and its operations over ``FP32_OPS_PER_S``; the noise
   kernel also on continuous maps (within 5% of the quantized ones: it
   searches ranks, not floats), for one frame, at two other windows, and
   with the operations its own design spends (``kernel_own_ops``);
14. ground kernel: the altitude recursion of the ground scan against its
   plain version (a loop of T steps over tensors) on the same CUDA tensors,
   equal bit for bit, at T in {1, 7, 1024, 5000}, precise and not, with a
   range bias, on candidates that hold frames with no eligible candidate and
   frames of equal candidates;
15. ground slice: a simulated recording of 32 ground frames (the port's
   ``ground_scene``, the altitude rising gradually from 0.55 m to 1.2 m and
   back) through ``build_ground_point_cloud_pipeline`` on the GPU (one
   launch of the recursion kernel) and on the CPU port: the altitude track
   within ``ALTITUDE_ATOL``, counts and masks identical and points within
   ``POINTS_ATOL`` on at least 31 of 32 frames, ``compare_outputs`` at its
   raised gates;
16. velocity object API: 16 ground frames through
   ``processors.VelocityEstimator.process``, coarse and precise, on the GPU
   and on the CPU with the same draws: ``vx`` within ``VX_ATOL`` on every
   frame and the velocity within 1e-4 on at least 15; ms a frame and the
   device's busy share;
17. throughput of ``ground`` and ``ground_altitude`` (``stop_after=
   "altitude"``) at T = 1024 on ``bench.py``'s inputs, with peak memory, and
   the recursion kernel and its plain version on that path's own inputs at
   T = 1024, timed behind a busy device, with the kernel's bound; the
   path's stages timed alone, and one call profiled (busy share, top
   kernels);
18. spectral slice: the frames of phase 5 through the four
   ``spectral_pipeline`` builders on the GPU and on the CPU port, maps within
   rtol ``MAP_RTOL`` and atol 1e-4 times the maximum; DBS with seeded
   velocities whose ``|v_xy|`` straddles the 0.25 m/s gate: Doppler bins
   equal on at least ``MIN_DBS_BIN_AGREEMENT`` of (frame, angle) pairs, maps
   within the bar where they agree; then the processors on 3 frames
   (range-angle, DBS slow and fast, strip map at 0.2 and 0.35 m/s with its
   crop slices identical) and micro-Doppler over the 32 frames (``process``
   and ``scan``).  No hand-written kernel may launch on these paths;
19. synthetic-aperture slice: 32 simulated frames, on a steady track and
   with a velocity step that the gate rejects, through
   ``build_synthetic_aperture_pipeline`` and the processor frame by frame
   (without and with calibration) on both devices: gates identical, maps
   within the bar; with calibration the GPU's solve for the CPU's reflector
   picks within the ``sar_ods`` golden's bar (rtol 1e-3, atol 1e-5) on every
   frame, and where both sides pick alike, their own calibrated geometry
   within it and the maps within 5e-3 of the maximum; the picks agree on at
   least ``MIN_CALIBRATION_AGREEMENT`` of the frames (at a broad beam's flat
   top neighbouring azimuth bins tie within rounding);
20. throughput of the spectral maps, strip map and DBS at batch 1024 and of
   micro-Doppler (history 20) and synthetic aperture (F = 3) on a recording
   of T = 1024, on ``bench.py``'s planes, with peak memory; one call of each
   profiled (busy share, top kernels); the spectral-maps and DBS stages
   timed alone.

``python3 chip_smoke.py --kernel-times`` runs only the kernels' part of phase
13: the beamforming, response, noise, detection and k-th-smallest kernels (each is held
against its plain version before or while it is timed), and adds the sweeps
that the default run leaves out: the detection kernel for one frame and at
other windows, the k-th-smallest kernel at other widths, on rows with a
denormal and ``+inf`` and for a launch of tens of rows.  To compare two trees
on one card, run it from the root of each in turns inside one job (parent,
change, change, parent).

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
RANK_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/os_rank_select.cu"
RANK_REPLACES = {
    "os_cfar_2d_noise": "mmwave_radar_processing_tpu/ops/pallas/os_cfar.py:218",
    "kth_smallest": "mmwave_radar_processing_tpu/ops/pallas/rank_select.py:88",
}
#: the ground scan's recursion: no Pallas kernel, XLA's lax.scan
GROUND_SOURCE = "mmwave_radar_processing_tpu_torch/csrc/altitude_track.cu"
GROUND_REPLACES = "mmwave_radar_processing_tpu/parallel/ground_pipeline.py:248"
GROUND_TS = (1, 7, 1024, 5000)
#: operations the recursion needs a frame: for each of 3 candidates and then
#: each of the chosen one's 2 refinements, a validity test, a compare with
#: the minimum altitude, a subtraction, an absolute value, a compare with the
#: gate and one with the running minimum (6 x 5 = 30); the found tests, the
#: final select and the bias add (4)
TRACK_OPS_PER_FRAME = 34
#: bytes a frame: 3 candidates (float32) and their flags (one byte), 6
#: refinements and their flags, 1 output
TRACK_BYTES_PER_FRAME = 3 * 4 + 3 + 6 * 4 + 6 + 4
VELOCITY_API_FRAMES = 16
NO_SIDES_CFAR_PARAMS = dict(num_train=(2, 0), num_guard=(1, 2), rho=0.5, alpha=1.5)
NO_BANDS_CFAR_PARAMS = dict(num_train=(0, 3), num_guard=(2, 1), rho=0.5, alpha=1.5)
#: a 5 x 35 window: its runs are longer than the 31 columns that get a constant length
WIDE_CFAR_PARAMS = dict(num_train=(1, 14), num_guard=(1, 3), rho=0.5, alpha=2.0)
ZERO_GUARD_CFAR_PARAMS = dict(num_train=(3, 2), num_guard=(0, 0), rho=0.5, alpha=2.0)
NARROW_CFAR_PARAMS = dict(num_train=(2, 1), num_guard=(1, 0), rho=0.6, alpha=2.0)
#: the flagship's 17 x 15 window with other columns: 206 training cells against 220
OTHER_COLUMNS_CFAR_PARAMS = dict(num_train=(5, 4), num_guard=(3, 3), rho=0.7, alpha=4.0)
#: a 101 x 85 window: its region takes the noise kernel's largest sort (16,384 keys)
HUGE_CFAR_PARAMS = dict(num_train=(48, 40), num_guard=(2, 2), rho=0.7, alpha=2.0)
#: published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
#: and float32 operations outside the tensor cores (an FMA counts as two)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: detector slice, GPU vs CPU port: the golden scenarios' bar on the altitude
#: track (tests/golden_scenarios.py, altimeter_ods), and on the points ten
#: times the tests' atol of 1e-5 for the CPU port against the JAX package,
#: since cuFFT and the CPU FFT round the angle spectra differently
ALTITUDE_ATOL = 5e-3
DETECTOR_POINTS_ATOL = 1e-4
#: the altimeter follows frame-to-frame altitude jumps of the seeded frames
#: (0.9-1.3 m, independent per frame) only with a wide tracking gate
SMOKE_ALTIMETER = dict(min_altitude_m=0.25, zoom_search_region_m=0.2,
                       altitude_search_limit_m=1.5, range_bias=0.0)
GROUND_VEL_CFAR = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
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
MIN_DBS_BIN_AGREEMENT = 0.99
# the calibration's reflector picks are comparisons of float32 dB values; at
# the flat top of the 1.8 m reflector's beam neighbouring azimuth bins tie to
# within rounding (the port and the JAX package on one CPU pick alike on 50
# of 54 frames of the recording, the GPU and the CPU port on 24 of 30): a
# sanity bar, the solve itself is held on every frame
MIN_CALIBRATION_AGREEMENT = 0.5
SA_FRAMES = 32
SA_VEL = (0.2, 0.01, 0.0)
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


def cuda_ms(fn, iters, queued=False):
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls.

    ``queued``: the calls are enqueued behind a matrix product that keeps the
    device busy for some 20 ms, so the events see the device's time for them
    and not the host's time to launch them (a kernel of under 0.1 ms is
    launched more slowly than it runs).
    """
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        if cuda_ms.ballast is None:
            cuda_ms.ballast = torch.ones((8192, 8192), device="cuda")
        torch.mm(cuda_ms.ballast, cuda_ms.ballast)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


cuda_ms.ballast = None


def check_kernel(device):
    """Kernel vs plain version on the same CUDA tensors; returns max |error|."""
    from mmwave_radar_processing_tpu_torch.ops.cfar import (
        os_2d_detect, os_2d_detect_reference,
    )
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        detect_launch_geometry, frame_fits_one_block, os_cfar_2d_detect,
    )

    cases = [(p, (b, 63, 70)) for p in (CFAR_PARAMS, SECOND_CFAR_PARAMS)
             for b in (1, 7, 1024)]
    cases += [(p, (b, 63, 70)) for b in (1, 33)
              for p in (ZERO_GUARD_CFAR_PARAMS, NARROW_CFAR_PARAMS, NO_SIDES_CFAR_PARAMS,
                        NO_BANDS_CFAR_PARAMS, WIDE_CFAR_PARAMS, OTHER_COLUMNS_CFAR_PARAMS)]
    cases += [(CFAR_PARAMS, (3, 17, 15)),   # exactly one window
              (CFAR_PARAMS, (2, 10, 12)),   # smaller than a window: all False, no launch
              (SECOND_CFAR_PARAMS, (5, 64, 128)),
              (CFAR_PARAMS, ragged_noise_shape(CFAR_PARAMS, 1)),  # tiles that divide no axis
              (CFAR_PARAMS, (2, 256, 192)),     # no one block's shared memory holds it
              (CFAR_PARAMS, (1024, 256, 192))]
    max_err = 0
    for i, (params, shape) in enumerate(cases):
        x = quantized_maps(*shape, seed=i, device=device)
        _, lost_r, lost_d = window_cells(params)
        expected = 0 if shape[1] <= lost_r or shape[2] <= lost_d else 1
        before = os_cfar_2d_detect.launches
        got = os_2d_detect(x, **params)
        torch.cuda.synchronize()
        if os_cfar_2d_detect.launches != before + expected:
            raise RuntimeError(f"{os_cfar_2d_detect.launches - before} launches counted "
                               f"for {shape}, expected {expected}")
        want = os_2d_detect_reference(x, **params)
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"kernel != plain version at {shape} {params}: "
                f"{int((got != want).sum())} cells differ")
        if shape[1:] == (63, 70) and not bool(want.any()):
            raise RuntimeError(f"no detections at {shape}: a vacuous check")
        geo = (detect_launch_geometry(shape[1], shape[2], tuple(params["num_train"]),
                                      tuple(params["num_guard"]), shape[0])._asdict()
               if expected else None)
        emit(phase="kernel", shape=list(shape), cfar=params,
             detections=int(want.sum()), equal=True, geometry=geo)
    if frame_fits_one_block(256, 192, (5, 5), (3, 2)):
        raise RuntimeError("a 256x192 map was to exceed one block's shared memory")
    return float(max_err)


def check_compact_kernel(device):
    """The compacting entry vs ``mask_to_indices_2d`` of the plain mask: four equal outputs.

    Each batch holds a frame with no detection (a constant map) and, by the
    choice of ``capacity`` from the frames' own counts, a frame with exactly
    ``capacity`` detections and frames with more and with fewer.  A frame too
    large for one block takes the mask kernel and ``mask_to_indices_2d``: the
    same four outputs.  Returns max |error| over the index outputs.
    """
    from mmwave_radar_processing_tpu_torch.ops import cfar, masked
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        frame_fits_one_block, os_cfar_2d_detect,
    )

    cases = [(CFAR_PARAMS, (1024, 63, 70)), (CFAR_PARAMS, (1, 63, 70)),
             (SECOND_CFAR_PARAMS, (33, 63, 70)), (NARROW_CFAR_PARAMS, (7, 40, 81)),
             (WIDE_CFAR_PARAMS, (5, 30, 80)), (CFAR_PARAMS, (3, 17, 15)),
             (CFAR_PARAMS, (2, 10, 12)), (CFAR_PARAMS, (9, 128, 128)),
             (CFAR_PARAMS, (3, 256, 192))]
    max_err = 0
    for i, (params, shape) in enumerate(cases):
        x = quantized_maps(*shape, seed=40 + i, device=device)
        if shape[0] > 1:
            x[0] = 1.0  # a constant map: nothing lies below a cell once scaled by alpha >= 1
        _, lost_r, lost_d = window_cells(params)
        has_interior = shape[1] > lost_r and shape[2] > lost_d
        plain_mask = cfar.os_2d_detect_reference(x, **params)
        counts = plain_mask.sum(dim=(1, 2))
        middle = int(counts.sort().values[len(counts) // 2])
        capacities = sorted({1, 128, max(1, middle), int(counts.max()) + 3})
        for capacity in capacities:
            before = os_cfar_2d_detect.launches
            got = cfar.os_2d_detect_compact(x, capacity, **params)
            torch.cuda.synchronize()
            launched = os_cfar_2d_detect.launches - before
            if launched != int(has_interior):
                raise RuntimeError(f"{launched} launches counted at {shape}")
            want = masked.mask_to_indices_2d(plain_mask, capacity)
            for name, g, w in zip(("rows", "cols", "valid", "count"), got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise RuntimeError(f"compact {name}: {g.dtype} {tuple(g.shape)}, "
                                       f"expected {w.dtype} {tuple(w.shape)}")
                if not torch.equal(g, w):
                    raise RuntimeError(
                        f"compact {name} != mask_to_indices_2d at {shape} {params}, "
                        f"capacity {capacity}: {int((g != w).sum())} entries differ")
                if name in ("rows", "cols"):
                    max_err = max(max_err, int((g - w).abs().max()))
        fused = has_interior and frame_fits_one_block(
            shape[1], shape[2], tuple(params["num_train"]), tuple(params["num_guard"]))
        if shape[0] > 8 and fused and not (
                int(counts.min()) == 0 and middle in capacities
                and int((counts > middle).sum()) and int((counts < middle).sum())):
            raise RuntimeError(f"frames with 0, exactly and over capacity wanted at {shape}: "
                               f"counts {counts.tolist()[:8]}...")
        emit(phase="compact_kernel", shape=list(shape), cfar=params, capacities=capacities,
             one_block_a_frame=bool(fused), frames_without_detections=int((counts == 0).sum()),
             frames_at_a_capacity=int((counts == middle).sum()),
             frames_over_it=int((counts > middle).sum()), equal=True)
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
    raised_gates("slice", out_cpu, gpu)
    return launches


def raised_gates(phase, cpu, gpu):
    """``compare_outputs`` of a GPU point cloud against the CPU port's, at the raised gates.

    The port's one precision is full float32, so its leaves go under
    ``pointcloud_f32``: set IoU >= 0.95, counts within 2 on >= 95% of frames.
    Emits the report's leaves; raises when a gate fails.
    """
    from mmwave_radar_processing_tpu_torch.utils.verify import compare_outputs

    def leaves(batch):
        return {f"pointcloud_f32/{name}": getattr(batch, name).numpy()
                for name in ("points", "valid", "count")}

    report = compare_outputs(leaves(cpu), leaves(gpu))
    emit(phase=f"{phase}_raised_gates", ok=report["ok"], leaves=report["leaves"])
    gates = {leaf["leaf"]: leaf.get("gate") for leaf in report["leaves"]}
    if gates["pointcloud_f32/points"] != 0.95 or gates["pointcloud_f32/count"] != 0.95:
        raise RuntimeError(f"{phase}: the raised gates were not applied: {gates}")
    if not report["ok"]:
        raise RuntimeError(f"{phase}: compare_outputs failed a raised gate: {report}")


def timing(kernel_ms, plain_ms, n_bytes, n_ops, library_ms=None):
    """One kernel's measured times, its bound and ``share`` (bound / time), as the ``kernels`` line lists them."""
    bound, by = bound_ms(n_bytes, n_ops)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "share": bound / kernel_ms, "library_ms": library_ms}


def time_cfar(device, batch=1024, sweeps=False):
    """Detection kernel and plain version at [batch, 63, 70], in turns; no library call computes it.

    Then the compacting entry, which the pipelines launch, in turns with its
    plain version (the plain mask, then ``mask_to_indices_2d``); beside it the
    mask entry followed by ``mask_to_indices_2d`` (what the pipelines ran
    before).  Every time is the device's, taken behind a busy device;
    ``launch_to_launch_ms`` is the same call timed without that, the host's
    time to issue it included.  ``sweeps`` adds one frame launch to launch and
    three other windows.  Returns the compacting entry's ``timing`` with the
    mask entry's under ``"mask_entry"``.
    """
    from mmwave_radar_processing_tpu_torch.ops import cfar, masked

    x = quantized_maps(batch, 63, 70, seed=11, device=device)
    kernel_ms, plain_ms, turns = take_turns(
        lambda: cfar.os_2d_detect(x, **CFAR_PARAMS),
        lambda: cfar.os_2d_detect_reference(x, **CFAR_PARAMS), 50, 20, queued=True)
    n_train, lost_r, lost_d = window_cells(CFAR_PARAMS)
    cells = batch * (63 - lost_r) * (70 - lost_d)
    # float32 in, one byte a cell out; a multiply, a compare and an add per training cell
    res = timing(kernel_ms, plain_ms, 5 * x.numel(), 3 * n_train * cells)
    emit(phase="cfar_timing", shape=[batch, 63, 70], turns=turns, timed_behind_a_busy_device=True,
         launch_to_launch_ms=cuda_ms(lambda: cfar.os_2d_detect(x, **CFAR_PARAMS), 50), **res)

    edges = (lost_r // 2, lost_d // 2)

    def unfused():
        return masked.mask_to_indices_2d(cfar.os_2d_detect(x, **CFAR_PARAMS), 128,
                                         interior=edges)

    def fused():
        return cfar.os_2d_detect_compact(x, 128, **CFAR_PARAMS)

    def plain():
        return masked.mask_to_indices_2d(cfar.os_2d_detect_reference(x, **CFAR_PARAMS), 128)

    for other in (unfused, plain):
        for got, want in zip(fused(), other()):
            if not torch.equal(got, want):
                raise RuntimeError(f"the compacting entry differs from {other.__name__}() "
                                   "at the timed shape")
    fused_ms, plain_ms, compact_turns = take_turns(fused, plain, 50, 10, queued=True)
    unfused_ms = [cuda_ms(unfused, 20, queued=True) for _ in range(2)]
    # float32 in; two int64, a bool and (a frame) an int32 out for each of 128 slots
    compact = timing(fused_ms, plain_ms, 4 * x.numel() + batch * (128 * 17 + 4),
                     3 * n_train * cells)
    extra = {}
    if sweeps:
        extra["one_frame_launch_ms"] = cuda_ms(
            lambda: cfar.os_2d_detect(x[:1], **CFAR_PARAMS), 200)
        extra["one_frame_compact_launch_ms"] = cuda_ms(
            lambda: cfar.os_2d_detect_compact(x[:1], 128, **CFAR_PARAMS), 200)
        others = extra["other_windows"] = {}
        for name, params in (("other_columns", OTHER_COLUMNS_CFAR_PARAMS),
                             ("second", SECOND_CFAR_PARAMS), ("wide", WIDE_CFAR_PARAMS)):
            if not torch.equal(cfar.os_2d_detect(x, **params),
                               cfar.os_2d_detect_reference(x, **params)):
                raise RuntimeError(f"detection kernel != plain version at the {name} window")
            others[name] = {
                "n_train": window_cells(params)[0],
                "ms": cuda_ms(lambda: cfar.os_2d_detect(x, **params), 50, queued=True)}
    emit(phase="cfar_compact_timing", shape=[batch, 63, 70], capacity=128,
         turns=compact_turns, mask_kernel_then_topk_ms=unfused_ms,
         launch_to_launch_ms=cuda_ms(fused, 50), **extra, **compact)
    return {**compact, "mask_entry": res}


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

    def factors(n_angles, n_cols):
        return [torch.randn(n_angles, n_cols, generator=gen).to(device) for _ in "cs"]

    w = vel_pipeline.win_rows
    three, five = ((0, 3, 4), (1, 2, 5), (10, 11, 6)), ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9))
    cases = [("flagship", (1, 12, w, 70), fct, fst, SETS),
             ("flagship", (7, 12, w, 70), fct, fst, SETS),
             ("flagship", (1024, 12, w, 70), fct, fst, SETS),
             ("zoom", (32, 12, w, 140), fct, fst, SETS),
             ("odd", (3, 12, 5, 16), *factors(9, 16), SETS),
             # angle counts that leave 3, 1 and 2 bins in the last block of 4 a thread takes
             ("odd", (33, 12, w, 70), *factors(7, 16), SETS),
             ("odd", (2, 12, w, 140), *factors(61, 16), SETS),
             ("odd", (2, 12, w, 70), *factors(62, 16), SETS),
             # antennas a set other than 4: the factors stay out of the registers
             ("odd", (33, 12, w, 70), *factors(13, 9), three),
             ("odd", (5, 12, w, 70), *factors(60, 10), five)]
    errs = {"flagship": 0.0, "zoom": 0.0, "odd": 0.0, "group": 0.0}
    for i, (kind, (b, c, rows, nv), fc, fs, sets) in enumerate(cases):
        args = response_inputs(b, c, rows, nv, fc, fs, seed=20 + i, device=device)
        before = doppler_az_responses.launches
        got = doppler_az.set_responses(*args, set_idx=sets, nv=nv)
        torch.cuda.synchronize()
        if doppler_az_responses.launches != before + 1:
            raise RuntimeError(f"response kernel launch not counted at {(b, c, rows, nv)}")
        want = doppler_az.set_responses_reference(*args, set_idx=sets, nv=nv)
        err = float((got - want).abs().max())
        errs[kind] = max(errs[kind], err)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"response kernel != plain version at {(b, c, rows * nv)}: "
                f"{int((got != want).sum())} values differ, max |diff| {err}")
        if not bool((want > 0).any()):
            raise RuntimeError(f"all-zero responses at {(b, c, rows * nv)}: vacuous")
        emit(phase="response_kernel", shape=[b, c, rows * nv], nv=nv,
             n_angles=fc.shape[0], antennas_a_set=len(sets[0]), equal=True)

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
    raised_gates("combined", pc_cpu, pc_gpu)
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
             ("odd", (2, 5, 3, 33, 31)),
             # the tile geometry: tiles that straddle frames, W = 1 with N not a
             # multiple of the tile, odd K (8-byte copies), a config-sized cube,
             # A = 1, A = 12 at the az-el grid, rows longer than a stage
             ("straddle", (67, 4, 63, 70, 64)), ("w1", (4300, 4, 1, 70, 64)),
             ("odd_k", (70, 4, 63, 33, 64)), ("config_cube", (17, 4, 256, 192, 64)),
             ("a1", (300, 1, 16, 70, 64)), ("processor", (3, 12, 1, 70, 2048)),
             ("chunked", (2, 16, 3, 500, 64)), ("chunked", (3, 16, 2, 401, 5)),
             # x one element into its storage: not 16-byte aligned, 8-byte copies
             ("misaligned", (67, 4, 63, 70, 64))]
    errs = {name: 0.0 for name in BEAMFORM_REPLACES}
    for i, (kind, shape) in enumerate(cases):
        x, steer = beamform_inputs(*shape, seed=40 + i, device=device)
        if kind == "misaligned":
            storage = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
            x = storage[1:].view(x.shape).copy_(x)
            if x.data_ptr() % 16 == 0:
                raise RuntimeError("the misaligned case is 16-byte aligned")
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
            emit(phase="beamform_kernel", kernel=name, kind=kind, shape=list(shape[:4]),
                 n_angles=shape[4], max_abs_err=err,
                 max_rel_err=float(((got - want).abs() / want.abs()).max()),
                 rtol=BEAMFORM_RTOL, **fields)
    check_beamform_geometry()
    return errs


def check_beamform_geometry():
    """The kernel's tile geometry (its host code) equals the model the CPU tests check.

    ``ops/kernels/beamform.py`` ``launch_geometry`` and ``tile_runs`` against
    the library's ``beamform_geometry`` and ``beamform_tile_runs``, at every
    (W, K) of a config under ``configs/``, every antenna count and the angle
    counts in use, and at the shapes of ``check_beamform``.
    """
    import glob

    from mmwave_radar_processing_tpu_torch import load_cfg
    from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as bkernel

    shapes = set()
    for path in glob.glob(os.path.join(HERE, "configs", "*.cfg")):
        cfg = load_cfg(path)
        for k in {cfg.frame.loops, cfg.chirps_per_frame}:
            for n_ant in range(1, bkernel.MAX_ANTENNAS + 1):
                for m in (64, 2048):
                    for batch in (1, 7, 1024):
                        shapes.add((batch * cfg.num_adc_samples, n_ant,
                                    cfg.num_adc_samples, k, m))
    shapes |= {(4221, 4, 63, 70, 64), (4300, 4, 1, 70, 64), (6, 16, 3, 500, 64),
               (6, 16, 2, 401, 5), (4410, 4, 63, 33, 64), (1, 1, 1, 1, 1)}
    n_runs = 0
    for shape in sorted(shapes):
        rows, n_ant, _, k, m = shape
        for aligned in (True, False):
            want = bkernel.launch_geometry(rows, n_ant, k, m, aligned)
            got = bkernel.kernel_launch_geometry(rows, n_ant, k, m, aligned)
            if got != want:
                raise RuntimeError(f"kernel geometry {got} != model {want} at {shape}")
        if want.smem_bytes > bkernel.SMEM_MAX:
            raise RuntimeError(f"{want.smem_bytes} bytes of shared memory at {shape}")
        for tile in {0, 1, want.tiles // 2, want.tiles - 1} & set(range(want.tiles)):
            for chunk in range(want.n_chunks):
                runs = bkernel.kernel_tile_runs(*shape, tile, chunk)
                if runs != bkernel.tile_runs(*shape, tile, chunk):
                    raise RuntimeError(f"kernel runs != model at {shape}, tile {tile}")
                n_runs += len(runs)
    emit(phase="beamform_geometry", shapes=len(shapes), runs_compared=n_runs, equal=True)


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

    Returns ``{entry: timing}``: Capon and Bartlett (covariance form) at
    [1024, 4, 63, 70], and Bartlett on the same data as snapshot blocks
    [64512, 4, 1, 70] against the snapshot form.  Timed behind a busy device
    (a kernel of ~0.05 ms launches more slowly than it runs), with the
    launch-to-launch time beside it.  No library call computes either
    function.
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
    b, a, w, k = x.shape
    m = steer.shape[1]
    # complex64 in (8 bytes), float32 maps out; per (frame, range bin) the
    # covariance is A*A*K complex multiply-adds (8 flops each), then Capon
    # solves L g = a per angle (~4A^2 flops) after an A^3-order Cholesky,
    # Bartlett forms a^H R a per angle (~8A^2 flops)
    n_bytes = 8 * x.numel() + 8 * steer.numel() + 4 * b * w * m
    ops = {"capon_power_pallas": b * w * (8 * a * a * k + 3 * a**3 + m * (4 * a * a + 4 * a)),
           "bartlett_power_pallas_cov": b * w * (8 * a * a * k + m * (8 * a * a + 2 * a)),
           "bartlett_power": b * w * (8 * a * a * k + m * (8 * a * a + 2 * a))}
    for name, (kernel, plain, data) in cases.items():
        want = plain()  # the snapshot form of #9 gives [N, M] for the kernel's [N, 1, M]
        maps_agree(kernel().reshape(want.shape), want, BEAMFORM_RTOL,
                   0.0 if name == "capon_power_pallas" else 1e-4,
                   f"{name} kernel at the timed shape")
        kernel_ms, plain_ms, turns = take_turns(kernel, plain, 50, 20, queued=True)
        res[name] = timing(kernel_ms, plain_ms, n_bytes, ops[name])
        emit(phase="beamform_timing", replaces=name, shape=list(data.shape),
             n_angles=m, turns=turns, timed_behind_a_busy_device=True,
             launch_to_launch_ms=cuda_ms(kernel, 50), **res[name])
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

    Returns ``{kind: timing}`` (no library call computes them) for the coarse batch
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
        kernel_ms, plain_ms, turns = take_turns(kernel, plain, 10, 10)
        out = kernel()
        if not torch.equal(out, plain()):
            raise RuntimeError(f"response kernel != plain version at the timed {kind} shape")
        n_rx = len(kw["set_idx"][0])
        # per output and range row: n_rx complex products by a real pair (6
        # flops) summed (2), a magnitude (4), a weight and a sum (2)
        res[kind] = timing(kernel_ms, plain_ms,
                           4 * (sum(t.numel() for t in args) + out.numel()),
                           out.numel() * w * (8 * n_rx + 4))
        emit(phase="response_timing", layout=kind, shape=list(args[0].shape),
             turns=turns, **res[kind])
    return res


def bound_ms(n_bytes, n_ops):
    """The least time for this work: ``(ms, "bytes" | "operations")``."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def window_cells(params):
    """``(training cells, core rows lost, core columns lost)`` of a 2D CFAR geometry."""
    (tr, td), (gr, gd) = params["num_train"], params["num_guard"]
    win_r, win_d = 2 * (tr + gr) + 1, 2 * (td + gd) + 1
    return win_r * win_d - (2 * gr + 1) * (2 * gd + 1), win_r - 1, win_d - 1


def selection_compares(n, k):
    """Compares that a k-th smallest (1-based) of ``n`` values needs: about ``n + min(k, n-k)``.

    What the function asks for (the expected count of a selection by
    partitioning), not what a chosen algorithm spends: the bounds of the two
    rank-selection kernels count this.
    """
    return n + min(k, n - k)


def take_turns(kernel, plain, kernel_iters, plain_iters, library=None, queued=False):
    """Mean ms of ``kernel`` and ``plain`` after a warm-up: plain, kernel, kernel, plain.

    ``queued``: every call is timed behind a busy device (:func:`cuda_ms`),
    so a short kernel's time is the device's.

    With a ``library`` call it is warmed up like the others and timed inside
    the turns, at the kernel's iteration count: plain, kernel, library,
    library, kernel, plain.  Returns ``(kernel_ms, plain_ms, times)``; the
    library's two readings are ``times["library"]``.
    """
    fns = {"kernel": (kernel, kernel_iters), "plain": (plain, plain_iters)}
    order = ("plain", "kernel", "kernel", "plain")
    if library is not None:
        fns["library"] = (library, kernel_iters)
        order = ("plain", "kernel", "library", "library", "kernel", "plain")
    for fn, _ in fns.values():
        fn()
    times = {name: [] for name in fns}
    for turn in order:
        times[turn].append(cuda_ms(*fns[turn], queued=queued))
    return sum(times["kernel"]) / 2, sum(times["plain"]) / 2, times


def check_noise_kernel(device):
    """OS-CFAR 2D noise kernel vs its plain version, equal on every cell; returns max |error|."""
    from mmwave_radar_processing_tpu_torch.ops import cfar
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        noise_launch_geometry, os_cfar_2d_noise,
    )

    cases = [(p, (b, 63, 70)) for p in (CFAR_PARAMS, SECOND_CFAR_PARAMS)
             for b in (1, 7, 1024)]
    cases += [(ZERO_GUARD_CFAR_PARAMS, (7, 63, 70)),
              (CFAR_PARAMS, (3, 17, 15)),   # exactly one window
              (CFAR_PARAMS, (2, 10, 12)),   # smaller than a window: no launch
              (CFAR_PARAMS, (2, 256, 192)),  # the largest map of a shipped config
              (CFAR_PARAMS, (1024, 256, 192)),
              (NARROW_CFAR_PARAMS, (7, 63, 70)),  # a 3-column window: the shortest runs
              (HUGE_CFAR_PARAMS, (2, 104, 90)),
              (CFAR_PARAMS, ragged_noise_shape(CFAR_PARAMS, 1)),
              (SECOND_CFAR_PARAMS, ragged_noise_shape(SECOND_CFAR_PARAMS, 64)),
              (CFAR_PARAMS, tile_plus_a_cell_noise_shape(CFAR_PARAMS, 1))]
    max_err = 0.0
    for i, (params, shape) in enumerate(cases):
        x = quantized_maps(*shape, seed=60 + i, device=device)
        x[:, ::9, ::7] = float("inf")
        n_train, lost_r, lost_d = window_cells(params)
        k = cfar.os_rank(params["rho"], n_train)
        before = os_cfar_2d_noise.launches
        thr, noise = cfar.os_2d(x, **params)
        torch.cuda.synchronize()
        launched = os_cfar_2d_noise.launches - before
        if thr.shape != x.shape or noise.shape != x.shape:
            raise RuntimeError(f"os_2d: shapes {tuple(thr.shape)}, {tuple(noise.shape)}")
        if shape[1] <= lost_r or shape[2] <= lost_d:
            if launched or not (bool(torch.isinf(thr).all()) and bool((noise == 0).all())):
                raise RuntimeError(f"a map smaller than a window at {shape}: "
                                   f"{launched} launches, or not all +inf / 0")
            emit(phase="noise_kernel", shape=list(shape), cfar=params, launches=0)
            continue
        if launched != 1:
            raise RuntimeError(f"noise kernel launch not counted for {shape}")
        er, ed = lost_r // 2, lost_d // 2
        core = (slice(None), slice(er, shape[1] - er), slice(ed, shape[2] - ed))
        want = cfar.os_2d_noise_reference(
            x, num_train=params["num_train"], num_guard=params["num_guard"], k=k)
        finite = torch.isfinite(want)
        err = float((noise[core][finite] - want[finite]).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(noise[core], want):
            raise RuntimeError(
                f"noise kernel != plain version at {shape} {params}: "
                f"{int((noise[core] != want).sum())} cells differ, max |diff| {err}")
        padded = torch.full_like(x, float("inf"))
        padded[core] = params["alpha"] * want
        zeros = torch.zeros_like(x)
        zeros[core] = want
        if not (torch.equal(thr, padded) and torch.equal(noise, zeros)):
            raise RuntimeError(f"os_2d's padding or scaling is off at {shape}")
        mask = cfar.os_2d_detect(x, **params)
        if not torch.equal(x > thr, mask):
            raise RuntimeError(
                f"x > os_2d(x) differs from the detection kernel's mask at {shape} "
                f"{params}: {int(((x > thr) != mask).sum())} cells")
        geo = noise_launch_geometry(shape[1], shape[2], tuple(params["num_train"]),
                                    tuple(params["num_guard"]), shape[0])
        emit(phase="noise_kernel", shape=list(shape), cfar=params, k=k, equal=True,
             detections=int(mask.sum()), equals_detection_kernel=True,
             geometry=geo._asdict())
    return max_err


def noise_shapes(params, batch):
    """``(shape, core, geometry)`` of small maps in the order searched for a tiling property."""
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import noise_launch_geometry

    _, lost_r, lost_d = window_cells(params)
    for rows in range(lost_r + 2, lost_r + 70):
        for cols in range(lost_d + 2, lost_d + 70):
            geo = noise_launch_geometry(rows, cols, tuple(params["num_train"]),
                                        tuple(params["num_guard"]), batch)
            yield (batch, rows, cols), (rows - lost_r, cols - lost_d), geo


def ragged_noise_shape(params, batch):
    """A map of several tiles whose core no tile divides, in either axis."""
    for shape, (r_out, d_out), geo in noise_shapes(params, batch):
        if (geo.tiles_r > 1 and geo.tiles_d > 1 and r_out % geo.tile_r
                and d_out % geo.tile_d and d_out % 4):
            return shape
    raise RuntimeError("no ragged tiling found")


def tile_plus_a_cell_noise_shape(params, batch):
    """A map whose core is whole tiles and one more cell, in each axis."""
    for shape, (r_out, d_out), geo in noise_shapes(params, batch):
        if (geo.tiles_r > 1 and geo.tiles_d > 1 and r_out % geo.tile_r == 1
                and d_out % geo.tile_d == 1):
            return shape
    raise RuntimeError("no map of whole tiles plus one cell found")


def check_kth_kernel(device):
    """k-th smallest kernel vs a sort, equal on every row, at every width; returns max |error|."""
    from mmwave_radar_processing_tpu_torch.ops import cfar
    from mmwave_radar_processing_tpu_torch.ops.kernels.rank_select import kth_smallest

    def ranks(w):
        return tuple(sorted({1, max(1, (7 * w) // 10), w}))

    cases = [((500, 152), (1, 77, 106, 152)), ((1000, 10), (1, 7, 10)),
             ((1, 24), (12,)), ((3, 220), (154,)), ((100003, 24), (12,)),
             ((100003, 33), (20,)), ((1000, 220), (154,))]
    # widths on both sides of 32 and 256, where the kernel changes
    cases += [((m, w), ranks(w))
              for w in (1, 3, 4, 8, 9, 16, 17, 24, 31, 32, 33, 64, 65, 128, 129, 220, 256, 257, 300)
              for m in (1000, 259)]  # 259: not a multiple of the block's 256 rows or 8 warps
    max_err = 0.0
    for i, (shape, ks) in enumerate(cases):
        x = quantized_maps(1, *shape, seed=80 + i, device=device)[0] - 0.5
        x[0, ::2] = float("inf")
        if shape[0] > 2:
            x[1] = x[1, 0].clone()  # a row of one value: every rank ties
            x[2, ::3] = -0.0        # both zeros in a row
            x[2, 1::3] = 0.0
        for k in ks:
            want = cfar.kth_smallest_reference(x, k)
            before = kth_smallest.launches
            got = cfar._rank_reduce(x, k)
            torch.cuda.synchronize()
            if kth_smallest.launches != before + 1:
                raise RuntimeError(f"k-th smallest launch not counted at {shape}")
            if not torch.equal(got, want):
                raise RuntimeError(f"k-th smallest != sort at {shape}, k={k}: "
                                   f"{int((got != want).sum())} rows differ")
            finite = torch.isfinite(want)
            if bool(finite.any()):
                max_err = max(max_err, float((got[finite] - want[finite]).abs().max()))
        emit(phase="kth_kernel", shape=list(shape), ks=list(ks), equal=True)
    return max_err


def detector_specs(cfg):
    """``name -> (constructor taking device, kernel that must launch)`` of the detector slice."""
    from mmwave_radar_processing_tpu_torch import (
        PointCloudGenerator, RangeDetector, RangeDopplerDetector2D,
        RangeDopplerDetectorSequential, RangeDopplerGroundDetector,
    )

    os2d = dict(cfar_type="os_cfar_2d", cfar_params=CFAR_PARAMS)
    ground = dict(vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL_CFAR,
                  altimeter_params=SMOKE_ALTIMETER)
    pcg = dict(az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS)
    pcg_2d = dict(detector_type="range_doppler_detector_2d", detector_params=os2d, **pcg)
    return {
        "range_detector": (lambda d: RangeDetector(cfg, device=d), "kth"),
        "rd_2d_os": (lambda d: RangeDopplerDetector2D(cfg, device=d, **os2d), "noise"),
        "rd_2d_ca": (lambda d: RangeDopplerDetector2D(
            cfg, cfar_type="ca_cfar_2d",
            cfar_params=dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3), device=d), None),
        "rd_sequential": (lambda d: RangeDopplerDetectorSequential(cfg, device=d), "kth"),
        "rd_ground": (lambda d: RangeDopplerGroundDetector(cfg, device=d, **ground), "kth"),
        "pcg_2d_fft": (lambda d: PointCloudGenerator(cfg, device=d, **pcg_2d), "noise"),
        "pcg_2d_capon": (lambda d: PointCloudGenerator(
            cfg, aoa_method="capon", device=d, **pcg_2d), "noise"),
        "pcg_ground": (lambda d: PointCloudGenerator(
            cfg, detector_type="range_doppler_ground_detector", detector_params=ground,
            device=d, **pcg), "kth"),
    }


def check_detector_slice(cfg, device, frames):
    """The detector API frame by frame on the GPU vs the CPU port.

    Returns the launches of the two rank-selection kernels over the GPU runs:
    ``{"noise": n, "kth": n}``.
    """
    from mmwave_radar_processing_tpu_torch import VirtualArrayReformatter
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import os_cfar_2d_noise
    from mmwave_radar_processing_tpu_torch.ops.kernels.rank_select import kth_smallest

    raw = torch.complex(torch.from_numpy(frames[0]), torch.from_numpy(frames[1]))
    virt = VirtualArrayReformatter(cfg, device="cpu").process(raw)  # [32, 12, 63, 70]
    virt_gpu = VirtualArrayReformatter(cfg, device=device).process(raw.to(device))
    if not torch.equal(virt_gpu.cpu(), virt):
        raise RuntimeError("the reformatted cubes differ between GPU and CPU")
    n = len(virt)
    counters = {"noise": os_cfar_2d_noise, "kth": kth_smallest}
    totals = {"noise": 0, "kth": 0}
    for name, (make, needs) in detector_specs(cfg).items():
        gpu, cpu = make(device), make("cpu")
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0
        got = [gpu.process(virt_gpu[i]) for i in range(n)]
        torch.cuda.synchronize()
        launches = {key: c.launches for key, c in counters.items()}
        want = [cpu.process(virt[i]) for i in range(n)]
        is_points = name.startswith("pcg")
        agree, worst = 0, 0.0
        for g, c in zip(got, want):
            if g.shape != c.shape:
                continue
            if is_points:
                if not np.isfinite(g).all():
                    raise RuntimeError(f"{name}: non-finite points on the GPU")
                diff = float(np.abs(g - c).max()) if g.size else 0.0
                worst = max(worst, diff)
                agree += diff <= DETECTOR_POINTS_ATOL
            else:
                agree += np.array_equal(g, c)
        fields = {}
        if "ground" in name:
            tracker = lambda o: (o.detector if is_points else o).altimeter  # noqa: E731
            alt = [t.current_altitude_measured_m for t in (tracker(gpu), tracker(cpu))]
            fields["final_altitude_m"] = alt
            if not abs(alt[0] - alt[1]) <= ALTITUDE_ATOL or not alt[1] > 0.5:
                raise RuntimeError(f"{name}: final altitudes {alt} differ or never "
                                   "left the start")
        total = int(sum(len(c) for c in want))
        emit(phase="detector_slice", detector=name, frames=n, frames_agreeing=int(agree),
             detections=total, launches=launches,
             **({"points_max_abs_diff": worst} if is_points else {}), **fields)
        if agree < MIN_AGREEING_FRAMES:
            raise RuntimeError(f"{name}: only {agree} of {n} frames agree with the CPU port")
        if total == 0:
            raise RuntimeError(f"{name}: no detections: a vacuous check")
        if needs == "noise" and launches["noise"] != n:
            raise RuntimeError(f"{name}: {launches['noise']} noise-kernel launches "
                               f"for {n} frames, expected one a frame")
        if needs == "kth" and launches["kth"] < n:
            raise RuntimeError(f"{name}: {launches['kth']} k-th-smallest launches "
                               f"for {n} frames")
        for key in totals:
            totals[key] += launches[key]
    return totals


def check_altitude_track(cfg, device, frames):
    """``Altimeter.scan`` over the 32 frames on the GPU vs the CPU port, frame by frame."""
    from mmwave_radar_processing_tpu_torch import Altimeter, VirtualArrayReformatter

    raw = torch.complex(torch.from_numpy(frames[0]), torch.from_numpy(frames[1]))
    virt = VirtualArrayReformatter(cfg, device="cpu").process(raw)
    _, cpu = Altimeter(cfg, device="cpu", **SMOKE_ALTIMETER).scan(virt)
    _, gpu = Altimeter(cfg, device=device, **SMOKE_ALTIMETER).scan(virt.to(device))
    diff = (gpu.cpu() - cpu).abs()
    agree = int((diff <= ALTITUDE_ATOL).sum())
    emit(phase="altitude_track", frames=len(cpu), frames_agreeing=agree,
         max_abs_diff_m=float(diff.max()), track_min_m=float(cpu.min()),
         track_max_m=float(cpu.max()), atol_m=ALTITUDE_ATOL)
    if agree < MIN_AGREEING_FRAMES:
        raise RuntimeError(f"altitude track: only {agree} of {len(cpu)} frames agree")
    if not float(cpu.max() - cpu.min()) > 0.05:
        raise RuntimeError("the altitude track never moved: a vacuous check")


def track_inputs(t, seed, device):
    """Recursion inputs ``(cand, valid, zbins, zvalid)`` of ``t`` frames, with its edge cases.

    Candidates on a 1/8 m grid (ties), every 11th frame three equal
    candidates, every 13th from the 5th none within the gate, every 17th from
    the 7th none valid; refinements within 0.3 m of their candidate.
    """
    rng = np.random.default_rng(seed)
    cand = np.round(rng.uniform(0.0, 2.0, (t, 3)) * 8).astype(np.float32) / 8
    cand[::11] = cand[::11, :1]
    cand[5::13] = 3.0
    valid = rng.random((t, 3)) < 0.7
    valid[7::17] = False
    zbins = (cand[..., None] + np.round(rng.uniform(-0.3, 0.3, (t, 3, 2)) * 16) / 16
             ).astype(np.float32)
    zvalid = rng.random((t, 3, 2)) < 0.8
    return [torch.from_numpy(a).to(device) for a in (cand, valid, zbins, zvalid)]


def check_altitude_kernel(device):
    """The recursion kernel against its plain version on the same CUDA tensors; returns max |error|."""
    from mmwave_radar_processing_tpu_torch.ops import altitude

    for t in GROUND_TS:
        cand, valid, zbins, zvalid = track_inputs(t, seed=t, device=device)
        init = torch.tensor(0.9, device=device)
        distinct = {}
        for precise in (True, False):
            kw = dict(min_altitude_m=0.25, altitude_search_limit_m=0.4, range_bias=0.05,
                      precise=precise)
            got = altitude.altitude_track(cand, valid, zbins, zvalid, init, **kw)
            torch.cuda.synchronize()
            want = altitude.altitude_track_reference(cand, valid, zbins, zvalid, init, **kw)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                diff = float((got[0] - want[0]).abs().max())
                raise RuntimeError(f"altitude kernel != plain version at T={t}, "
                                   f"precise={precise}: max |diff| {diff}")
            distinct[str(precise)] = len(torch.unique(want[0]))
        if t > 7 and min(distinct.values()) < 10:
            raise RuntimeError(f"the track hardly moved at T={t}: a vacuous check")
        emit(phase="ground_kernel", frames=t, precise=[True, False], range_bias=0.05,
             equal=True, distinct_altitudes=distinct,
             frames_of_equal_candidates=int((cand == cand[:, :1]).all(1).sum()),
             frames_without_a_valid_candidate=int((~valid.any(1)).sum()))
    return 0.0


def ground_recording(cfg, frames=32, seed=8):
    """Planes ``[frames, rx, ns, nc]`` of simulated ground: the altitude rises from 0.55 m to 1.2 m and back."""
    from mmwave_radar_processing_tpu_torch.data import ground_scene, simulate_frame

    rng = np.random.default_rng(seed)
    raws = []
    for i in range(frames):
        alt = 0.55 + 0.65 * np.sin(np.pi * i / (frames - 1))
        scene = ground_scene(cfg, altitude_m=alt, ego_vel=(0.4, 0.1, 0.0), num_patches=48,
                             rng=rng, noise_sigma=0.03)
        raws.append(simulate_frame(cfg, scene, rng))
    raw = np.stack(raws)
    return np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32)


def check_ground_slice(cfg, device):
    """The ground scan on the GPU vs the CPU port over 32 simulated frames; returns kernel launches."""
    from mmwave_radar_processing_tpu_torch import build_ground_point_cloud_pipeline
    from mmwave_radar_processing_tpu_torch.ops.kernels.altitude_track import altitude_track

    raw_re, raw_im = ground_recording(cfg)
    n = len(raw_re)
    gpu_pipeline = build_ground_point_cloud_pipeline(cfg, device=device)
    re_gpu = torch.from_numpy(raw_re).to(device)
    im_gpu = torch.from_numpy(raw_im).to(device)
    torch.cuda.synchronize()
    altitude_track.launches = 0
    gpu = gpu_pipeline(re_gpu, im_gpu)
    torch.cuda.synchronize()
    launches = altitude_track.launches
    if launches != 1:
        raise RuntimeError(f"the ground path launched the recursion kernel {launches} times")
    cpu = build_ground_point_cloud_pipeline(cfg, device="cpu")(
        torch.from_numpy(raw_re), torch.from_numpy(raw_im))
    gpu = type(gpu)(*(t.cpu() for t in gpu))
    expected = {"points": (n, 128, 4), "valid": (n, 128), "count": (n,), "altitude": (n,),
                "final_altitude": ()}
    for name, shape in expected.items():
        if tuple(getattr(gpu, name).shape) != shape:
            raise RuntimeError(f"ground {name}: shape {tuple(getattr(gpu, name).shape)}")
    if not (bool(torch.isfinite(gpu.points).all()) and bool(torch.isfinite(gpu.altitude).all())):
        raise RuntimeError("non-finite ground outputs on the GPU")
    alt_err = float((gpu.altitude - cpu.altitude).abs().max())
    frame_ok = ((gpu.count == cpu.count) & (gpu.valid == cpu.valid).all(1)
                & ((gpu.points - cpu.points).abs().amax(dim=(1, 2)) <= POINTS_ATOL))
    agreeing = int(frame_ok.sum())
    emit(phase="ground_slice", frames=n, launches=launches, altitude_max_abs_diff_m=alt_err,
         altitude_atol_m=ALTITUDE_ATOL, final_altitude_m=[float(gpu.final_altitude),
                                                         float(cpu.final_altitude)],
         track_min_m=float(cpu.altitude.min()), track_max_m=float(cpu.altitude.max()),
         frames_agreeing=agreeing, points_max_abs_diff=float(
             (gpu.points - cpu.points).abs().max()), points_atol=POINTS_ATOL,
         mean_count=float(gpu.count.float().mean()))
    if not alt_err <= ALTITUDE_ATOL:
        raise RuntimeError(f"ground altitude track differs from the CPU port's by {alt_err}")
    if not float(cpu.altitude.max() - cpu.altitude.min()) > 0.3:
        raise RuntimeError("the ground altitude track never followed the profile")
    if agreeing < MIN_AGREEING_FRAMES:
        raise RuntimeError(f"ground: only {agreeing} of {n} frames agree with the CPU port")
    if int(gpu.count.sum()) == 0:
        raise RuntimeError("no ground detections: a vacuous check")
    raised_gates("ground", cpu, gpu)
    return launches


def velocity_api_frames(cfg, frames=VELOCITY_API_FRAMES, seed=9):
    """Virtual cubes (complex64, CPU) of ground frames at 1.2 m, vx rising from 0.8 m/s."""
    from mmwave_radar_processing_tpu_torch import VirtualArrayReformatter
    from mmwave_radar_processing_tpu_torch.data import ground_scene, simulate_frame

    rng = np.random.default_rng(seed)
    var = VirtualArrayReformatter(cfg, device="cpu")
    cubes = []
    for i in range(frames):
        scene = ground_scene(cfg, altitude_m=1.2, ego_vel=(0.8 + 0.02 * i, 0.3, -0.1),
                             num_patches=200, rng=rng, noise_sigma=0.01)
        cubes.append(var.process(simulate_frame(cfg, scene, rng)))
    return cubes


def check_velocity_api(cfg, device):
    """``processors.VelocityEstimator`` frame by frame on the GPU vs the CPU port, coarse and precise."""
    from torch.profiler import ProfilerActivity, profile

    from mmwave_radar_processing_tpu_torch.processors import VelocityEstimator

    kw = dict(lower_range_bound=0.5, upper_range_bound=0.5, min_R2_threshold=0.2,
              min_inlier_percent=0.3)
    cubes = velocity_api_frames(cfg)
    gpu_cubes = [c.to(device) for c in cubes]
    n = len(cubes)

    def run(estimator, frames, precise):
        vels, vxs = [], []
        for cube in frames:
            vels.append(estimator.process(adc_cube=cube, altitude=1.2,
                                          enable_precise_responses=precise).copy())
            vxs.append(float(estimator.ego_vx_estimate))
        return np.array(vels), np.array(vxs)

    for mode, precise in (("coarse", False), ("precise", True)):
        # both draw their RANSAC scores from a CPU generator seeded alike
        got, got_vx = run(VelocityEstimator(cfg, device=device, **kw), gpu_cubes, precise)
        want, want_vx = run(VelocityEstimator(cfg, device="cpu", **kw), cubes, precise)
        vx_err = float(np.abs(got_vx - want_vx).max())
        frame_err = np.abs(got - want).max(axis=1)
        agreeing = int((frame_err <= VELOCITY_ATOL).sum())
        # time a fresh estimator after that warm-up, then profile one more pass
        estimator = VelocityEstimator(cfg, device=device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(estimator, gpu_cubes, precise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(estimator, gpu_cubes, precise)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernel_us = sum((getattr(e, "self_device_time_total", 0.0) or 0.0)
                        for e in prof.key_averages()
                        if "CUDA" in str(getattr(e, "device_type", "")))
        emit(phase="velocity_api", mode=mode, frames=n, frames_agreeing=agreeing,
             vx_max_abs_diff=vx_err, velocity_max_abs_diff=float(frame_err.max()),
             vx_mean=float(want_vx.mean()), velocity_nonzero=int(np.count_nonzero(got)),
             ms_per_frame=seconds / n * 1e3, limited_by="host",
             device_busy_share_under_profiler=kernel_us / wall_us)
        if not vx_err <= VX_ATOL:
            raise RuntimeError(f"velocity API ({mode}): vx differs by {vx_err}")
        if agreeing < n - 1:
            raise RuntimeError(f"velocity API ({mode}): only {agreeing} of {n} frames agree")
        if not (np.count_nonzero(want_vx) == n and np.count_nonzero(got[:, :2]) > 0):
            raise RuntimeError(f"velocity API ({mode}): zero estimates: a vacuous check")
        if not np.isfinite(got).all():
            raise RuntimeError(f"velocity API ({mode}): non-finite estimates on the GPU")


def kernel_wrappers():
    """Every hand-written kernel's wrapper (each counts its launches), by name."""
    from mmwave_radar_processing_tpu_torch.ops.kernels import (
        altitude_track, beamform, doppler_az, os_cfar, rank_select,
    )

    return {"os_cfar_2d_detect": os_cfar.os_cfar_2d_detect, "os_cfar_2d_noise":
            os_cfar.os_cfar_2d_noise, "kth_smallest": rank_select.kth_smallest,
            "doppler_az_responses": doppler_az.doppler_az_responses,
            "capon_power": beamform.capon_power, "bartlett_power": beamform.bartlett_power,
            "altitude_track": altitude_track.altitude_track}


def no_kernel_launched(phase, fn):
    """Run ``fn`` with every launch count at 0 and raise if a hand-written kernel ran.

    No TPU kernel lies on the spectral-map paths (the JAX package computes
    them in plain XLA), so the port's versions are library calls only.
    """
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launched = {name: w.launches for name, w in wrappers.items() if w.launches}
    if launched:
        raise RuntimeError(f"{phase}: hand-written kernels launched on a library path: {launched}")
    return out


def dbs_velocities(n, seed=11):
    """float32 ``[n, 3]`` velocities whose ``|v_xy|`` straddles the DBS gate (0.05-0.6 m/s)."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.05, 0.6, n)
    heading = rng.uniform(-np.pi, np.pi, n)
    v = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                  rng.normal(0.0, 0.05, n)], axis=1)
    return torch.from_numpy(v.astype(np.float32))


def check_dbs(gpu_pipe, cpu_pipe, gpu_in, cpu_in, vel):
    """DBS on the GPU vs the CPU: Doppler bins equal on >= 99% of (frame, angle), maps where they agree."""
    out = no_kernel_launched("dbs", lambda: gpu_pipe(*gpu_in, vel.to(gpu_in[0].device))).cpu()
    want = cpu_pipe(*cpu_in, vel)
    fast = torch.sqrt(vel[:, 0] ** 2 + vel[:, 1] ** 2) >= cpu_pipe.min_x_y_vel_dbs
    if bool(fast.all()) or not bool(fast.any()):
        raise RuntimeError("the DBS velocities do not take both branches")
    bins_gpu = gpu_pipe.doppler_bins(vel.to(gpu_in[0].device)).cpu()
    bins_cpu = cpu_pipe.doppler_bins(vel)
    same = bins_gpu == bins_cpu
    share = float(same.float().mean())
    held = same | ~fast[:, None]  # a slow frame's map is the plain one
    err = maps_agree(out.transpose(1, 2)[held], want.transpose(1, 2)[held], MAP_RTOL, 1e-4,
                     "dbs pipeline")
    emit(phase="spectral_slice", path="dbs", batch=len(vel), fast_frames=int(fast.sum()),
         bins_agreeing=int(same.sum()), bins=same.numel(), bins_agreeing_share=share,
         max_abs_diff=err, map_max=float(want.max()))
    if share < MIN_DBS_BIN_AGREEMENT:
        raise RuntimeError(f"DBS Doppler bins agree on only {share:.4f} of (frame, angle) pairs")


def check_spectral_slice(cfg, device, frames):
    """The four spectral-map builders and the object processors on the GPU vs the CPU port."""
    from mmwave_radar_processing_tpu_torch import (
        MicroDopplerProcessor, RangeAngleProcessor, RangeAngleProcessorDBSEnhanced,
        StripMapSARProcessor, build_dbs_pipeline, build_micro_doppler_pipeline,
        build_spectral_maps_pipeline, build_strip_map_pipeline,
    )
    from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

    cpu_in = [torch.from_numpy(a) for a in frames[:2]]
    gpu_in = [t.to(device) for t in cpu_in]
    n = len(cpu_in[0])
    builders = {"spectral_maps": build_spectral_maps_pipeline,
                "micro_doppler": build_micro_doppler_pipeline,
                "strip_map": build_strip_map_pipeline}
    shapes = {"spectral_maps": [(n, 63, 70), (n, 63, 64), (n, 70, 54)],
              "micro_doppler": [(n, 70, 20)], "strip_map": [(n, 63, 70)]}
    for name, build in builders.items():
        gpu_pipe, cpu_pipe = build(cfg, device=device), build(cfg, device="cpu")
        got = no_kernel_launched(name, lambda: gpu_pipe(*gpu_in))
        want = cpu_pipe(*cpu_in)
        got, want = (list(got), list(want)) if name == "spectral_maps" else ([got], [want])
        errs = [maps_agree(g.cpu(), w, MAP_RTOL, 1e-4, f"{name} map {i}")
                for i, (g, w) in enumerate(zip(got, want))]
        if [tuple(g.shape) for g in got] != shapes[name]:
            raise RuntimeError(f"{name}: shapes {[tuple(g.shape) for g in got]}")
        emit(phase="spectral_slice", path=name, batch=n, max_abs_diff=max(errs),
             map_max=[float(w.max()) for w in want])
    check_dbs(build_dbs_pipeline(cfg, device=device), build_dbs_pipeline(cfg, device="cpu"),
              gpu_in, cpu_in, dbs_velocities(n))

    # the object processors, fresh objects on each side
    raw = torch.complex(*cpu_in)
    virt = reformat(raw, num_rx=cfg.num_rx_antennas, cfgs_per_loop=cfg.chirp_cfgs_per_loop)
    errs = {}

    def held(key, got, want):
        errs[key] = max(errs.get(key, 0.0), maps_agree(got, want, MAP_RTOL, 1e-4, key))

    ra = (RangeAngleProcessor(cfg, device=device), RangeAngleProcessor(cfg, device="cpu"))
    dbs = (RangeAngleProcessorDBSEnhanced(cfg, num_angle_bins_dbs_enhanced_response=100,
                                          device=device),
           RangeAngleProcessorDBSEnhanced(cfg, num_angle_bins_dbs_enhanced_response=100,
                                          device="cpu"))
    sar = (StripMapSARProcessor(cfg, device=device), StripMapSARProcessor(cfg, device="cpu"))
    for i in range(3):
        held("range_angle", ra[0].process(virt[i].to(device), rx_antennas=AZ_IDXS).cpu(),
             ra[1].process(virt[i], rx_antennas=AZ_IDXS))
        for label, v in (("dbs_slow", [0.1, 0.05, 0.0]), ("dbs_fast", [0.5, 0.2, 0.0])):
            held(label, dbs[0].process(virt[i].to(device), velocity_ned=v,
                                       rx_antennas=AZ_IDXS).cpu(),
                 dbs[1].process(virt[i], velocity_ned=v, rx_antennas=AZ_IDXS))
        for vel in (0.2, 0.35):
            got = sar[0].process(raw[i].to(device), vel_m_per_s=vel)
            want = sar[1].process(raw[i], vel_m_per_s=vel)
            slices = [(p.valid_ranges_slice, p.valid_angles_slice) for p in sar]
            if slices[0] != slices[1] or got.shape != want.shape or got.size == 0:
                raise RuntimeError(f"strip map at {vel} m/s: crops {slices}, shapes "
                                   f"{got.shape} and {want.shape}")
            held(f"strip_map_{vel}", torch.from_numpy(np.abs(got)),
                 torch.from_numpy(np.abs(want)))
    md = [MicroDopplerProcessor(cfg, target_ranges=(0.5, 2.0), device=d) for d in (device, "cpu")]
    virt_gpu = virt.to(device)
    for i in range(n):
        held("micro_doppler", md[0].process(virt_gpu[i]).cpu(), md[1].process(virt[i]))
    held("micro_doppler_scan", md[0].scan(virt_gpu)[1].cpu(), md[1].scan(virt)[1])
    emit(phase="spectral_processors", frames=3, micro_doppler_frames=n, max_abs_diff=errs)


def sa_recording(cfg, frames=SA_FRAMES, seed=21):
    """Planes ``[frames, rx, ns, nc]`` of three reflectors (two moving), and the two velocity tracks.

    ``steady``: ``SA_VEL`` on every frame; ``step``: 0.45 m/s along x on
    frames 16-19, above ``max_vel``, so the gate rejects frames 16-21.
    """
    from mmwave_radar_processing_tpu_torch.data import PointTarget, Scene, simulate_frame

    rng = np.random.default_rng(seed)
    raws = []
    for i in range(frames):
        scene = Scene(targets=[
            PointTarget(range_m=1.0 + 0.01 * i, rcs=4.0),
            PointTarget(range_m=1.8, azimuth_rad=0.3, velocity_m_s=0.4, rcs=2.0),
            PointTarget(range_m=2.6, azimuth_rad=-0.2, velocity_m_s=-0.3, rcs=2.0),
        ], noise_sigma=0.03)
        raws.append(simulate_frame(cfg, scene, rng))
    raw = np.stack(raws)
    steady = np.tile(SA_VEL, (frames, 1))
    step = steady.copy()
    step[16:20] = (0.45, 0.01, 0.0)
    return raw, {"steady": steady, "step": step}


def geometry_agrees(got, want, what):
    """Raise unless ``|got - want| <= 1e-5 + 1e-3*|want|`` (the sar_ods golden's bar); returns max |diff|."""
    diff = np.abs(got - want)
    if not (diff <= 1e-5 + 1e-3 * np.abs(want)).all():
        raise RuntimeError(f"calibrated geometry ({what}) differs by {diff.max()}")
    return float(diff.max())


def check_sa_slice(cfg, device):
    """Synthetic aperture on the GPU vs the CPU port: the batched pipeline and the processor.

    The gate's decisions equal, the maps within ``MAP_RTOL``; with
    calibration, the GPU's solve for the CPU's reflector picks within the
    golden's bars on every frame, and where both sides pick alike, their
    own calibrated geometry and map too.
    """
    from mmwave_radar_processing_tpu_torch import (
        SyntheticArrayBeamformerProcessor, build_synthetic_aperture_pipeline,
    )
    from mmwave_radar_processing_tpu_torch.processors.synthetic_array import (
        CalibrationTargets,
    )

    raw, tracks = sa_recording(cfg)
    planes = [torch.from_numpy(np.ascontiguousarray(f(raw)).astype(np.float32))
              for f in (np.real, np.imag)]
    gpu_pipe = build_synthetic_aperture_pipeline(cfg, device=device)
    cpu_pipe = build_synthetic_aperture_pipeline(cfg, device="cpu")
    kw = dict(num_frames=3, min_vel=np.array([0.15, 0.0, 0.0]),
              max_vel=np.array([0.3, 0.05, 0.05]))
    for track, vel in tracks.items():
        vel_t = torch.from_numpy(vel)
        mag, ok = no_kernel_launched("synthetic_aperture", lambda: gpu_pipe(
            *(p.to(device) for p in planes), vel_t.to(device)))
        want_mag, want_ok = cpu_pipe(*planes, vel_t)
        if not torch.equal(ok.cpu(), want_ok):
            raise RuntimeError(f"synthetic aperture ({track}): gates differ")
        n_ok = int(want_ok.sum())
        if n_ok != (30 if track == "steady" else 24):
            raise RuntimeError(f"synthetic aperture ({track}): {n_ok} frames pass the gate")
        pipe_err = maps_agree(mag.cpu(), want_mag, MAP_RTOL, 1e-4, f"sa pipeline {track}")

        errs = {"plain": 0.0, "calibrated_map": 0.0, "calibrated_geometry": 0.0,
                "solve_for_the_cpus_picks": 0.0}
        calibrated, solved, decided_apart = 0, 0, []
        for cal in (False, True):
            procs = [SyntheticArrayBeamformerProcessor(cfg, enable_calibration=cal, device=d,
                                                       **kw) for d in (device, "cpu")]
            for t in range(len(raw)):
                outs = [p.process(raw[t], current_vel=vel[t]) for p in procs]
                if procs[0].array_geometry_valid != procs[1].array_geometry_valid \
                        or procs[1].array_geometry_valid != bool(want_ok[t]):
                    raise RuntimeError(f"synthetic aperture processor ({track}, frame {t}): "
                                       "gates differ")
                if not procs[1].array_geometry_valid:
                    continue
                got, want = (torch.from_numpy(np.abs(o)) for o in outs)
                if not cal:
                    errs["plain"] = max(errs["plain"], maps_agree(
                        got, want, MAP_RTOL, 1e-4, f"sa processor {track} frame {t}"))
                    continue
                # the reflectors each side steers at, from its own uncalibrated
                # geometry and map: at a broad beam's flat top neighbouring
                # azimuth bins tie to within rounding, and the sides may pick apart
                targets = []
                for p in procs:
                    g = torch.from_numpy(p.array_geometry).to(p.device)
                    targets.append(p.calibration_targets(p.state, g,
                                                         p.compute_synthetic_response(p.state, g)))
                picks = [(sorted(zip(tg.rng_idx.tolist(), tg.az_idx.tolist())), bool(tg.ok))
                         for tg in targets]
                # the GPU's solve for the CPU's picks, on the GPU's own state,
                # within the golden's bars (a 3x2 least squares per element)
                want_geo = procs[1].array_geometry_calibrated
                if picks[1][1]:
                    g = torch.from_numpy(procs[0].array_geometry).to(device)
                    for_cpu_picks = procs[0].calibrate_to(procs[0].state, g, CalibrationTargets(
                        *(x.to(device) for x in targets[1]))).cpu().numpy()
                    errs["solve_for_the_cpus_picks"] = max(
                        errs["solve_for_the_cpus_picks"], geometry_agrees(
                            for_cpu_picks, want_geo, f"{track}, frame {t}, the CPU's picks"))
                    solved += 1
                if picks[0] != picks[1]:
                    decided_apart.append((t, picks))
                    continue
                errs["calibrated_geometry"] = max(errs["calibrated_geometry"], geometry_agrees(
                    procs[0].array_geometry_calibrated, want_geo, f"{track}, frame {t}"))
                errs["calibrated_map"] = max(errs["calibrated_map"], maps_agree(
                    got, want, 5e-3, 5e-3, f"calibrated sa {track} frame {t}"))
                calibrated += int(np.abs(want_geo - procs[1].array_geometry).max() > 1e-6)
        emit(phase="sa_slice", track=track, frames=len(raw), frames_passing=n_ok,
             pipeline_max_abs_diff=pipe_err, map_max=float(want_mag.max()),
             processor_max_abs_diff=errs, frames_calibrated=calibrated,
             frames_solved_for_the_cpus_picks=solved,
             calibration_picks_agreeing=n_ok - len(decided_apart),
             calibration_picks_apart=decided_apart)
        if calibrated == 0 or solved == 0:
            raise RuntimeError(f"synthetic aperture ({track}): calibration never moved the geometry")
        if n_ok - len(decided_apart) < MIN_CALIBRATION_AGREEMENT * n_ok:
            raise RuntimeError(f"synthetic aperture ({track}): the calibration picks agree on "
                               f"only {n_ok - len(decided_apart)} of {n_ok} frames")


def time_altitude_track(pipeline, raw_re, raw_im):
    """The recursion kernel and its plain version on the ground path's own inputs, in turns.

    The plain version is a loop of T small launches a step, so it is timed
    once a turn.  No library call computes the recursion.
    """
    from mmwave_radar_processing_tpu_torch.ops import altitude

    cand, valid, zbins, zvalid = pipeline.altitude_inputs(raw_re, raw_im)
    init = torch.tensor(pipeline.min_altitude_m, device=cand.device)
    kw = dict(min_altitude_m=pipeline.min_altitude_m,
              altitude_search_limit_m=pipeline.altitude_search_limit_m,
              range_bias=pipeline.range_bias, precise=pipeline.precise)

    def kernel():
        return altitude.altitude_track(cand, valid, zbins, zvalid, init, **kw)

    def plain():
        return altitude.altitude_track_reference(cand, valid, zbins, zvalid, init, **kw)

    if not all(torch.equal(a, b) for a, b in zip(kernel(), plain())):
        raise RuntimeError("altitude kernel != plain version on the ground path's inputs")
    kernel_ms, plain_ms, turns = take_turns(kernel, plain, 50, 1, queued=True)
    t = cand.shape[0]
    res = timing(kernel_ms, plain_ms, TRACK_BYTES_PER_FRAME * t + 8, TRACK_OPS_PER_FRAME * t)
    emit(phase="ground_kernel_timing", frames=t, turns=turns, timed_behind_a_busy_device=True,
         launch_to_launch_ms=cuda_ms(kernel, 50),
         frames_with_a_valid_candidate=int(valid.any(1).sum()), **res)
    return res


def measure_ground_stages(ground, raw_re, raw_im):
    """Where the ground path's time goes at T = 1024: each stage alone, and one call profiled.

    Stages in order, each timed with CUDA events over 10 calls on the
    previous stage's outputs: the complex planes, the coarse candidates, the
    zoom refinements, the recursion kernel, the detection.  Then one
    ``ground`` call under ``torch.profiler``: the device's busy share and the
    kernels that take the most device time.
    """
    raw = torch.complex(raw_re, raw_im)
    chirp0 = ground.loop0_chirps(raw)
    cand, valid = ground.peak_candidates(chirp0)
    zbins, zvalid = ground.refine_candidates(chirp0, cand)
    init = torch.tensor(ground.min_altitude_m, device=raw.device)
    alts, _ = ground.track(cand, valid, zbins, zvalid, init)
    stages = {
        "complex_planes": lambda: torch.complex(raw_re, raw_im),
        "candidates": lambda: ground.peak_candidates(ground.loop0_chirps(raw)),
        "refinements": lambda: ground.refine_candidates(chirp0, cand),
        "recursion": lambda: ground.track(cand, valid, zbins, zvalid, init),
        "detection": lambda: ground.detect_frames(raw, alts),
    }
    ms = {}
    for name, fn in stages.items():
        fn()
        ms[name] = cuda_ms(fn, 10)
    emit(phase="ground_stages", frames=int(raw.shape[0]), stage_ms=ms,
         stages_sum_ms=sum(ms.values()), **profiled_call(lambda: ground(raw_re, raw_im)))


def profiled_call(fn):
    """One call of ``fn`` under ``torch.profiler``: busy share, device time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0) or 0.0, e.key, e.count)
            for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    kernel_us = sum(us for us, _, _ in rows)
    return dict(device_busy_share_under_profiler=kernel_us / wall_us,
                device_kernels=sum(n for _, _, n in rows), device_ms=kernel_us / 1e3,
                top_kernels=[{"ms": us / 1e3, "launches": n, "name": key[:70]}
                             for us, key, n in sorted(rows, reverse=True)[:8]])


def measure_spectral_paths(cfg, device, raw_re, raw_im):
    """The five new paths at full width: ms, peak memory and one profiled call each.

    Batch 1024 of ``bench.py``'s planes for the spectral maps, the strip map
    and DBS (velocities straddling the gate); one recording of T = 1024 of
    the same planes for micro-Doppler (history 20) and synthetic aperture
    (F = 3, 60 azimuth bins, a steady track so that the gate passes).
    """
    from mmwave_radar_processing_tpu_torch import (
        build_dbs_pipeline, build_micro_doppler_pipeline, build_spectral_maps_pipeline,
        build_strip_map_pipeline, build_synthetic_aperture_pipeline,
    )

    n = raw_re.shape[0]
    vels = dbs_velocities(n).to(device)
    track = torch.from_numpy(np.tile(SA_VEL, (n, 1)).astype(np.float32)).to(device)
    maps = build_spectral_maps_pipeline(cfg, device=device)
    md = build_micro_doppler_pipeline(cfg, num_frames_history=20, device=device)
    strip = build_strip_map_pipeline(cfg, device=device)
    dbs = build_dbs_pipeline(cfg, device=device)
    sa = build_synthetic_aperture_pipeline(cfg, num_frames=3, device=device)
    paths = {"spectral_maps": lambda: maps(raw_re, raw_im),
             "micro_doppler": lambda: md(raw_re, raw_im),
             "strip_map": lambda: strip(raw_re, raw_im),
             "dbs": lambda: dbs(raw_re, raw_im, vels),
             "synthetic_aperture": lambda: sa(raw_re, raw_im, track)}
    if int(paths["synthetic_aperture"]()[1].sum()) != n - 2:
        raise RuntimeError("the steady track does not pass the synthetic-aperture gate")
    for name, fn in paths.items():
        measure_path(name, fn, device, batch=n)
        emit(phase="spectral_profile", path=name, batch=n, **profiled_call(fn))
    measure_spectral_stages(maps, dbs, raw_re, raw_im, vels)


def measure_spectral_stages(maps, dbs, raw_re, raw_im, vels):
    """The two device-bound spectral paths' stages, each alone over 10 calls on its inputs.

    The stages replay the pipelines' own buffers in the pipelines' order of
    operations (``parallel/spectral_pipeline.py``); their sum is held
    against the path's time by the reader, not here.
    """
    from mmwave_radar_processing_tpu_torch.ops.dft import cabs

    rd_in, ra_in, da_in = maps._channels(raw_re, raw_im, (maps.rx_idx,), maps.ra_idx,
                                         maps.da_idx)
    chirp = ra_in[..., maps.chirp_idx] * maps.ra_window[:, None]
    rng = maps.da_rng.transpose(0, 1) @ da_in
    moved = torch.movedim(rng, 1, -1)
    spec = maps.da_chirp.transpose(0, 1) @ moved
    ang = spec @ maps.da_ant
    stages = {
        "complex_planes": lambda: torch.complex(raw_re, raw_im),
        "channels": lambda: maps._channels(raw_re, raw_im, (maps.rx_idx,), maps.ra_idx,
                                           maps.da_idx),
        "range_doppler": lambda: cabs(maps.rd_rng.transpose(0, 1) @ rd_in[:, 0] @ maps.rd_dop),
        "range_angle": lambda: cabs((chirp @ maps.ra_rng).transpose(1, 2) @ maps.ra_ant),
        "da_range_dft": lambda: maps.da_rng.transpose(0, 1) @ da_in,
        "da_move_and_chirp_dft": lambda: maps.da_chirp.transpose(0, 1) @ torch.movedim(rng, 1, -1),
        "da_angle_dft": lambda: spec @ maps.da_ant,
        "da_magnitude_and_mean": lambda: cabs(ang).mean(dim=1),
    }
    (sub,) = dbs._channels(raw_re, raw_im, dbs.rx_idx)
    rd3 = dbs.rng.transpose(0, 1) @ sub @ dbs.dop
    spec3 = torch.movedim(rd3, 1, -1) @ dbs.ang
    ns = dbs.ns
    stages.update({
        "dbs_channels": lambda: dbs._channels(raw_re, raw_im, dbs.rx_idx),
        "dbs_range_doppler_dft": lambda: dbs.rng.transpose(0, 1) @ sub @ dbs.dop,
        "dbs_move_and_angle_dft": lambda: torch.movedim(rd3, 1, -1) @ dbs.ang,
        "dbs_bins_gather_magnitude": lambda: cabs(spec3.reshape(len(sub), ns, -1).gather(
            2, (dbs.doppler_bins(vels) * dbs.num_angle_bins + dbs.ang_near)[:, None, :]
            .expand(-1, ns, -1))),
        "dbs_plain_range_angle": lambda: cabs(((sub[..., dbs.chirp_idx] * dbs.ra_window[:, None])
                                               @ dbs.ra_rng).transpose(1, 2) @ dbs.ra_ant),
    })
    ms = {}
    for name, fn in stages.items():
        fn()
        ms[name] = cuda_ms(fn, 10)
    emit(phase="spectral_stages", batch=int(raw_re.shape[0]), stage_ms=ms,
         shapes={"da_chirp_dft_out": list(spec.shape), "da_angle_dft_out": list(ang.shape),
                 "dbs_angle_dft_out": list(spec3.shape)})


def noise_kernel_own_ops(geo, n_train, cells, batch):
    """Operations the noise kernel's own design spends on ``batch`` maps.

    A tile sorts its region with a bitonic network of ``sort_size`` (a
    compare and an exchange per pair and step), looks every value's rank up
    by bisection, then counts ``passes`` times over every cell's training
    cells (a compare and an add each).
    """
    log2 = geo.sort_size.bit_length() - 1
    tiles = batch * geo.tiles_r * geo.tiles_d
    sort = 2 * (geo.sort_size // 2) * log2 * (log2 + 1) // 2
    ranks = geo.region_r * geo.region_d * log2
    return tiles * (sort + ranks) + geo.passes * 2 * n_train * cells


def time_noise(device, batch=1024):
    """Noise kernel and plain version at [batch, 63, 70]; also ``os_2d`` plus the compare.

    Timed on quantized exponential maps (ties) and on continuous ones: a
    search over ranks takes the same passes on both.  Returns the kernel's
    ``timing`` on the quantized maps; no library call computes the function.
    """
    from mmwave_radar_processing_tpu_torch.ops import cfar
    from mmwave_radar_processing_tpu_torch.ops.kernels.os_cfar import (
        noise_launch_geometry, os_cfar_2d_noise,
    )

    x = quantized_maps(batch, 63, 70, seed=12, device=device)
    gen = torch.Generator(device=device).manual_seed(12)
    continuous = torch.empty_like(x).exponential_(generator=gen)
    n_train, lost_r, lost_d = window_cells(CFAR_PARAMS)
    geometry = dict(num_train=CFAR_PARAMS["num_train"], num_guard=CFAR_PARAMS["num_guard"],
                    k=cfar.os_rank(CFAR_PARAMS["rho"], n_train))
    if not torch.equal(os_cfar_2d_noise(continuous, **geometry),
                       cfar.os_2d_noise_reference(continuous, **geometry)):
        raise RuntimeError("noise kernel != plain version on continuous maps")
    kernel_ms, plain_ms, turns = take_turns(
        lambda: os_cfar_2d_noise(x, **geometry),
        lambda: cfar.os_2d_noise_reference(x, **geometry), 20, 2)
    continuous_ms = cuda_ms(lambda: os_cfar_2d_noise(continuous, **geometry), 20)
    again_ms = cuda_ms(lambda: os_cfar_2d_noise(x, **geometry), 20)
    # one frame, as the detector API launches it: launch to launch, host included
    one_frame_ms = cuda_ms(lambda: os_cfar_2d_noise(x[:1], **geometry), 200)
    cells = batch * (63 - lost_r) * (70 - lost_d)
    geo = noise_launch_geometry(63, 70, geometry["num_train"], geometry["num_guard"], batch)
    # the bound counts the compares a selection needs, not what the design spends
    res = timing(kernel_ms, plain_ms, 4 * (x.numel() + cells),
                 selection_compares(n_train, geometry["k"]) * cells)
    detect_ms = cuda_ms(lambda: x > cfar.os_2d(x, **CFAR_PARAMS)[0], 10)
    # other windows: the kernel's time should follow the training cells
    others = {}
    for name, params in (("other_columns", OTHER_COLUMNS_CFAR_PARAMS),
                         ("second", SECOND_CFAR_PARAMS)):
        other = dict(num_train=params["num_train"], num_guard=params["num_guard"],
                     k=cfar.os_rank(params["rho"], window_cells(params)[0]))
        if not torch.equal(os_cfar_2d_noise(x, **other),
                           cfar.os_2d_noise_reference(x, **other)):
            raise RuntimeError(f"noise kernel != plain version at the {name} window")
        others[name] = {"n_train": window_cells(params)[0], "k": other["k"],
                         "ms": cuda_ms(lambda: os_cfar_2d_noise(x, **other), 20)}
    emit(phase="noise_timing", shape=[batch, 63, 70], turns=turns,
         continuous_ms=continuous_ms, quantized_again_ms=again_ms,
         continuous_over_quantized=continuous_ms / again_ms,
         one_frame_launch_ms=one_frame_ms, os_2d_and_compare_ms=detect_ms,
         n_train=n_train, other_windows=others,
         kernel_own_ops=noise_kernel_own_ops(geo, n_train, cells, batch),
         geometry=geo._asdict(), **res)
    if not abs(continuous_ms / again_ms - 1.0) <= 0.05:
        raise RuntimeError(f"the rank search took {continuous_ms} ms on continuous maps "
                           f"against {again_ms} ms on quantized ones")
    return res


def time_kth(device, sweeps=False):
    """k-th smallest kernel, a sort and ``torch.kthvalue`` at two of the path's shapes.

    ``[168448, 220]``, k = 154: the training cells of 64 flagship maps;
    ``[1024*63*38, 24]``, k = 12: 1024 frames of the ground detector's
    velocity CFAR.  Returns ``{"narrow" | "wide": timing}``, with
    ``torch.kthvalue`` as the library call.  Every time is the device's, taken
    behind a busy device; ``launch_to_launch_ms`` is the kernel timed without
    that.  ``sweeps`` adds the wide shape on rows that hold a denormal and
    ``+inf`` (the kernel's work does not depend on the data), the same bytes
    cut to other widths, and a launch of tens of rows, as the per-frame
    detectors make it.
    """
    from mmwave_radar_processing_tpu_torch.ops import cfar

    res = {}
    for name, (m, w, k) in (("wide", (168448, 220, 154)),
                            ("narrow", (1024 * 63 * 38, 24, 12))):
        gen = torch.Generator(device=device).manual_seed(w)
        x = torch.empty((m, w), device=device).exponential_(generator=gen)
        library = lambda: torch.kthvalue(x, k, dim=-1).values  # noqa: E731
        if not torch.equal(library(), cfar._rank_reduce(x, k)):
            raise RuntimeError(f"torch.kthvalue disagrees with the kernel at {(m, w)}")
        kernel_ms, plain_ms, turns = take_turns(
            lambda: cfar._rank_reduce(x, k),
            lambda: cfar.kth_smallest_reference(x, k), 10, 3, library=library, queued=True)
        # the bound counts the compares a selection needs, not what the kernel spends
        res[name] = timing(kernel_ms, plain_ms, 4 * m * (w + 1),
                           selection_compares(w, k) * m,
                           library_ms=sum(turns["library"]) / 2)
        extra = {"launch_to_launch_ms": cuda_ms(lambda: cfar._rank_reduce(x, k), 10)}
        if sweeps:
            small = x[:63].contiguous()
            extra["launch_of_63_rows_ms"] = cuda_ms(lambda: cfar._rank_reduce(small, k), 200)
        if sweeps and name == "wide":
            widths = extra["other_widths_ms"] = {}
            for width in (8, 16, 32, 33, 48, 64, 65, 100, 128, 129, 192, 300):
                # the same bytes at every width, so that the times compare
                rows = x.numel() // width
                part, rank = x.view(-1)[: rows * width].view(rows, width), (7 * width) // 10
                widths[str(width)] = cuda_ms(lambda: cfar._rank_reduce(part, rank), 5,
                                             queued=True)
            x[:, 0], x[:, 1] = 1e-45, float("inf")  # rows on which no bit is shared
            if not torch.equal(cfar._rank_reduce(x, k), cfar.kth_smallest_reference(x, k)):
                raise RuntimeError("k-th smallest != sort on rows with a denormal and +inf")
            extra["denormal_and_inf_rows_ms"] = cuda_ms(lambda: cfar._rank_reduce(x, k), 10,
                                                        queued=True)
        emit(phase="kth_timing", shape=[m, w], k=k, library="torch.kthvalue",
             turns=turns, timed_behind_a_busy_device=True, **extra, **res[name])
        del x
    return res


def measure_detector_api(cfg, device, frames, n_frames=256):
    """Frames/s of ``PointCloudGenerator.process`` frame by frame: host-limited by nature."""
    from torch.profiler import ProfilerActivity, profile

    from mmwave_radar_processing_tpu_torch import VirtualArrayReformatter

    raw = torch.complex(torch.from_numpy(frames[0]), torch.from_numpy(frames[1])).to(device)
    virt = VirtualArrayReformatter(cfg, device=device).process(raw)
    for name in ("pcg_2d_fft", "pcg_2d_capon", "pcg_ground"):
        pcg = detector_specs(cfg)[name][0](device)
        for i in range(8):
            pcg.process(virt[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_frames):
            pcg.process(virt[i % len(virt)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(len(virt)):
                pcg.process(virt[i])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [(getattr(e, "self_device_time_total", 0.0) or 0.0, e.key, e.count)
                for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))]
        kernel_us = sum(us for us, _, _ in rows)
        emit(phase="detector_api_throughput", path=name, frames=n_frames,
             ms_per_frame=seconds / n_frames * 1e3, frames_per_s=n_frames / seconds,
             limited_by="host", device_busy_share_under_profiler=kernel_us / wall_us,
             device_kernels_per_frame=sum(n for _, _, n in rows) / len(virt),
             device_us_per_frame=kernel_us / len(virt),
             top_kernels=[{"us_per_frame": us / len(virt), "name": key[:60]}
                          for us, key, _ in sorted(rows, reverse=True)[:3]])


def build_kernels():
    """``nvcc`` for each kernel source, all started together; emits each build."""
    from mmwave_radar_processing_tpu_torch.ops.kernels import _build

    names = ("os_cfar_detect", "doppler_az_responses", "beamform_power", "os_rank_select",
             "altitude_track")

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


def kernel_times():
    """The hand-written kernels alone, each beside its plain version, as phase 13 times them."""
    from mmwave_radar_processing_tpu_torch import (
        build_capon_pipeline, build_velocity_pipeline, load_cfg,
    )

    device = torch.device("cuda", 0)
    emit(phase="environment", card=gpu_name_and_power_limit(), torch=torch.__version__,
         cuda=torch.version.cuda)
    cfg = load_cfg(FLAGSHIP_CFG, array_geometry="ods", array_direction="down")
    raw_re, raw_im, _ = bench_inputs(cfg, device)
    time_beamform(build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method="capon",
                                       loading=LOADING, device=device), raw_re, raw_im)
    del raw_re, raw_im
    time_responses(build_velocity_pipeline(cfg, device=device), device)
    time_noise(device)
    time_cfar(device, sweeps=True)
    time_kth(device, sweeps=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    if sys.argv[1:] == ["--kernel-times"]:
        return kernel_times()
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernel-times]")
    from mmwave_radar_processing_tpu_torch import (
        build_capon_pipeline, build_full_pipeline, build_ground_point_cloud_pipeline,
        build_point_cloud_pipeline, build_velocity_pipeline, load_cfg, make_inputs,
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
    ground = build_ground_point_cloud_pipeline(cfg, device=device)
    ground_altitude = build_ground_point_cloud_pipeline(cfg, stop_after="altitude",
                                                        device=device)
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is on: the port runs full float32 only")

    build_kernels()
    max_err = max(check_kernel(device), check_compact_kernel(device))
    resp_err = check_responses(velocity, device)
    launches = check_slice(cfg, gpu_pipeline, device)
    frames = make_inputs(cfg, 32, seed=7)
    vel_launches = check_velocity(cfg, device, frames)
    comb_launches = check_combined(cfg, device, frames)
    bf_err = check_beamform(device)
    bf_launches = check_beamform_slice(cfg, device, frames)
    noise_err = check_noise_kernel(device)
    kth_err = check_kth_kernel(device)
    rank_launches = check_detector_slice(cfg, device, frames)
    check_altitude_track(cfg, device, frames)
    track_err = check_altitude_kernel(device)
    ground_launches = check_ground_slice(cfg, device)
    check_velocity_api(cfg, device)
    check_spectral_slice(cfg, device, frames)
    check_sa_slice(cfg, device)

    raw_re, raw_im, alts = bench_inputs(cfg, device)
    measure_path("pointcloud", lambda: gpu_pipeline(raw_re, raw_im), device)
    measure_path("velocity", lambda: velocity(raw_re, raw_im, alts), device)
    measure_path("velocity_precise", lambda: precise(raw_re, raw_im, alts), device)
    measure_path("combined", lambda: full(raw_re, raw_im, alts), device)
    measure_path("capon", lambda: capon(raw_re, raw_im), device)
    measure_path("bartlett", lambda: bartlett(raw_re, raw_im), device)
    measure_path("beamform_range_dft", lambda: capon.range_dft(raw_re, raw_im), device)
    bf_ms = time_beamform(capon, raw_re, raw_im)
    measure_path("ground", lambda: ground(raw_re, raw_im), device)
    measure_path("ground_altitude", lambda: ground_altitude(raw_re, raw_im), device)
    track_ms = time_altitude_track(ground, raw_re, raw_im)
    measure_ground_stages(ground, raw_re, raw_im)
    measure_spectral_paths(cfg, device, raw_re, raw_im)
    del raw_re, raw_im, alts
    measure_detector_api(cfg, device, frames)
    cfar_ms = time_cfar(device)
    resp_ms = time_responses(velocity, device)
    noise_ms = time_noise(device)
    kth_ms = time_kth(device)

    def response_entry(name, kind, n_launches, err_kind):
        return {"name": f"doppler_az_responses ({name})", "route": "cuda",
                "source": RESP_SOURCE, "replaces": RESP_REPLACES[name],
                "launches": n_launches, "max_abs_err": resp_err[err_kind],
                **resp_ms[kind]}

    def beamform_entry(name, n_launches):
        return {"name": name, "route": "cuda", "source": BEAMFORM_SOURCE,
                "replaces": BEAMFORM_REPLACES[name], "launches": n_launches,
                "max_abs_err": bf_err[name], **bf_ms[name]}

    def rank_entry(name, n_launches, err, times):
        return {"name": name, "route": "cuda", "source": RANK_SOURCE,
                "replaces": RANK_REPLACES[name], "launches": n_launches,
                "max_abs_err": err, **times}

    # one CUDA kernel replaces TPU kernels #4-#6: #4 is the coarse response
    # of the velocity and combined runs, #5 the precise run (its zoom pass
    # and its coarse pass), #6 the same kernel in the paired layout, which
    # the main path does not use: its count is the kernel's over all runs
    all_resp = vel_launches["coarse"] + vel_launches["precise"] + comb_launches[1]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "os_cfar_2d_detect", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches + comb_launches[0],
         # the paths launch its compacting entry, whose times these are; the
         # mask entry's (the detector classes' and the cross-check's) are under "mask_entry"
         "max_abs_err": max_err, **cfar_ms},
        # TPU kernels #2 and #3, over the detector slice's runs; #3 is timed
        # at the ground detector's width (its times at [168448, 220] are
        # under "wide")
        rank_entry("os_cfar_2d_noise", rank_launches["noise"], noise_err, noise_ms),
        rank_entry("kth_smallest", rank_launches["kth"], kth_err,
                   {**kth_ms["narrow"], "wide": kth_ms["wide"]}),
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
        # no TPU kernel's counterpart: the ground scan's lax.scan, one launch a call
        {"name": "altitude_track", "route": "cuda", "source": GROUND_SOURCE,
         "replaces": GROUND_REPLACES, "launches": ground_launches,
         "max_abs_err": track_err, **track_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
