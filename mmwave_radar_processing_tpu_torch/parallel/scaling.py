"""Samples/s against ranks: the weak-scaling harness (JAX: ``parallel/scaling.py``).

Runs the sharded pipelines on 1, 2, 4, ... ranks (:func:`.launch.spawn`)
with a constant per-rank batch and reports throughput and parallel
efficiency ``eff(n) = (samples_per_s(n) / n) / samples_per_s(1)``:

- ``combined``: the serving pipeline (point clouds and ego-velocity),
  frame-parallel over ``data`` (:func:`.pipeline.shard_pipeline`); no
  collective on the hot path;
- ``combined_with_feed``: the same, fed by each rank's own NPY loads
  (:func:`.input_feed.sharded_recording_feed`);
- ``halo_cfar_2d``: range-row-sharded counting OS-CFAR detection whose shard
  boundaries exchange train-plus-guard halos each step;
- ``capon_snapshot``: Capon heatmaps with the snapshot axis sharded and one
  all-reduce of the partial covariances;
- ``ppermute_halo_rows`` and ``psum_beamform_partials``: the bare
  collectives alone at the payloads the pipelines move (n >= 2).

Each rank times its own calls: a warm-up, then ``repeats`` runs of
``iters`` calls, each run started behind a barrier and ended by a device
synchronise; a rank's figure is the median of its runs, and a step's time
is the slowest rank's.  No bar is set on any single timing.

``device_oversubscribed`` marks rows with more ranks than devices (GPUs on
``cuda``, cores on the CPU): ranks that share one GPU measure its
oversubscription, not a link between devices, so such a row is no scaling
figure.  :func:`predict_link_efficiency` projects the efficiency of a
real multi-GPU link from the one-rank figures and a stated bandwidth and
latency.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids

#: the halo CFAR's per-rank map and window (JAX ``scaling.py:176-183``)
HALO_ROWS_PER_DEV, HALO_COLS = 64, 128
HALO_PARAMS = dict(num_train=(4, 3), num_guard=(2, 1), rho=0.7, alpha=4.0)
#: rows each neighbour sends: train + guard of the row axis.  The JAX
#: harness records 8 (``scaling.py:176,190-193``); it sends 6.
HALO_SENT_ROWS = HALO_PARAMS["num_train"][0] + HALO_PARAMS["num_guard"][0]
#: the snapshot-sharded Capon's bins, antennas, snapshots a rank and angles
CAPON_BINS, CAPON_ANTENNAS, CAPON_SNAPS_PER_DEV, CAPON_ANGLES = 64, 12, 32, 64
#: the beamformer's partial sums ``[ns, A]`` that the bare all-reduce moves
PSUM_SHAPE = (63, 64)
COMBINED_CFAR = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
FEED_UNIQUE_FRAMES = 16


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, iters: int, repeats: int, device: torch.device) -> float:
    """Median over ``repeats`` runs of the seconds a call of ``fn`` takes on this rank."""
    fn()
    synchronize(device)
    times = []
    for _ in range(max(1, repeats)):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        synchronize(device)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def frame_paths(root: str, n: int) -> List[str]:
    """The NPY files of :func:`write_feed_frames`, in order."""
    return [os.path.join(root, f"frame_{i:05d}.npy") for i in range(n)]


def write_feed_frames(root: str, frame_shape, n: int = FEED_UNIQUE_FRAMES,
                      seed: int = 0) -> List[str]:
    """``n`` complex64 NPY frames of ``frame_shape`` under ``root``, from ``seed``; their paths."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = frame_paths(root, n)
    for path in paths:
        np.save(path, (rng.standard_normal(frame_shape, np.float32)
                       + 1j * rng.standard_normal(frame_shape, np.float32)).astype(np.complex64))
    return paths


def scaling_rank(device: torch.device, cfg: RadarConfig, per_device_batch: int, iters: int,
                 repeats: int, frame_paths: Sequence[str]) -> Dict[str, float]:
    """One rank's seconds a step of every table (the body :func:`measure_scaling` spawns)."""
    from mmwave_radar_processing_tpu_torch.ops import beamform as bf
    from mmwave_radar_processing_tpu_torch.parallel.collectives import (
        from_left, from_right, psum,
    )
    from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import build_full_pipeline
    from mmwave_radar_processing_tpu_torch.parallel.halo_cfar import (
        os_cfar_2d_detect_row_sharded,
    )
    from mmwave_radar_processing_tpu_torch.parallel.input_feed import sharded_recording_feed
    from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from mmwave_radar_processing_tpu_torch.parallel.pipeline import shard_pipeline
    from mmwave_radar_processing_tpu_torch.parallel.sharded_beamform import (
        build_snapshot_sharded_capon,
    )

    world = dist.get_world_size()
    rng = np.random.default_rng(1000 + dist.get_rank())
    out: Dict[str, float] = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    # ---- combined serving pipeline, frame-parallel, inputs on the device
    mesh = make_mesh({"data": world}, device_type=device.type)
    b = per_device_batch * world
    sharded = shard_pipeline(build_full_pipeline(cfg, cfar_params=COMBINED_CFAR, max_dets=64,
                                                 device=device), mesh)
    frame_shape = (cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    re, im = (tensor(rng.standard_normal((per_device_batch,) + frame_shape)) for _ in range(2))
    alt = torch.full((per_device_batch,), 1.2, device=device)
    out["combined"] = time_calls(lambda: sharded(re, im, alt, global_batch=b),
                                 iters, repeats, device)

    # ---- the same pipeline fed by this rank's own NPY loads
    n_batches = iters + 1
    paths = [frame_paths[k % len(frame_paths)] for k in range(b * n_batches)]

    def feed_run():
        for args in sharded_recording_feed(mesh, paths, frame_shape, global_batch=b,
                                           device=device):
            sharded(*args, global_batch=b)

    out["combined_with_feed"] = time_calls(feed_run, 1, repeats, device) / n_batches

    # ---- halo-exchange CFAR, and its exchange alone
    x = tensor(rng.exponential(1.0, (HALO_ROWS_PER_DEV, HALO_COLS)))
    cfar = os_cfar_2d_detect_row_sharded(mesh, axis="data", **HALO_PARAMS)
    out["halo_cfar_2d"] = time_calls(lambda: cfar(x), iters, repeats, device)
    group = mesh.get_group("data")
    if world >= 2:
        out["ppermute_halo_rows"] = time_calls(
            lambda: (from_left(x, HALO_SENT_ROWS, group), from_right(x, HALO_SENT_ROWS, group)),
            iters, repeats, device)
        part = tensor(rng.standard_normal(PSUM_SHAPE))
        out["psum_beamform_partials"] = time_calls(lambda: psum(part, group), iters, repeats,
                                                   device)

    # ---- snapshot-sharded Capon (one all-reduce of partial covariances)
    model_mesh = make_mesh({"model": world}, device_type=device.type)
    shape = (CAPON_BINS, CAPON_ANTENNAS, CAPON_SNAPS_PER_DEV)
    snaps = torch.complex(tensor(rng.standard_normal(shape)), tensor(rng.standard_normal(shape)))
    steering = bf.steering_ula(grids.phase_shift_bins(CAPON_ANGLES), CAPON_ANTENNAS).to(device)
    capon = build_snapshot_sharded_capon(model_mesh, loading=1e-2, axis="model")
    out["capon_snapshot"] = time_calls(lambda: capon(snaps, steering), iters, repeats, device)
    return out


def device_capacity(device) -> int:
    """Devices the ranks may have to themselves: GPUs on ``cuda``, cores on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def scaling_table(per_n: Dict[int, tuple], *, per_device_batch: int, device) -> Dict:
    """The tables of :func:`measure_scaling` from ``{n: (backend, [each rank's seconds])}``."""
    capacity = device_capacity(device)
    results: Dict[str, Dict] = {}
    durations: Dict = {}

    def record(name, n, samples, dt, **extra):
        entry = results.setdefault(name, {"devices": [], "samples_per_s": [], "efficiency": [],
                                          "device_oversubscribed": [], "seconds_per_step": []})
        sps = samples / dt
        entry["devices"].append(n)
        entry["seconds_per_step"].append(dt)
        entry["samples_per_s"].append(sps)
        base = entry["samples_per_s"][0] / entry["devices"][0]
        entry["efficiency"].append((sps / n) / base)
        entry["device_oversubscribed"].append(n > capacity)
        for k, v in extra.items():
            entry.setdefault(k, []).append(v)
        durations[(name, n)] = dt

    backends = {}
    for n in sorted(per_n):
        backend, ranks = per_n[n]
        backends[n] = backend
        step = {k: max(r[k] for r in ranks) for k in ranks[0]}
        b = per_device_batch * n
        record("combined", n, b, step["combined"], input_feed_included=False)
        record("combined_with_feed", n, b, step["combined_with_feed"],
               input_feed_included=True)
        record("halo_cfar_2d", n, HALO_ROWS_PER_DEV * n * HALO_COLS, step["halo_cfar_2d"])
        if n >= 2:
            record("ppermute_halo_rows", n, n * 2 * HALO_SENT_ROWS * HALO_COLS,
                   step["ppermute_halo_rows"])
            record("psum_beamform_partials", n, n * PSUM_SHAPE[0] * PSUM_SHAPE[1],
                   step["psum_beamform_partials"])
        record("capon_snapshot", n, CAPON_BINS * CAPON_SNAPS_PER_DEV * n, step["capon_snapshot"])
    results["halo_cfar_2d"]["samples_per_step_n1"] = HALO_ROWS_PER_DEV * HALO_COLS
    # the rows sent to both neighbours, float32
    results["halo_cfar_2d"]["halo_bytes_per_dev"] = 2 * HALO_SENT_ROWS * HALO_COLS * 4
    results["capon_snapshot"]["samples_per_step_n1"] = CAPON_BINS * CAPON_SNAPS_PER_DEV
    # the partial covariance [bins, A, A], complex64
    results["capon_snapshot"]["psum_bytes_per_dev"] = CAPON_BINS * CAPON_ANTENNAS ** 2 * 8

    for pipe, coll in (("halo_cfar_2d", "ppermute_halo_rows"),
                       ("capon_snapshot", "psum_beamform_partials")):
        entry = results[pipe]
        shares = []
        for n in entry["devices"]:
            tp, tc = durations.get((pipe, n)), durations.get((coll, n))
            shares.append(tc / tp if tp and tc else 0.0)
        entry["collective_share"] = shares

    device = torch.device(device)
    results["meta"] = {
        "physical_cores": os.cpu_count() or 1,
        "platform": device.type,
        "device_name": (torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"),
        "device_count": capacity if device.type == "cuda" else 0,
        "per_device_batch": per_device_batch,
        "backends": backends,
        "note": ("device_oversubscribed rows have more ranks than devices and measure "
                 "their sharing, not a link; collective_share is the bare collective's "
                 "time over the pipeline step at the same payload and rank count"),
    }
    return results


def measure_scaling(cfg: RadarConfig, *, device_counts: Sequence[int] = (1, 2, 4),
                    per_device_batch: int = 64, iters: int = 5, repeats: int = 3, device,
                    timeout: float = 900.0) -> Dict:
    """Weak-scaling tables of the sharded pipelines, one spawn of ranks a count.

    Returns ``{table: {"devices", "samples_per_s", "efficiency",
    "device_oversubscribed", ...}, "meta": ...}`` with JAX's honesty fields
    (``input_feed_included``, ``collective_share``,
    ``samples_per_step_n1``, ``halo_bytes_per_dev``, ``psum_bytes_per_dev``).
    Each count runs on :func:`.launch.default_backend`'s choice.
    :func:`predict_link_efficiency` projects a table onto a stated link.
    """
    from mmwave_radar_processing_tpu_torch.parallel.launch import default_backend, spawn

    frame_shape = (cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    per_n = {}
    with tempfile.TemporaryDirectory(prefix="mrp_scaling_") as root:
        paths = write_feed_frames(root, frame_shape)
        for n in device_counts:
            chosen = default_backend(n, device)
            per_n[n] = (chosen, spawn(scaling_rank, n, backend=chosen, device=device,
                                      args=(cfg, per_device_batch, iters, repeats, paths),
                                      timeout=timeout))
    return scaling_table(per_n, per_device_batch=per_device_batch, device=device)


def predict_link_efficiency(results: Dict, *, device_counts: Sequence[int], link_bw_gbs: float,
                            link_latency_us: float) -> Dict:
    """Efficiency on ``n`` devices joined by a link of the given bandwidth and latency.

    ``eff_pred(n) = t_comp / (t_comp + t_feed + t_coll(n))`` for each
    pipeline, from the one-rank figures that :func:`measure_scaling`
    records beside its timings, and the collective models of the JAX
    package's ``predict_ici_efficiency``:

    - neighbour exchange (CFAR halo): ``t = bytes / bw + lat``, independent
      of ``n`` under weak scaling;
    - all-reduce (covariance partials), ring:
      ``t = 2 * bytes * (n-1)/n / bw + 2 * log2(n) * lat``;
    - frame-parallel ``combined``: no collective; the measured feed share.

    A prediction to be tested by a run on that many devices, never a
    measurement.
    """
    bw, lat = link_bw_gbs * 1e9, link_latency_us * 1e-6
    h = results.get("halo_cfar_2d") or {}
    cs = results.get("capon_snapshot") or {}
    halo_bytes, psum_bytes = h.get("halo_bytes_per_dev"), cs.get("psum_bytes_per_dev")
    pipelines = {}

    c, cf = results.get("combined"), results.get("combined_with_feed")
    if c and cf:
        feed_share = max(0.0, c["samples_per_s"][0] / cf["samples_per_s"][0] - 1.0)
        pipelines["combined_with_feed"] = {
            "model": "frame-parallel, no hot-path collectives; eff = 1/(1+feed_share)",
            "measured_feed_share_n1": feed_share,
            "eff_pred": {int(n): 1.0 / (1.0 + feed_share) for n in device_counts},
        }
    if h.get("samples_per_s") and h.get("samples_per_step_n1") and halo_bytes:
        t_comp = h["samples_per_step_n1"] / h["samples_per_s"][0]
        t_coll = halo_bytes / bw + lat
        pipelines["halo_cfar_2d"] = {
            "model": "eff = t_comp / (t_comp + bytes/bw + lat)",
            "t_comp_us_n1": t_comp * 1e6, "t_coll_us_pred": t_coll * 1e6,
            "halo_bytes_per_dev": halo_bytes,
            "eff_pred": {int(n): 1.0 if n == 1 else t_comp / (t_comp + t_coll)
                         for n in device_counts},
        }
    if cs.get("samples_per_s") and cs.get("samples_per_step_n1") and psum_bytes:
        t_comp = cs["samples_per_step_n1"] / cs["samples_per_s"][0]
        rows = {}
        for n in device_counts:
            t_coll = 0.0 if n == 1 else (2.0 * psum_bytes * (n - 1) / n / bw
                                         + 2.0 * np.log2(n) * lat)
            rows[int(n)] = t_comp / (t_comp + t_coll)
        pipelines["capon_snapshot"] = {
            "model": "eff = t_comp / (t_comp + 2*bytes*(n-1)/n/bw + 2*log2(n)*lat)",
            "t_comp_us_n1": t_comp * 1e6, "psum_bytes_per_dev": psum_bytes, "eff_pred": rows,
        }
    preds = [min(p["eff_pred"].values()) for p in pipelines.values()]
    return {
        "assumptions": {"link_bw_gbs": link_bw_gbs, "link_latency_us": link_latency_us},
        "pipelines": pipelines,
        "min_predicted_efficiency": min(preds) if preds else None,
        "meets_80pct_bar": bool(preds and min(preds) >= 0.80),
    }
