#!/usr/bin/env python3
"""Radar frames/s of the PyTorch/CUDA port on one NVIDIA GPU (the port's twin of ``bench.py``).

    python3 bench_torch.py [--metric pointcloud] [--batch 1024] [--iters 60] [--repeats 3]
    python3 bench_torch.py --verify [--verify-metrics a,b] [--verify-out report.json]
    python3 bench_torch.py --verify-dump port_outputs.npz
    python3 bench_torch.py --metric scaling

Runs one of ``bench.py``'s batched pipelines through the port on the
flagship config (``configs/6843_RadVel_ods_20Hz.cfg``) over ``bench.py``'s
inputs: standard normal planes from seed 0, a second set from seed 1
alternated between calls, and an altitude of 1.2 m where the pipeline takes
one.  ``iters`` back-to-back calls are timed between two CUDA events after a
warm-up; the best of ``repeats`` wins and every repeat is recorded.  Prints
one JSON line with ``bench.py``'s keys (``metric``, ``value`` in frames/s,
``unit``, ``vs_baseline``, ``baseline_frames_per_s``, ``baseline_workload``,
``per_repeat_frames_per_s``), the roofline fields of the metrics that
``utils/roofline.analytic_cost`` models (pointcloud, capon, bartlett)
against the H100 SXM's published peaks, the card's name and power limit
(``nvidia-smi``) and the peak device memory.

``vs_baseline`` divides by the reference numpy loop that
``BASELINE_MEASURED.json`` records, timed on the CPU of another host (read
only here); it is no speed-up over anything measured on the card's host.
capon and bartlett have no reference loop: ``null``.

``--metric scaling`` is the twin of ``bench.py``'s ``run_scaling``: the
weak-scaling tables of ``parallel/scaling.measure_scaling`` at 1, 2 and 4
ranks (NCCL where each rank has a GPU of its own, gloo otherwise), with
``bench.py``'s keys and ``device_oversubscribed``.  Its ``value`` is the
combined pipeline's efficiency with the feed at the largest rank count;
where ranks outnumber the GPUs they share a card, and the number measures
that sharing, not scaling.  It writes no ``vs_baseline``, and no link
projection (``predicted_ici_efficiency_min`` is ``null``): that needs a
stated link (``parallel.scaling.predict_link_efficiency``).

``--verify`` runs the port on the device over ``make_inputs(flagship, 32,
seed=7)`` and holds it to the JAX package's outputs committed in
``tests/oracles/jax_verify_b32_s7.npz`` at the JAX package's gates
(``utils/verify.run_verify``); it prints ``bench.py --verify``'s JSON line
and exits nonzero when a gate fails.  ``--verify-dump`` writes the port's
own outputs in the oracle's format.

The device is ``cuda`` unless ``--device cpu`` is given; without a CUDA
device the run fails.  Imports torch and the port only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.utils import roofline, verify

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_MEASURED_PATH = os.path.join(HERE, "BASELINE_MEASURED.json")
METRICS = ("pointcloud", "velocity", "combined", "ground", "capon", "bartlett")
SCALING_WORLD_SIZES = (1, 2, 4)

#: which reference workload each metric's ``vs_baseline`` divides by
#: (``bench.py``'s table); capon and bartlett have none
BASELINE_WORKLOADS = {
    "pointcloud": "reference VirtualArrayReformatter + "
                  "RangeDopplerDetector2D[os_cfar_2d] + PointCloudGenerator",
    "velocity": "reference VirtualArrayReformatter + "
                "VelocityEstimator.process(adc_cube, altitude) ODS ADC path",
    "combined": "reference VirtualArrayReformatter + PointCloudGenerator"
                "[os_cfar_2d] + VelocityEstimator ADC path per frame",
    "ground": "reference VirtualArrayReformatter + PointCloudGenerator"
              "[range_doppler_ground_detector] (stateful altimeter gate)",
}

METRIC_NAMES = {
    "pointcloud": "radar frames/s/chip (range-Doppler+CFAR+AoA)",
    "velocity": "radar frames/s/chip (fused RadVel ego-velocity)",
    "combined": "radar frames/s/chip (point clouds + ego-velocity)",
    "ground": "radar frames/s/chip (altimeter-gated ground scan)",
    "capon": "radar frames/s/chip (capon covariance beamforming heatmaps)",
    "bartlett": "radar frames/s/chip (bartlett covariance beamforming heatmaps)",
}


def load_measured_baseline(metric: str):
    """``(frames_per_s, workload, where)`` of the reference loop, or ``(None, reason, None)``."""
    if metric not in BASELINE_WORKLOADS:
        return None, "no reference counterpart for this workload", None
    try:
        with open(BASELINE_MEASURED_PATH) as f:
            doc = json.load(f)
        entry = doc["baselines"][metric]
        where = (f"reference numpy on the CPU of host {doc['host']}, "
                 f"{doc['measured_at'][:10]} (BASELINE_MEASURED.json); not a GPU figure")
        return float(entry["frames_per_s"]), entry["workload"], where
    except (OSError, KeyError, ValueError):
        return None, "no measured baseline on record (BASELINE_MEASURED.json)", None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def require_full_fp32() -> None:
    """Raise unless float32 matmuls run in full precision (TF32 off, as the builders set it)."""
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is on: the port runs full float32 only")


def bench_args(cfg, batch: int, seed: int, needs_alt: bool, device):
    """``bench.py``'s inputs: standard normal planes from ``seed``, altitude 1.2 m."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    planes = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                   for _ in range(2))
    return planes + ((torch.full((batch,), 1.2, device=device),) if needs_alt else ())


def time_metric(metric: str, batch: int = 1024, iters: int = 60, repeats: int = 3, *,
                device) -> dict:
    """Frames/s of one metric's pipeline: the best of ``repeats`` runs of ``iters`` calls.

    On CUDA each run is timed by events around the calls and a
    synchronize; on the CPU by the host clock.  Returns ``frames_per_s``,
    ``per_repeat_frames_per_s``, ``ms_per_batch`` (of the best run) and
    ``peak_mem_mb`` (CUDA only, else ``None``).
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = verify.flagship_config()
    fn, needs_alt = verify.build_fn(cfg, metric, device=device)
    require_full_fp32()
    arg_sets = [bench_args(cfg, batch, 0, needs_alt, device),
                bench_args(cfg, batch, 1, needs_alt, device)]
    for args in arg_sets:  # warm-up: kernel builds, cuBLAS plans, the allocator
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    seconds = []
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(*arg_sets[i % 2])
            end.record()
            torch.cuda.synchronize(device)
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(*arg_sets[i % 2])
            seconds.append(time.perf_counter() - t0)
    fps = [iters * batch / s for s in seconds]
    return {"frames_per_s": max(fps), "per_repeat_frames_per_s": fps,
            "ms_per_batch": min(seconds) / iters * 1e3,
            "peak_mem_mb": torch.cuda.max_memory_allocated(device) / 1e6 if cuda else None}


def roofline_fields(metric: str, frames_per_s: float, on_device: bool) -> dict:
    """``bench.py``'s roofline fields from the analytic model, against the H100 SXM's peaks.

    Empty for a metric without a model.  The rates (``tflops``, ``mfu``,
    ``hbm_gbs``, ``hbm_util``, ``bound``) are ``None`` off a CUDA device: a
    CPU run's rate is no device's.
    """
    model = roofline.analytic_cost(metric, verify.flagship_config())
    if model is None:
        return {}
    peak_tflops = roofline.DEFAULT_PEAK_F32_TFLOPS
    peak_gbs = roofline.DEFAULT_PEAK_HBM_GBS
    fields = {"flops_per_frame": round(model.flops_per_frame),
              "bytes_per_frame": round(model.bytes_per_frame),
              "tflops": None, "mfu": None, "hbm_gbs": None, "hbm_util": None, "bound": None,
              "cost_source": "analytic_model", "peak_tflops": peak_tflops,
              "peak_gbs": peak_gbs}
    if on_device:
        tflops = frames_per_s * model.flops_per_frame / 1e12
        gbs = frames_per_s * model.bytes_per_frame / 1e9
        fields.update(tflops=round(tflops, 3), mfu=round(tflops / peak_tflops, 4),
                      hbm_gbs=round(gbs, 2), hbm_util=round(gbs / peak_gbs, 4),
                      bound=roofline.classify_bound(tflops, gbs, peak_tflops=peak_tflops,
                                                    peak_gbs=peak_gbs))
    return fields


def bench_result(metric: str, timing: dict, device) -> dict:
    """The JSON line of a timed metric."""
    device = torch.device(device)
    on_device = device.type == "cuda"
    base_fps, workload, where = load_measured_baseline(metric)
    best = timing["frames_per_s"]
    result = {
        "metric": METRIC_NAMES[metric],
        "value": round(best, 1),
        "unit": "frames/s",
        "vs_baseline": round(best / base_fps, 2) if base_fps else None,
        "baseline_frames_per_s": base_fps,
        "baseline_workload": workload,
        "baseline_measured": where,
        "per_repeat_frames_per_s": [round(f, 1) for f in timing["per_repeat_frames_per_s"]],
        "ms_per_batch": timing["ms_per_batch"],
        "device": verify.device_name(device),
        "card": card_name_and_power_limit() if on_device else None,
        "peak_mem_mb": timing["peak_mem_mb"],
    }
    result.update(roofline_fields(metric, best, on_device))
    return result


def run_scaling(args, device) -> dict:
    """``bench.py``'s ``run_scaling`` line from the port's weak-scaling harness."""
    from mmwave_radar_processing_tpu_torch.parallel.scaling import measure_scaling

    table = measure_scaling(verify.flagship_config(), device_counts=SCALING_WORLD_SIZES,
                            per_device_batch=max(1, min(args.batch, 512) // 16),
                            iters=min(args.iters, 3), repeats=args.repeats, device=device)
    head = table["combined_with_feed"]
    n_max = head["devices"][-1]
    return {
        "metric": f"samples/s scaling efficiency 1->{n_max} ranks "
                  "(combined pipeline incl. input feed, weak scaling)",
        "value": head["efficiency"][-1],
        "unit": "fraction",
        "vs_baseline": None,
        "input_feed_included": head["input_feed_included"][-1],
        "core_oversubscribed": n_max > table["meta"]["physical_cores"],
        "device_oversubscribed": head["device_oversubscribed"][-1],
        "physical_cores": table["meta"]["physical_cores"],
        "predicted_ici_efficiency_min": None,
        "predicted_meets_80pct_bar": None,
        "device": verify.device_name(device),
        "card": card_name_and_power_limit() if device.type == "cuda" else None,
        "table": table,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metric", choices=METRICS + ("scaling",), default="pointcloud")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=60, help="calls per timed run")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed runs; the best wins, every one is recorded")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback from one to the other")
    p.add_argument("--verify", action="store_true",
                   help="hold the port's outputs to the committed JAX oracle; exit 1 on "
                        "disagreement")
    p.add_argument("--verify-metrics", default=None,
                   help="comma list of metrics for --verify and --verify-dump "
                        f"(default: {','.join(verify.VERIFY_METRICS)})")
    p.add_argument("--verify-out", default=None, metavar="JSON",
                   help="write the --verify report here")
    p.add_argument("--verify-dump", default=None, metavar="NPZ",
                   help="write the port's verify outputs (the oracle's format) and exit")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch.py: no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to run on the CPU")
    metrics = (args.verify_metrics.split(",") if args.verify_metrics
               else list(verify.VERIFY_METRICS))

    if args.verify_dump:
        _, inputs = verify.load_oracle()
        verify.dump_oracle(metrics, args.batch, args.verify_dump, device=device,
                           gumbel=inputs["gumbel"])
        print(json.dumps({"verify_dump": args.verify_dump, "metrics": metrics,
                          "device": verify.device_name(device)}))
        return

    if args.verify:
        report = verify.run_verify(metrics, args.batch, device=device,
                                   out_path=args.verify_out)
        worst = min((leaf.get("agree_frac", 1.0) for leaf in report["leaves"]), default=1.0)
        print(json.dumps({
            "metric": "parity vs the committed JAX oracle (min leaf agreement)",
            "value": round(worst, 5),
            "unit": "fraction",
            "vs_baseline": None,
            "ok": report["ok"],
            "device": report["device"],
            "n_leaves": len(report["leaves"]),
            "detail": args.verify_out,
        }))
        sys.exit(0 if report["ok"] else 1)

    if args.metric == "scaling":
        print(json.dumps(run_scaling(args, device)))
        return

    timing = time_metric(args.metric, args.batch, args.iters, args.repeats, device=device)
    print(json.dumps(bench_result(args.metric, timing, device)))


if __name__ == "__main__":
    main()
