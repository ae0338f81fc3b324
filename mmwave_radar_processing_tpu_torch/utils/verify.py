"""The verify leg: seeded inputs, the bench pipelines and the agreement gates (JAX: ``utils/verify.py``).

The port's own copies of the JAX package's verification harness, numpy and
torch only:

- :func:`make_inputs`, bit-equal to the JAX package's from the same seed;
- :func:`build_fn`, the pipeline that ``bench_torch.py`` times for each
  metric, built with ``bench.py``'s constants (kept here, so the bench
  imports them from the package);
- :func:`compute_outputs`, a run of each metric's pipeline flattened to host
  arrays under the JAX package's own key names (``pointcloud_f32/points``,
  ``combined/1/vx``, ``ground/final_altitude``, ``capon/out``);
- :func:`compare_outputs` with JAX's gates, unchanged: compacted point sets
  are scored as sets per frame, their counts within 2, every other leaf
  position by position;
- :func:`run_verify`, the port on a device against the committed JAX oracle
  (``tests/oracles/jax_verify_b32_s7.npz``, written by
  ``tests/oracles/make_oracles.py``), and :func:`dump_oracle`, which writes
  the port's own outputs in the oracle's format.

The port's one precision is full float32, so its point cloud is JAX's
``pointcloud_f32`` metric and is held to its raised gates; JAX's bf16
``pointcloud`` and ``pointcloud_exact`` rows are not ported.  The velocity
pipeline's RANSAC draws cannot be reproduced in torch: the oracle carries
JAX's own draws, and the port takes them as ``gumbel=``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data import (
    PointTarget,
    ground_scene,
    simulate_frames,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_CFG = os.path.join(REPO, "configs", "6843_RadVel_ods_20Hz.cfg")
#: the JAX package's outputs of ``make_inputs(flagship, 32, seed=7)``
ORACLE_PATH = os.path.join(REPO, "tests", "oracles", "jax_verify_b32_s7.npz")
#: the oracle's key of the velocity pipeline's RANSAC draws ``[B, 2, 20, rows]``;
#: keys without a ``/`` are the run's inputs, not its outputs
GUMBEL_KEY = "ransac_gumbel"
SEED_KEY = "seed"
#: the largest batch the verify leg runs, as in the JAX package
MAX_VERIFY_BATCH = 32

#: ``bench.py``'s pipeline constants
CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
AZ_IDXS, EL_IDXS = (0, 3, 4, 7), (9, 8, 5, 4)

#: metrics covered by the verify pass (every batched pipeline of ``bench.py``)
VERIFY_METRICS = ("pointcloud_f32", "velocity", "combined", "ground", "capon",
                  "bartlett")


def flagship_config():
    """The flagship configuration (``configs/6843_RadVel_ods_20Hz.cfg``, ODS, facing down)."""
    return load_cfg(FLAGSHIP_CFG, array_geometry="ods", array_direction="down")


def make_inputs(cfg, batch: int, seed: int = 7):
    """Deterministic simulated down-facing frames.

    Ground cone + nadir return (what the altimeter/velocity paths expect)
    plus 1-3 discrete point targets per frame, so CFAR detections, AoA picks
    and RANSAC fits all exercise their real code paths.

    Returns ``(raw_re, raw_im, altitudes)``: float32 planes
    ``[batch, rx, samples, chirps]`` and float32 ``[batch]`` altitudes.
    """
    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(batch):
        alt = 0.9 + 0.4 * rng.random()
        scene = ground_scene(
            cfg, altitude_m=alt,
            ego_vel=(0.3 * rng.standard_normal(), 0.2 * rng.standard_normal(),
                     0.1 * rng.standard_normal()),
            num_patches=32, rng=rng,
        )
        for _ in range(int(rng.integers(1, 4))):
            scene.targets.append(PointTarget(
                range_m=float(rng.uniform(0.4, 0.9) * cfg.range_max_m),
                azimuth_rad=float(rng.uniform(-0.8, 0.8)),
                elevation_rad=float(rng.uniform(-0.4, 0.4)),
                velocity_m_s=float(rng.uniform(-0.5, 0.5) * cfg.vel_max_m_s),
                rcs=float(rng.uniform(2.0, 8.0)),
            ))
        scenes.append(scene)
    raw = simulate_frames(cfg, scenes, rng=np.random.default_rng(seed + 1))
    raw_re = np.ascontiguousarray(raw.real, np.float32)
    raw_im = np.ascontiguousarray(raw.imag, np.float32)
    altitudes = (0.9 + 0.4 * np.random.default_rng(seed + 2)
                 .random(batch)).astype(np.float32)
    return raw_re, raw_im, altitudes


#: minimum fraction of exactly-agreeing elements for int/bool leaves
MIN_DISCRETE_AGREEMENT = 0.99
#: max |device - oracle| for float leaves
FLOAT_ATOL = 2e-2
#: relative scale: leaves with magnitudes >> 1 (dB maps) use atol * scale
FLOAT_RTOL = 1e-3
#: minimum mean per-frame intersection-over-union for compacted point sets,
#: and the fraction of frames whose detection count must agree within +/-2
MIN_POINTS_IOU = 0.75
MIN_COUNT_NEAR = 0.85
#: raised gates for the full-precision mode: the two runs must agree on
#: essentially every discrete decision
METRIC_POINTS_IOU = {"pointcloud_f32": 0.95}
METRIC_COUNT_NEAR = {"pointcloud_f32": 0.95}


def _point_set_report(o_pts, o_valid, d_pts, d_valid, tol: float) -> dict:
    """Per-frame set-IoU for fixed-capacity ``(points, valid)`` outputs.

    A single borderline CFAR flip (the device's default-precision matmul
    DFTs differ from CPU f32 at ~1e-3 relative, so noise-level threshold
    comparisons legitimately flip) SHIFTS the row-major compaction — every
    later slot then holds a different point, so positional comparison
    reads ~0.4% of flipped decisions as ~40% "disagreement".  The honest
    metric is set overlap: match valid rows within ``tol`` (greedy nearest).
    """
    ious, angle_flips, totals = [], 0, 0
    for f in range(o_pts.shape[0]):
        a = o_pts[f][o_valid[f].astype(bool)]
        b = d_pts[f][d_valid[f].astype(bool)]
        totals += max(len(a), len(b))
        if not len(a) and not len(b):
            ious.append(1.0)
            continue
        if not len(a) or not len(b):
            ious.append(0.0)
            continue
        d2 = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        used = np.zeros(len(b), bool)
        hits = 0
        unmatched_a = []
        for i in np.argsort(d2.min(axis=1)):
            j = int(np.argmin(np.where(used, np.inf, d2[i])))
            if not used[j] and d2[i, j] <= tol:
                used[j] = True
                hits += 1
            else:
                unmatched_a.append(i)
        ious.append(hits / (len(a) + len(b) - hits))
        # decompose the residual: an unmatched pair sharing (range, vel) is
        # the SAME detection cell whose AoA argmax flipped (a discrete
        # decision on a ~1e-3-perturbed spectrum), not a missed detection
        if unmatched_a and (~used).any():
            rv_a = np.stack([np.linalg.norm(a[unmatched_a, :3], axis=1),
                             a[unmatched_a, 3]], axis=1)
            bb = b[~used]
            rv_b = np.stack([np.linalg.norm(bb[:, :3], axis=1),
                             bb[:, 3]], axis=1)
            dd = np.linalg.norm(rv_a[:, None] - rv_b[None, :], axis=-1)
            angle_flips += int(np.sum(dd.min(axis=1) <= tol)) \
                if dd.size else 0
    return {"set_iou_mean": float(np.mean(ious)),
            "set_iou_min": float(np.min(ious)),
            "angle_flip_frac": round(angle_flips / max(totals, 1), 4)}


def compare_outputs(oracle: Dict[str, np.ndarray],
                    device: Dict[str, np.ndarray]) -> dict:
    """Per-leaf agreement report + overall pass/fail.

    Fixed-capacity compacted sets (``*/points`` with a sibling ``*/valid``)
    are scored as per-frame sets (:func:`_point_set_report`); their sibling
    ``*/count`` passes when nearly all frames agree within +/-2 (each
    borderline CFAR flip moves the count by one).  All other leaves compare
    positionally.
    """
    leaves = []
    ok_all = True
    for key in sorted(oracle):
        o, d = oracle[key], device.get(key)
        prefix = key.rsplit("/", 1)[0]
        if (key.endswith("/points") or key.endswith("points")) and \
                f"{prefix}/valid" in oracle and d is not None:
            rep = _point_set_report(o, oracle[f"{prefix}/valid"],
                                    d, device[f"{prefix}/valid"], tol=1e-2)
            gate = METRIC_POINTS_IOU.get(key.split("/", 1)[0],
                                         MIN_POINTS_IOU)
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "set_iou",
                     **rep,
                     "agree_frac": rep["set_iou_mean"],
                     "gate": gate,
                     "ok": rep["set_iou_mean"] >= gate}
            ok_all = ok_all and entry["ok"]
            leaves.append(entry)
            continue
        if key.endswith("/valid") and f"{prefix}/points" in oracle \
                and d is not None:
            # redundant with the set-IoU + count checks: valid is the
            # compaction's "first count slots" mask, so each borderline
            # flip moves exactly one slot — recorded, not gated
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "informational",
                     "agree_frac": float(np.mean(o == d)) if o.size else 1.0,
                     "ok": True}
            leaves.append(entry)
            continue
        if key.endswith("/count") and f"{prefix}/points" in oracle \
                and d is not None:
            near = float(np.mean(np.abs(o.astype(int) - d.astype(int)) <= 2))
            gate = METRIC_COUNT_NEAR.get(key.split("/", 1)[0],
                                         MIN_COUNT_NEAR)
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "count_within_2",
                     "agree_frac": near,
                     "exact_frac": float(np.mean(o == d)),
                     "max_abs_delta": int(np.max(np.abs(
                         o.astype(int) - d.astype(int)))) if o.size else 0,
                     "gate": gate,
                     "ok": near >= gate}
            ok_all = ok_all and entry["ok"]
            leaves.append(entry)
            continue
        entry = {"leaf": key, "shape": list(o.shape), "dtype": str(o.dtype)}
        if d is None:
            entry.update(status="missing_on_device", ok=False)
            ok_all = False
            leaves.append(entry)
            continue
        if np.issubdtype(o.dtype, np.floating):
            delta = np.abs(o.astype(np.float64) - d.astype(np.float64))
            scale = max(1.0, float(np.max(np.abs(o))) if o.size else 1.0)
            tol = FLOAT_ATOL + FLOAT_RTOL * scale
            frac = float(np.mean(delta <= tol)) if o.size else 1.0
            entry.update(
                max_abs_delta=float(delta.max()) if o.size else 0.0,
                p999_abs_delta=float(np.quantile(delta, 0.999)) if o.size
                else 0.0,
                tol=tol,
                agree_frac=frac,
                ok=frac >= MIN_DISCRETE_AGREEMENT,
            )
        else:
            agree = float(np.mean(o == d)) if o.size else 1.0
            entry.update(
                agree_frac=agree,
                mismatches=int(np.sum(o != d)),
                ok=agree >= MIN_DISCRETE_AGREEMENT,
            )
        ok_all = ok_all and entry["ok"]
        leaves.append(entry)
    return {"ok": ok_all, "leaves": leaves}


def build_fn(cfg, metric: str, *, device):
    """``(pipeline, needs_altitude)`` of a bench or verify metric on ``device``.

    ``pointcloud`` and ``pointcloud_f32`` are the same pipeline (the port's
    one precision).  The pipelines take ``(raw_re, raw_im)``, and
    ``(raw_re, raw_im, altitude)`` where ``needs_altitude``.
    """
    from mmwave_radar_processing_tpu_torch.parallel import (
        build_capon_pipeline,
        build_full_pipeline,
        build_ground_point_cloud_pipeline,
        build_point_cloud_pipeline,
        build_velocity_pipeline,
    )

    if metric in ("pointcloud", "pointcloud_f32"):
        return build_point_cloud_pipeline(
            cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
            cfar_params=CFAR_PARAMS, max_dets=128, device=device), False
    if metric == "velocity":
        return build_velocity_pipeline(cfg, device=device), True
    if metric == "combined":
        return build_full_pipeline(cfg, device=device), True
    if metric == "ground":
        return build_ground_point_cloud_pipeline(cfg, device=device), False
    if metric in ("capon", "bartlett"):
        return build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method=metric,
                                    device=device), False
    raise ValueError(f"unknown verify metric {metric!r}")


def named_leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for each leaf, named as ``jax.tree_util.tree_flatten_with_path``.

    A NamedTuple field by its name, a tuple element by its index, joined
    with ``/``; a bare tensor is ``out``.
    """
    if isinstance(tree, torch.Tensor):
        yield "/".join(path) or "out", tree
    elif hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from named_leaves(getattr(tree, field), path + (field,))
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from named_leaves(item, path + (str(i),))
    else:
        raise TypeError(f"unexpected output leaf {type(tree).__name__} at {path}")


def compute_outputs(cfg, metrics: Sequence[str], batch: int, seed: int = 7, *,
                    device, gumbel: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Run each metric's pipeline on ``make_inputs(cfg, batch, seed)``; host arrays by name.

    Keys are ``{metric}/{leaf}``, the JAX package's names for the same
    outputs.  ``gumbel`` (``[batch, 2, 20, rows]`` float32) is the velocity
    RANSAC's draws for ``velocity`` and ``combined``; without it the port
    draws its own, and the velocity leaves cannot equal JAX's.
    """
    device = torch.device(device)
    planes = make_inputs(cfg, batch, seed)
    raw_re, raw_im, altitudes = (torch.from_numpy(a).to(device) for a in planes)
    scores = None if gumbel is None else torch.from_numpy(np.asarray(gumbel)).to(device)
    out: Dict[str, np.ndarray] = {}
    for metric in metrics:
        fn, needs_alt = build_fn(cfg, metric, device=device)
        with torch.no_grad():
            res = (fn(raw_re, raw_im, altitudes, gumbel=scores) if needs_alt
                   else fn(raw_re, raw_im))
        for name, leaf in named_leaves(res):
            out[f"{metric}/{name}"] = leaf.cpu().numpy()
    return out


def load_oracle(path: str = ORACLE_PATH) -> Tuple[Dict[str, np.ndarray], dict]:
    """``(outputs, inputs)`` of an oracle file: keys with a ``/`` are outputs.

    ``inputs`` holds ``seed`` and, where the file has them, the RANSAC
    draws under ``gumbel``.
    """
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    outputs = {k: v for k, v in arrays.items() if "/" in k}
    inputs = {"seed": int(arrays[SEED_KEY]), "gumbel": arrays.get(GUMBEL_KEY)}
    return outputs, inputs


def device_name(device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` for the CPU."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_verify(metrics: Sequence[str], batch: int, seed: int = 7, *, device,
               oracle_path: str = ORACLE_PATH, out_path: Optional[str] = None) -> dict:
    """The port on ``device`` against the committed JAX oracle, at JAX's gates.

    Clamps ``batch`` to 32, as the JAX package does; the oracle must hold
    the same batch, seed and metrics.  The velocity and combined runs take
    the oracle's RANSAC draws.  Returns the JAX package's report (per-leaf
    entries, ``ok``, batch, seed, metrics, device, time, criteria) and
    writes it to ``out_path`` when given.
    """
    batch = min(batch, MAX_VERIFY_BATCH)
    outputs, inputs = load_oracle(oracle_path)
    if inputs["seed"] != seed:
        raise ValueError(f"the oracle {oracle_path} was written for seed {inputs['seed']}, "
                         f"not {seed}")
    oracle = {k: v for k, v in outputs.items() if k.split("/", 1)[0] in metrics}
    missing = sorted(set(metrics) - {k.split("/", 1)[0] for k in oracle})
    if missing:
        raise ValueError(f"the oracle {oracle_path} has no outputs for {missing}")
    held = {v.shape[0] for k, v in oracle.items() if v.ndim}
    if held != {batch}:
        raise ValueError(f"the oracle {oracle_path} holds batch {sorted(held)}, not {batch}")
    gumbel = inputs["gumbel"]
    if gumbel is None and {"velocity", "combined"} & set(metrics):
        raise ValueError(f"the oracle {oracle_path} has no RANSAC draws ({GUMBEL_KEY})")
    got = compute_outputs(flagship_config(), metrics, batch, seed, device=device,
                          gumbel=gumbel)
    report = compare_outputs(oracle, got)
    report.update(
        batch=batch,
        seed=seed,
        metrics=list(metrics),
        device=device_name(device),
        oracle=os.path.relpath(os.path.abspath(oracle_path), REPO),
        measured_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
        criteria=dict(min_discrete_agreement=MIN_DISCRETE_AGREEMENT,
                      float_atol=FLOAT_ATOL, float_rtol=FLOAT_RTOL,
                      min_points_set_iou=MIN_POINTS_IOU,
                      min_count_within_2=MIN_COUNT_NEAR),
    )
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def dump_oracle(metrics: Sequence[str], batch: int, out_npz: str, seed: int = 7, *,
                device, gumbel: Optional[np.ndarray] = None) -> None:
    """Write the port's outputs on ``device`` in the oracle's format (``np.savez_compressed``).

    The draws, when given, are written beside them, so the file can stand
    as an oracle itself.
    """
    batch = min(batch, MAX_VERIFY_BATCH)
    arrays = compute_outputs(flagship_config(), metrics, batch, seed, device=device,
                             gumbel=gumbel)
    arrays[SEED_KEY] = np.int64(seed)
    if gumbel is not None:
        arrays[GUMBEL_KEY] = np.asarray(gumbel, np.float32)
    np.savez_compressed(out_npz, **arrays)
