#!/usr/bin/env python
"""Write the JAX package's outputs that the port's verify leg is held to.

    python tests/oracles/make_oracles.py [--out tests/oracles/jax_verify_b32_s7.npz]

Runs the JAX package on the CPU over ``make_inputs(flagship, 32, seed=7)``
for each of the port's verify metrics and writes one ``np.savez_compressed``
file, keyed as the JAX package's ``utils/verify.compute_outputs`` keys them
(``pointcloud_f32/points``, ``combined/1/vx``, ``ground/final_altitude``,
``capon/out``), with two inputs beside them: ``seed`` and the velocity
pipeline's RANSAC draws, ``ransac_gumbel`` ``[32, 2, 20, 70]`` (JAX's
``split(PRNGKey(42), B)`` Gumbel draws, which the port takes as ``gumbel=``,
so the card's host needs no JAX).

``pointcloud_f32``, ``velocity``, ``capon`` and ``bartlett`` come from the
JAX package's own ``compute_outputs``.  ``combined`` and ``ground`` there
run the bf16 ``"fast"`` mode, which the port does not have, so they are
built here with ``aoa_precision="exact"``, the full-precision mode of both
(neither has an ``"f32"`` mode; the combined pipeline's per-detection
values accept ``"fast"`` and ``"exact"`` only).

Rerun only when a JAX pipeline's output changes; the port's tests hold a
fresh run to the committed file through ``compare_outputs``.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)  # bench.py, which the JAX verify module imports, sits at the root
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from mmwave_radar_processing_tpu.config import load_cfg  # noqa: E402
from mmwave_radar_processing_tpu.parallel.full_pipeline import build_full_pipeline  # noqa: E402
from mmwave_radar_processing_tpu.parallel.ground_pipeline import (  # noqa: E402
    build_ground_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu.utils import verify as jax_verify  # noqa: E402

OUT = os.path.join(REPO, "tests", "oracles", "jax_verify_b32_s7.npz")
METRICS = ("pointcloud_f32", "velocity", "combined", "ground", "capon", "bartlett")
#: the velocity pipeline's default seed, its RANSAC trials and coarse rows (the chirps a frame)
RANSAC_SEED, RANSAC_TRIALS = 42, 20


def flagship():
    return load_cfg(os.path.join(REPO, "configs", "6843_RadVel_ods_20Hz.cfg"),
                    array_geometry="ods", array_direction="down")


def jax_draws(seed: int, batch: int, n: int, trials: int = RANSAC_TRIALS) -> np.ndarray:
    """The JAX velocity pipeline's RANSAC scores ``[B, 2, trials, n]``, azimuth fit first."""
    out = np.empty((batch, 2, trials, n), np.float32)
    for b, key in enumerate(jax.random.split(jax.random.PRNGKey(seed), batch)):
        for f, fit_key in enumerate(jax.random.split(key)):
            for t, trial_key in enumerate(jax.random.split(fit_key, trials)):
                out[b, f, t] = np.asarray(jax.random.gumbel(trial_key, (n,)))
    return out


def _flatten(metric, res):
    """``compute_outputs``'s naming (``utils/verify.py:154-160``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(res)[0]:
        name = "/".join(getattr(p, "name", None) or str(getattr(p, "idx", p))
                        for p in path) or "out"
        out[f"{metric}/{name}"] = np.asarray(leaf)
    return out


def jax_outputs(metrics=METRICS, batch: int = 32, seed: int = 7) -> dict:
    """The oracle's arrays: each metric's outputs, ``seed``, and the draws where needed."""
    cfg = flagship()
    raw_re, raw_im, altitudes = jax_verify.make_inputs(cfg, batch, seed)
    out = {}
    for metric in metrics:
        if metric == "combined":
            res = build_full_pipeline(cfg, aoa_precision="exact")(raw_re, raw_im, altitudes)
            out.update(_flatten(metric, res))
        elif metric == "ground":
            res = build_ground_point_cloud_pipeline(cfg, aoa_precision="exact")(raw_re, raw_im)
            out.update(_flatten(metric, res))
        else:
            out.update(jax_verify.compute_outputs(cfg, [metric], batch, seed))
    out["seed"] = np.int64(seed)
    if {"velocity", "combined"} & set(metrics):
        out["ransac_gumbel"] = jax_draws(RANSAC_SEED, batch, cfg.frame.loops)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    arrays = jax_outputs()
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays, {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
