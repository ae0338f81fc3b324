"""The DBS velocity-steered pick: plain version, dispatch, the kernel's wrapper, and the kernel on the card.

``ops.dft.dbs_pick`` forms each kept value of the DBS map as one
point of the angle DFT at the frame's Doppler bin: a CPU tensor takes the
plain version (a gather of the ``A`` antenna values at the bins, their
weighted sum, ``cabs``), a CUDA tensor the hand-written kernel
(``csrc/dbs_pick.cu``) or raises.  Here, on the CPU:

- the plain version equals the formulation it replaced, written out below
  as the oracle: the whole angle DFT of the cube (a ``movedim`` and a K = A
  product with the full ``[A, M]`` matrix), then the gather at
  ``bins * M + ang_near``;
- neither ``DBSPipeline`` nor ``DBSViewerStage`` hands any operator a
  tensor as large as that cube, and neither builds or loads the kernel;
- the wrapper refuses what the kernel does not take before any build.

On the card (the ``cuda`` marker; skipped without CUDA, and free of JAX so
that it runs with ``--noconftest``): the kernel equals the plain version
within ``REL`` of the largest value, one launch a pipeline call, and the
viewer stage's maps equal the cube-and-gather within ``REL``.
"""

import os
import re

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_dbs_pipeline, load_cfg
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import dbs_pick as kernel
from mmwave_radar_processing_tpu_torch.parallel import build_dbs_viewer_stage
from mmwave_radar_processing_tpu_torch.parallel.spectral_pipeline import _matrix

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "6843_RadVel_ods_20Hz.cfg")
#: the pick against its oracle: the largest |difference| over the largest value
REL = 1e-6
#: the RadVel DBS deployment's widths: 63 samples, 70 loops, 64 coarse angles
NS, LOOPS, M = 63, 70, 64
#: per case: frames, antennas, DBS angles, where the bins lie
CASES = {
    "a4_d100": (3, 4, 100, "random"),   # the deployment: more DBS angles than coarse ones
    "a8_d40": (2, 8, 40, "random"),     # fewer DBS angles than coarse ones
    "edges": (2, 4, 100, "edges"),      # every bin 0 or L - 1
    "one_frame": (1, 4, 100, "random"),
}
VELS = [[0.5, 0.2, 0.0], [0.05, 0.02, 0.0], [0.25, 0.0, 0.0], [-0.3, 0.4, 0.1]]


def _spectrum(b, a, ns=NS, loops=LOOPS, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    spec = torch.complex(torch.randn((b, a, ns, loops), generator=g),
                         torch.randn((b, a, ns, loops), generator=g))
    return spec.to(device)


def _inputs(case, seed=0):
    """``(spec [B, A, ns, L], ang [A, M], ang_near [D], bins [B, D])`` of a case."""
    b, a, d, where = CASES[case]
    rng = np.random.default_rng(seed)
    ang = _matrix(a, M, shift=True, window=np.hanning(a))
    ang_near = torch.from_numpy(np.sort(rng.integers(0, M, d)))
    if where == "edges":
        bins = torch.from_numpy(np.where(rng.random((b, d)) < 0.5, 0, LOOPS - 1))
    else:
        bins = torch.from_numpy(rng.integers(0, LOOPS, (b, d)))
    return _spectrum(b, a, seed=seed), ang, ang_near, bins


def cube_and_gather(spec, ang, ang_near, bins):
    """The formulation the pick replaced: the whole ``[B, ns, L, M]`` angle cube, then a gather."""
    b, _, ns, _ = spec.shape
    cube = torch.movedim(spec, 1, -1) @ ang  # [B, ns, L, M]
    cell = bins * ang.shape[1] + ang_near
    return dft.cabs(cube.reshape(b, ns, -1).gather(2, cell[:, None, :].expand(-1, ns, -1)))


def _rel(got, want):
    return float((got.cpu() - want.cpu()).abs().max() / want.cpu().abs().max())


@pytest.fixture
def no_build(monkeypatch):
    """``_build.load`` raises: a test that passes never built or loaded a kernel."""
    def refuse(name):
        raise AssertionError(f"the kernel {name} was built or loaded")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.fixture(scope="module")
def cfg():
    return load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")


def _planes(cfg, frames, seed=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = (frames, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    return (torch.randn(shape, generator=g).to(device),
            torch.randn(shape, generator=g).to(device))


# --------------------------------------------------------------------------- #
# the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_the_plain_pick_equals_the_cube_and_gather(no_build, case):
    spec, ang, ang_near, bins = _inputs(case)
    want = cube_and_gather(spec, ang, ang_near, bins)
    before = kernel.dbs_pick.launches
    got = dft.dbs_pick(spec, ang[:, ang_near], bins)
    assert got.dtype == torch.float32 and got.shape == (spec.shape[0], NS, len(ang_near))
    assert _rel(got, want) <= REL
    assert torch.equal(dft.dbs_pick_reference(spec, ang[:, ang_near], bins), got)
    assert kernel.dbs_pick.launches == before


def _largest_operand(fn):
    """The most elements of any tensor an operator was handed while ``fn`` ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        fn()
    return max(int(np.prod(s)) for e in prof.events() for s in e.input_shapes
               if isinstance(s, list) and s and all(isinstance(v, int) for v in s))


@pytest.mark.parametrize("stage", ["pipeline", "viewer"])
def test_no_stage_forms_the_angle_cube(no_build, cfg, stage):
    frames = len(VELS)
    re_, im_ = _planes(cfg, frames)
    vels = torch.tensor(VELS)
    if stage == "pipeline":
        pipe = build_dbs_pipeline(cfg, device="cpu")
        a, d = len(pipe.rx_idx), pipe.pick_weights.shape[1]
    else:
        pipe = build_dbs_viewer_stage(cfg, num_angle_bins_dbs_enhanced_response=100,
                                      rx_antennas=(0, 3, 4, 7), device="cpu")
        a, d = pipe.dbs_ang.shape
    before = kernel.dbs_pick.launches
    with torch.no_grad():
        largest = _largest_operand(lambda: pipe(re_, im_, vels))
    # the planes and the picked antenna values [B, A, ns, D] are the largest
    cube = frames * NS * LOOPS * M
    assert largest <= max(re_.numel(), frames * a * NS * d) < cube
    assert kernel.dbs_pick.launches == before


def test_the_pipeline_picks_with_the_angle_dfts_columns(cfg):
    """``pick_weights`` is the windowed angle DFT at each DBS angle's nearest coarse angle."""
    pipe = build_dbs_pipeline(cfg, device="cpu")
    ang = _matrix(len(pipe.rx_idx), M, shift=True, window=np.hanning(len(pipe.rx_idx)))
    assert pipe.pick_weights.shape == (4, 100) and pipe.pick_weights.is_contiguous()
    assert torch.equal(pipe.pick_weights, ang[:, pipe.ang_near])
    re_, im_ = _planes(cfg, len(VELS))
    vels = torch.tensor(VELS)
    with torch.no_grad():
        got = pipe(re_, im_, vels)
        (sub,) = pipe._channels(re_, im_, pipe.rx_idx)
        spec = pipe.rng.transpose(0, 1) @ sub @ pipe.dop
        want = cube_and_gather(spec, ang, pipe.ang_near, pipe.doppler_bins(vels))
    fast = torch.tensor([np.hypot(*v[:2]) >= 0.25 for v in VELS])
    assert fast.any() and not fast.all()
    assert _rel(got[fast], want[fast]) <= REL


@pytest.mark.parametrize("case", ["cpu", "meta", "complex128_spec", "float32_weights",
                                  "int32_bins", "strided_spec", "strided_weights",
                                  "strided_bins", "spec_rank", "weights_rows", "bins_frames",
                                  "bins_angles", "too_many_antennas", "no_loops",
                                  "too_wide"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take_before_any_build(no_build, case):
    spec, w, bins = _spectrum(2, 4), torch.ones((4, 10), dtype=torch.complex64), \
        torch.zeros((2, 10), dtype=torch.int64)
    err, match = ValueError, None
    if case == "cpu":
        match = "needs a CUDA tensor"
    elif case == "meta":
        spec, w, bins, match = spec.to("meta"), w.to("meta"), bins.to("meta"), "CUDA tensor"
    elif case == "complex128_spec":
        spec, err, match = spec.to(torch.complex128), TypeError, "complex64 spec"
    elif case == "float32_weights":
        w, err, match = w.real.contiguous(), TypeError, "complex64 weights"
    elif case == "int32_bins":
        bins, err, match = bins.int(), TypeError, "int64 bins"
    elif case == "strided_spec":
        spec, match = _spectrum(2, 4, loops=2 * LOOPS)[..., ::2], "contiguous spec"
    elif case == "strided_weights":
        w, match = torch.ones((10, 4), dtype=torch.complex64).t(), "contiguous weights"
    elif case == "strided_bins":
        bins, match = torch.zeros((2, 20), dtype=torch.int64)[:, ::2], "contiguous bins"
    elif case == "spec_rank":
        spec, match = spec[0], r"spec \[B, A, ns, L\]"
    elif case == "weights_rows":
        w, match = torch.ones((3, 10), dtype=torch.complex64), r"weights \[4, D\]"
    elif case == "bins_frames":
        bins, match = torch.zeros((3, 10), dtype=torch.int64), r"bins \[2, D\]"
    elif case == "bins_angles":
        bins, match = torch.zeros((2, 11), dtype=torch.int64), r"bins \[2, D\]"
    elif case == "too_many_antennas":
        spec, w = _spectrum(2, 17), torch.ones((17, 10), dtype=torch.complex64)
        match = "1 to 16 antennas"
    elif case == "no_loops":
        spec, match = spec[..., :0].contiguous(), "Doppler bins"
    else:  # 16 antennas of 1,800 angles: the weights alone take 225 KB
        spec, match = _spectrum(2, 16, ns=2), "shared memory"
        w, bins = torch.ones((16, 1800), dtype=torch.complex64), \
            torch.zeros((2, 1800), dtype=torch.int64)
    before = kernel.dbs_pick.launches
    with pytest.raises(err, match=match):
        kernel.dbs_pick(spec, w, bins)
    assert kernel.dbs_pick.launches == before


def test_the_dispatch_sends_every_other_device_to_the_kernel(no_build):
    """Off the CPU there is no plain path: the kernel takes complex64 CUDA tensors or raises."""
    spec = _spectrum(1, 4).to("meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        dft.dbs_pick(spec, torch.ones((4, 5), dtype=torch.complex64, device="meta"),
                     torch.zeros((1, 5), dtype=torch.int64, device="meta"))


def test_the_wrappers_limits_are_the_sources():
    source = (_build.CSRC_DIR / "dbs_pick.cu").read_text()
    helpers = (_build.CSRC_DIR / "launch_helpers.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert int(re.search(r"kMaxAntennas = (\d+);", code).group(1)) == kernel.MAX_ANTENNAS
    shared = re.search(r"kMaxSharedBytes = (\d+) \* (\d+);", helpers)
    assert int(shared.group(1)) * int(shared.group(2)) == kernel.MAX_SHARED_BYTES
    # the magnitude is dft.cabs's formula, rounded step by step, not hypot
    assert "sqrtf(" in code and "hypot" not in code and "__fsqrt" not in code
    assert not any("fast" in flag for flag in _build.NVCC_FLAGS)
    lib = _build.library_path("dbs_pick")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("dbs_pick-")
    assert "dbs_pick" in __import__(
        "mmwave_radar_processing_tpu_torch.ops.kernels", fromlist=["wrappers"]).wrappers()


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


#: (frames, antennas, range rows, loops, DBS angles): the deployment, odd
#: widths (8-byte copies, a last tile of fewer rows), the viewer's twelve
#: antennas and the kernel's sixteen
CARD_SHAPES = {"cell": (64, 4, 63, 70, 100), "odd_loops": (3, 4, 17, 33, 7),
               "one_row_tiles": (2, 16, 5, 101, 300), "viewer_a12": (4, 12, 63, 70, 64),
               "one_frame": (1, 8, 63, 70, 40)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_the_kernel_equals_the_plain_pick(cuda, shape):
    b, a, ns, loops, d = CARD_SHAPES[shape]
    spec = _spectrum(b, a, ns=ns, loops=loops, seed=b)
    g = torch.Generator().manual_seed(d)
    w = torch.complex(torch.randn((a, d), generator=g), torch.randn((a, d), generator=g))
    bins = torch.randint(0, loops, (b, d), generator=g)
    bins[0, :2] = torch.tensor([0, loops - 1])[: min(2, d)]
    want = dft.dbs_pick_reference(spec, w, bins)
    before = kernel.dbs_pick.launches
    got = dft.dbs_pick(spec.to(cuda), w.to(cuda), bins.to(cuda))
    torch.cuda.synchronize()
    assert kernel.dbs_pick.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    assert _rel(got, want) <= REL


@pytest.mark.cuda
def test_the_kernel_gives_nan_for_a_bin_off_the_spectrum(cuda):
    spec = _spectrum(2, 4, device=cuda)
    w = torch.ones((4, 6), dtype=torch.complex64, device=cuda)
    bins = torch.tensor([[0, LOOPS - 1, LOOPS, -1, 5, 6], [1, 2, 3, 4, 5, 100]], device=cuda)
    got = dft.dbs_pick(spec, w, bins).cpu()
    bad = torch.tensor([[0, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 1]], dtype=torch.bool)
    assert torch.isnan(got).eq(bad[:, None, :].expand_as(got)).all()


@pytest.mark.cuda
def test_one_launch_a_pipeline_call_and_none_on_the_cpu(cuda, cfg):
    vels = torch.tensor(VELS)
    planes = _planes(cfg, len(VELS))
    gpu = build_dbs_pipeline(cfg, device=cuda)
    cpu = build_dbs_pipeline(cfg, device="cpu")
    before = kernel.dbs_pick.launches
    for k in range(1, 3):
        got = gpu(*(p.to(cuda) for p in planes), vels.to(cuda))
        assert kernel.dbs_pick.launches == before + k
    want = cpu(*planes, vels)
    assert kernel.dbs_pick.launches == before + 2
    same = (gpu.doppler_bins(vels.to(cuda)).cpu() == cpu.doppler_bins(vels))
    assert float(same.float().mean()) > 0.99
    keep = same[:, None, :].expand_as(want)
    assert _rel(torch.where(keep, got.cpu(), 0), torch.where(keep, want, 0)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("a_dbs, rx", [(100, (0, 3, 4, 7)), (64, None)], ids=["a4", "a12"])
def test_the_viewer_stages_maps_are_unchanged(cuda, cfg, a_dbs, rx):
    """The viewer's DBS map on the card against the cube and gather it replaced, on the card."""
    stage = build_dbs_viewer_stage(cfg, num_angle_bins_dbs_enhanced_response=a_dbs,
                                   rx_antennas=rx, device=cuda)
    re_, im_ = _planes(cfg, 8, device=cuda)
    vels = torch.tensor(VELS * 2, device=cuda)
    before = kernel.dbs_pick.launches
    _, got, _ = stage(re_, im_, vels)
    assert kernel.dbs_pick.launches == before + 1
    R = dft.range_dft_channels(torch.complex(re_, im_), stage.sel, stage.rng,
                               num_rx=stage.num_rx, cfgs_per_loop=stage.cpl)
    spec = torch.movedim(R @ stage.dop, 1, -1) @ stage.dbs_ang  # [B, ns, L, A_dbs]
    vel_idx = stage.doppler_bins(vels)
    want = dft.cabs(torch.gather(spec, 2, vel_idx[:, None, None, :].expand(
        -1, spec.shape[1], 1, -1))[:, :, 0])
    assert _rel(got, want) <= REL


@pytest.mark.cuda
def test_the_kernel_rejects_mixed_devices(cuda):
    spec = _spectrum(2, 4, device=cuda)
    with pytest.raises(ValueError, match="weights on cpu"):
        kernel.dbs_pick(spec, torch.ones((4, 5), dtype=torch.complex64),
                        torch.zeros((2, 5), dtype=torch.int64, device=cuda))
