"""The angle head: plain version, dispatch, the kernel's wrapper, and the kernel on the card.

``parallel/point_stages.AngleHead`` turns detection slots into FLU points.
A CPU tensor takes the plain version (``AngleHead.plain``: a gather of every
slot's range rows, the Doppler contraction, the angle DFTs and their argmax,
the points, then the mask), a CUDA tensor the hand-written kernel
(``csrc/aoa_head.cu``), which reads only the filled slots, or raises.  Here,
on the CPU:

- the head gives exactly the points of the composition it has always run,
  written out below as the oracle, and builds or loads no kernel;
- the wrapper refuses what the kernel does not take before any build, and
  its limits are the source's.

On the card (the ``cuda`` marker; skipped without CUDA, and free of JAX so
that it runs with ``--noconftest``): the kernel against the plain version on
the same CUDA tensors at every width the configurations use, with empty
subsets, empty frames and flags that are no prefix; points within
``POINT_ATOL`` and velocities equal wherever neither angle spectrum has a
near-tie (top two powers within ``TIE_REL``: there the kernel's Doppler sum,
added in another order than cuBLAS's, may pick the other bin); an exact tie
goes to the lower bin; invalid slots exactly 0; one launch a head call in
each of the head's three callers.
"""

import os
import re

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    build_ground_point_cloud_pipeline, build_point_cloud_pipeline, load_cfg,
)
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import aoa_head as kernel
from mmwave_radar_processing_tpu_torch.parallel import build_viewer_payload_pipeline
from mmwave_radar_processing_tpu_torch.parallel.point_stages import AngleHead, antenna_union
from mmwave_radar_processing_tpu_torch.processors.point_cloud import spherical_to_cartesian_flu

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "6843_RadVel_ods_20Hz.cfg")
AZ, EL = (0, 3, 4, 7), (9, 8, 5, 4)
HEAD_KW = dict(num_angle_bins=64, shift_az_resp=True, shift_el_resp=False)
#: kernel against plain version, where the angles agree: cosf/sinf against
#: PyTorch's elementwise cos/sin, a few float32 ulps of a point within 3 m
POINT_ATOL = 1e-6
#: a near-tie: the two largest powers of a slot's angle spectrum this close
#: (relative); the Doppler sums of the two versions differ by ~1e-7
TIE_REL = 1e-4


@pytest.fixture(scope="module")
def cfg():
    return load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")


def _cube(frames, channels, rows, loops, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = (frames, channels, rows, loops)
    return torch.complex(torch.randn(shape, generator=g),
                         torch.randn(shape, generator=g)).to(device)


def _slots(frames, slots, rows, loops, fill="prefix", seed=1):
    """``(r_i, v_i, valid)`` int64, int64, bool ``[frames, slots]``: random bins, flags by ``fill``."""
    g = torch.Generator().manual_seed(seed)
    r_i = torch.randint(0, rows, (frames, slots), generator=g)
    v_i = torch.randint(0, loops, (frames, slots), generator=g)
    if fill == "prefix":  # the compaction's layout: a frame's detections first
        counts = torch.randint(0, slots + 1, (frames, 1), generator=g)
        valid = torch.arange(slots).expand(frames, slots) < counts
    elif fill == "scattered":  # no prefix: any slot may be filled
        valid = torch.rand((frames, slots), generator=g) < 0.3
    else:  # every slot filled
        valid = torch.ones((frames, slots), dtype=torch.bool)
    if frames > 1:
        valid[1] = False  # a frame with no detection
    return r_i, v_i, valid


def composed(head, R, dop, r_i, v_i, valid):
    """The composition the head has always run: the oracle of its plain version."""
    az = el = torch.zeros(r_i.shape, dtype=torch.float32)
    vals = dft.rd_values(R, dop, r_i, v_i)
    if head.has_az:
        az = dft.aoa_peak_angles(vals, head.az_pos, head.az_dft, head.angle_bins)
    if head.has_el:
        el = dft.aoa_peak_angles(vals, head.el_pos, head.el_dft, head.angle_bins)
    ranges = r_i.to(torch.float32) * head.range_res
    vels = head.vel0 + v_i.to(torch.float32) * head.vel_res
    return torch.where(valid[..., None], spherical_to_cartesian_flu(ranges, az, el, vels), 0.0)


@pytest.fixture
def no_build(monkeypatch):
    """``_build.load`` raises: a test that passes never built or loaded a kernel."""
    def refuse(name):
        raise AssertionError(f"the kernel {name} was built or loaded")

    monkeypatch.setattr(_build, "load", refuse)


# --------------------------------------------------------------------------- #
# the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fill", ["prefix", "scattered", "full"])
def test_the_plain_head_gives_the_composed_points_on_the_union(no_build, cfg, fill):
    layout = antenna_union(AZ, EL, reformat_input=True, num_rx=cfg.num_rx_antennas)
    head = AngleHead(cfg, az_pos=layout.az_pos, el_pos=layout.el_pos, **HEAD_KW)
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    _, dop = (dft.to_matrix(f) for f in dft.range_doppler_factors(ns, loops))
    R = _cube(3, len(layout.chans), ns, loops)[:, layout.aoa_start:]
    r_i, v_i, valid = _slots(3, 40, ns, loops, fill)
    before = kernel.aoa_head.launches
    got = head(R, dop, r_i, v_i, valid)
    assert torch.equal(got, composed(head, R, dop, r_i, v_i, valid))
    assert torch.equal(head.plain(R, dop, r_i, v_i, valid), got)
    assert got.dtype == torch.float32 and got.shape == (3, 40, 4)
    assert not got[~valid].any() and got[valid][:, 0].abs().sum() > 0
    assert kernel.aoa_head.launches == before


def test_the_channel_layout_indexes_the_union():
    got = kernel.channel_layout((0, 3, 4, 7), (9, 8, 5, 4))
    assert got.channels == (0, 3, 4, 5, 7, 8, 9)
    assert [got.channels[i] for i in got.az] == [0, 3, 4, 7]
    assert [got.channels[i] for i in got.el] == [9, 8, 5, 4]
    assert kernel.channel_layout((), ()) == ((), (), ())
    assert kernel.channel_layout((2,), ()) == ((2,), (0,), ())


def _wrapper_inputs(frames=2, channels=7, slots=10, bins=64):
    R = _cube(frames, channels, 5, 8)
    return dict(R=R, dop=torch.ones((8, 8), dtype=torch.complex64),
                r_idx=torch.zeros((frames, slots), dtype=torch.int64),
                v_idx=torch.zeros((frames, slots), dtype=torch.int64),
                valid=torch.ones((frames, slots), dtype=torch.bool),
                az_pos=(0, 1, 2, 3), el_pos=(6, 5, 2, 1),
                az_dft=torch.ones((4, bins), dtype=torch.complex64),
                el_dft=torch.ones((4, bins), dtype=torch.complex64),
                angle_bins=torch.zeros(bins), range_res=0.1, vel0=-1.0, vel_res=0.1)


#: case -> (change to the inputs, error, message)
REFUSALS = {
    "cpu": ({}, ValueError, "needs a CUDA tensor"),
    "meta": ({"device": "meta"}, ValueError, "needs a CUDA tensor"),
    "complex128_R": ({"R": _cube(2, 7, 5, 8).to(torch.complex128)}, TypeError, "complex64 R"),
    "float32_R": ({"R": torch.ones((2, 7, 5, 8))}, TypeError, "complex64 R"),
    "R_rank": ({"R": _cube(2, 7, 5, 8)[0]}, ValueError, r"R \[B, C, W, L\]"),
    "strided_R": ({"R": _cube(2, 7, 5, 16)[..., ::2]}, ValueError, "inner three dims"),
    "channel_last_R": ({"R": _cube(2, 5, 8, 7).permute(0, 3, 1, 2)}, ValueError,
                       "inner three dims"),
    "dop_rows": ({"dop": torch.ones((9, 8), dtype=torch.complex64)}, ValueError,
                 r"dop \[8, V\]"),
    "float_dop": ({"dop": torch.ones((8, 8))}, TypeError, "complex64 dop"),
    "int32_r_idx": ({"r_idx": torch.zeros((2, 10), dtype=torch.int32)}, TypeError,
                    "int64 r_idx"),
    "r_idx_frames": ({"r_idx": torch.zeros((3, 10), dtype=torch.int64)}, ValueError,
                     r"r_idx \[2, K\]"),
    "v_idx_slots": ({"v_idx": torch.zeros((2, 11), dtype=torch.int64)}, ValueError,
                    "v_idx of shape"),
    "uint8_valid": ({"valid": torch.ones((2, 10), dtype=torch.uint8)}, TypeError,
                    "bool valid"),
    "strided_v_idx": ({"v_idx": torch.zeros((2, 20), dtype=torch.int64)[:, ::2]}, ValueError,
                      "contiguous v_idx"),
    "position_off_R": ({"az_pos": (0, 1, 2, 7)}, ValueError, "lie off R"),
    "too_many_az": ({"az_pos": tuple(range(17)), "R": _cube(2, 17, 5, 8),
                     "az_dft": torch.ones((17, 64), dtype=torch.complex64)}, ValueError,
                    "up to 16 az positions"),
    "too_wide_union": ({"az_pos": tuple(range(16)), "el_pos": (16,), "R": _cube(2, 17, 5, 8),
                        "az_dft": torch.ones((16, 64), dtype=torch.complex64),
                        "el_dft": torch.ones((1, 64), dtype=torch.complex64)}, ValueError,
                       "up to 16 channels"),
    "no_bins": ({"angle_bins": torch.zeros(0)}, ValueError, "M >= 1"),
    "az_dft_rows": ({"az_dft": torch.ones((3, 64), dtype=torch.complex64)}, ValueError,
                    r"az_dft of shape \[4, 64\]"),
    "el_dft_bins": ({"el_dft": torch.ones((4, 32), dtype=torch.complex64)}, ValueError,
                    r"el_dft of shape \[4, 64\]"),
    "float64_bins": ({"angle_bins": torch.zeros(64, dtype=torch.float64)}, TypeError,
                     "float32 angle_bins"),
    "too_many_bins": ({"angle_bins": torch.zeros(1024),
                       "az_dft": torch.ones((4, 1024), dtype=torch.complex64),
                       "el_dft": torch.ones((4, 1024), dtype=torch.complex64)}, ValueError,
                      "shared memory"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_wrapper_refuses_what_the_kernel_does_not_take_before_any_build(no_build, case):
    change, err, match = REFUSALS[case]
    inputs = _wrapper_inputs()
    device = change.get("device")
    inputs.update({k: v for k, v in change.items() if k != "device"})
    if device is not None:
        inputs = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                  for k, v in inputs.items()}
    before = kernel.aoa_head.launches
    with pytest.raises(err, match=match):
        kernel.aoa_head(inputs.pop("R"), inputs.pop("dop"), inputs.pop("r_idx"),
                        inputs.pop("v_idx"), inputs.pop("valid"), **inputs)
    assert kernel.aoa_head.launches == before


def test_the_dispatch_sends_every_other_device_to_the_kernel(no_build, cfg):
    """Off the CPU there is no plain path: the kernel takes CUDA tensors or raises."""
    head = AngleHead(cfg, az_pos=(0, 1), el_pos=(), **HEAD_KW).to("meta")
    inputs = _wrapper_inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        head(*(inputs[k].to("meta") for k in ("R", "dop", "r_idx", "v_idx", "valid")))


def test_the_wrappers_limits_are_the_sources():
    source = (_build.CSRC_DIR / "aoa_head.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert int(re.search(r"kMaxChannels = (\d+);", code).group(1)) == kernel.MAX_CHANNELS
    assert int(re.search(r"kMaxAntennas = (\d+);", code).group(1)) == kernel.MAX_ANTENNAS
    dyn = re.search(r"kMaxDynamicBytes = (\d+) \* (\d+);", code)
    assert int(dyn.group(1)) * int(dyn.group(2)) == kernel.MAX_DYNAMIC_BYTES
    # the accurate library functions, and no contraction of the power or the point
    assert "cosf(" in code and "sinf(" in code and "__cosf" not in code and "__sinf" not in code
    assert "__fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y))" in code
    assert not any("fast" in flag for flag in _build.NVCC_FLAGS)
    lib = _build.library_path("aoa_head")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("aoa_head-")
    assert "aoa_head" in __import__(
        "mmwave_radar_processing_tpu_torch.ops.kernels", fromlist=["wrappers"]).wrappers()


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _powers(head, R, dop, r_i, v_i):
    """Each subset's angle power spectrum ``[B, K, M]`` from the plain version's values."""
    vals = dft.rd_values(R, dop, r_i, v_i)
    out = []
    for has, pos, mat in ((head.has_az, head.az_pos, head.az_dft),
                          (head.has_el, head.el_pos, head.el_dft)):
        if has:
            spec = vals[:, pos].transpose(1, 2) @ mat
            out.append(spec.real * spec.real + spec.imag * spec.imag)
    return out


def _near_ties(powers):
    """``bool [B, K]``: a slot whose two largest powers of either spectrum lie within ``TIE_REL``."""
    tie = None
    for p in powers:
        top = torch.topk(p, 2, dim=-1).values
        t = top[..., 1] >= top[..., 0] * (1 - TIE_REL)
        tie = t if tie is None else tie | t
    return tie


def _agree(got, want, ties, valid):
    """Points within POINT_ATOL and velocities equal off the near-ties; 0 in invalid slots."""
    got, want, ties, valid = got.cpu(), want.cpu(), ties.cpu(), valid.cpu()
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    assert torch.equal(got[..., 3], want[..., 3])
    apart = (got[..., :3] - want[..., :3]).abs().amax(-1) > POINT_ATOL
    assert not (apart & ~ties).any(), f"{int((apart & ~ties).sum())} points apart off a tie"
    # a flipped bin still puts the point at the slot's range
    r_got, r_want = got[..., :3].norm(dim=-1), want[..., :3].norm(dim=-1)
    assert torch.allclose(r_got, r_want, rtol=1e-5, atol=1e-6)
    return int(apart.sum())


#: (frames, channels of R, first channel read, slots, loops, az, el, fill): the
#: configurations' widths (the point-cloud cells at 128 slots and 70 or 100
#: loops, the ground cell at 512), the viewer's 12-channel R with its default
#: sets and with every channel in both, empty subsets, flags that are no
#: prefix, and more loops than a lane keeps of a row (224: 1843_human_movement)
CARD_CASES = {
    "ods20_k128": (64, 8, 1, 128, 70, None, None, "prefix"),
    "ods10_k128_l100": (64, 8, 1, 128, 100, None, None, "full"),
    "ground_k512": (32, 7, 0, 512, 70, None, None, "prefix"),
    "scattered_k512": (16, 7, 0, 512, 70, None, None, "scattered"),
    "viewer_a12": (16, 12, 0, 256, 70, AZ, EL, "prefix"),
    "viewer_every_channel": (16, 12, 0, 256, 70, tuple(range(12)), tuple(range(11, -1, -1)),
                             "scattered"),
    "no_el": (16, 7, 0, 128, 70, (0, 1, 2, 3), (), "prefix"),
    "no_az": (16, 7, 0, 128, 70, (), (4, 5, 6), "prefix"),
    "no_angles": (16, 1, 1, 128, 70, (), (), "prefix"),
    "one_frame_one_slot": (1, 7, 0, 1, 70, None, None, "full"),
    "odd_widths": (5, 7, 0, 300, 33, (6, 0), (1,), "scattered"),
    "long_loops": (8, 4, 0, 64, 224, (0, 1, 2, 3), (), "scattered"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_the_kernel_equals_the_plain_head(cuda, cfg, case):
    frames, channels, start, slots, loops, az, el, fill = CARD_CASES[case]
    rows = cfg.num_adc_samples
    if az is None:
        layout = antenna_union(AZ, EL, reformat_input=True, num_rx=cfg.num_rx_antennas)
        az, el = layout.az_pos, layout.el_pos
    head = AngleHead(cfg, az_pos=az, el_pos=el, **HEAD_KW).to(cuda)
    _, dop = (dft.to_matrix(f).to(cuda) for f in dft.range_doppler_factors(rows, loops))
    R = _cube(frames, channels, rows, loops, seed=slots, device=cuda)[:, start:]
    r_i, v_i, valid = (t.to(cuda) for t in _slots(frames, slots, rows, loops, fill, seed=frames))
    before = kernel.aoa_head.launches
    got = head(R, dop, r_i, v_i, valid)
    torch.cuda.synchronize()
    assert kernel.aoa_head.launches == before + 1
    want = head.plain(R, dop, r_i, v_i, valid)
    powers = _powers(head, R, dop, r_i, v_i) if head.has_az or head.has_el else []
    ties = _near_ties(powers) if powers else torch.zeros_like(valid)
    flipped = _agree(got, want, ties & valid, valid)
    assert flipped <= max(1, int(valid.sum()) // 100)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_cube", "one_antenna"])
def test_an_exact_tie_takes_the_lower_bin(cuda, cfg, case):
    """Every bin of the spectrum has the same power: the angle is bin 0's, as torch.argmax."""
    rows, loops = cfg.num_adc_samples, cfg.frame.loops
    az, el = ((0, 1, 2, 3), (4, 5)) if case == "zero_cube" else ((2,), (5,))
    head = AngleHead(cfg, az_pos=az, el_pos=el, **HEAD_KW).to(cuda)
    _, dop = (dft.to_matrix(f).to(cuda) for f in dft.range_doppler_factors(rows, loops))
    R = _cube(4, 7, rows, loops, device=cuda)
    if case == "zero_cube":
        R = torch.zeros_like(R)
    r_i, v_i, valid = (t.to(cuda) for t in _slots(4, 64, rows, loops, "full"))
    got = head(R, dop, r_i, v_i, valid).cpu()
    first = head.angle_bins[0].cpu().expand(4, 64)
    ranges = r_i.cpu().to(torch.float32) * head.range_res
    vels = head.vel0 + v_i.cpu().to(torch.float32) * head.vel_res
    want = torch.where(valid.cpu()[..., None],
                       spherical_to_cartesian_flu(ranges, first, first, vels), 0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=POINT_ATOL)
    plain = head.plain(R, dop, r_i, v_i, valid).cpu()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=POINT_ATOL)


@pytest.mark.cuda
def test_a_bin_off_the_cube_gives_nan(cuda, cfg):
    rows, loops = cfg.num_adc_samples, cfg.frame.loops
    head = AngleHead(cfg, az_pos=AZ, el_pos=(1,), **HEAD_KW).to(cuda)
    _, dop = (dft.to_matrix(f).to(cuda) for f in dft.range_doppler_factors(rows, loops))
    R = _cube(1, 8, rows, loops, device=cuda)
    r_i = torch.tensor([[0, rows, -1, 3, 2]], device=cuda)
    v_i = torch.tensor([[0, 1, 2, loops, 5]], device=cuda)
    valid = torch.tensor([[True, True, True, True, False]], device=cuda)
    got = head(R, dop, r_i, v_i, valid).cpu()
    assert torch.isnan(got[0, 1:4]).all() and not torch.isnan(got[0, [0, 4]]).any()
    assert torch.equal(got[0, 4], torch.zeros(4))


def _planes(cfg, frames, seed=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = (frames, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    return (torch.randn(shape, generator=g).to(device),
            torch.randn(shape, generator=g).to(device))


def _points_of(pipeline, key=None):
    """A caller's points ``[B, K, 4]`` from raw planes."""
    def call(re_, im_):
        out = pipeline(re_, im_)
        return out[key] if key else out.points
    return call


#: the head's three callers, each built on a device
CALLERS = {
    "point_cloud": lambda cfg, device: _points_of(build_point_cloud_pipeline(cfg, device=device)),
    "ground": lambda cfg, device: _points_of(
        build_ground_point_cloud_pipeline(cfg, device=device)),
    "viewer_det2d": lambda cfg, device: _points_of(
        build_viewer_payload_pipeline(cfg, include=["det2d"], device=device), "points"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("caller", list(CALLERS))
def test_one_launch_a_head_call_in_every_caller_and_none_on_the_cpu(cuda, cfg, caller):
    gpu, cpu = CALLERS[caller](cfg, cuda), CALLERS[caller](cfg, "cpu")
    planes = _planes(cfg, 6)
    before = kernel.aoa_head.launches
    for k in range(1, 3):
        got = gpu(*(p.to(cuda) for p in planes))
        torch.cuda.synchronize()
        assert kernel.aoa_head.launches == before + k
    want = cpu(*planes)
    assert kernel.aoa_head.launches == before + 2
    assert got.shape == want.shape and torch.isfinite(got).all()
