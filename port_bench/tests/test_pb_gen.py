"""The scene generator is deterministic per seed and puts the scene where the model says."""

import json

import torch

from conftest import BENCH_DIR
from port_bench.gen import scene
from port_bench.reference.radar import parse_cfg

RADAR = parse_cfg(json.loads((BENCH_DIR / "configs" / "iwr6843ods-radvel-20hz.json").read_text())
                  ["cfg_lines"])
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_frames_other_seed_other_frames():
    a = scene.frames(RADAR, 6, BIG_SEED, "cpu", chunk=4)
    b = scene.frames(RADAR, 6, BIG_SEED, "cpu", chunk=4)
    c = scene.frames(RADAR, 6, BIG_SEED + 1, "cpu", chunk=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (6, 4, 63, 210) and a[0].dtype == torch.float32
    assert torch.equal(scene.gumbel((3, 5), 7, "cpu"), scene.gumbel((3, 5), 7, "cpu"))


def test_nadir_return_at_the_altitude():
    re, im, alt = scene.frames(RADAR, 4, 99, "cpu")
    x = torch.complex(re, im)[:, 0]  # rx 0, [F, ns, chirps]
    spectrum = torch.fft.fft(x * torch.hann_window(63, periodic=False)[:, None], dim=1)
    power = spectrum.abs().pow(2).sum(-1)[:, :32]
    strongest = power.argmax(dim=1).float() * RADAR.range_res
    assert torch.all((strongest - alt).abs() <= 2 * RADAR.range_res)
    assert torch.all((alt >= 0.9) & (alt <= 1.3))

