"""Procedural heightfield generators (host-side numpy, run once at build).

The port's own copy of ``wiki_grx_gym_tpu/terrain/generators.py``: the
generator set of the reference's terrain toolkit
(`isaacgym/terrain_utils.py:17-283` plus the gap/pit extensions in
`legged_gym/utils/terrain.py:166-187`): uniform noise, slopes, pyramid
slopes, discrete obstacles, waves, stairs, pyramid stairs, stepping stones,
gaps, pits. Heights are int16 multiples of ``vertical_scale``. The code is
the same statement for statement, so the same ``np.random.RandomState``
gives the same heightfield bit for bit (tests/test_torch_terrain.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SubTerrain:
    """A width x length patch of int16 heights (terrain_utils.py:353-361)."""

    width: int
    length: int
    vertical_scale: float = 0.005
    horizontal_scale: float = 0.1
    height_field_raw: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.height_field_raw is None:
            self.height_field_raw = np.zeros((self.width, self.length), dtype=np.int16)


def random_uniform_terrain(terrain: SubTerrain, min_height, max_height, step=1,
                           downsampled_scale=None, rng=None):
    """Uniform noise sampled on a coarse grid, bilinearly upsampled
    (terrain_utils.py:17-51 — scipy interp2d replaced by a vectorized
    bilinear resample)."""
    rng = rng or np.random
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    min_h = int(min_height / terrain.vertical_scale)
    max_h = int(max_height / terrain.vertical_scale)
    step_h = int(step / terrain.vertical_scale)
    heights_range = np.arange(min_h, max_h + step_h, step_h)

    coarse_w = max(2, int(terrain.width * terrain.horizontal_scale / downsampled_scale))
    coarse_l = max(2, int(terrain.length * terrain.horizontal_scale / downsampled_scale))
    coarse = rng.choice(heights_range, (coarse_w, coarse_l)).astype(np.float64)

    # bilinear upsample coarse -> (width, length)
    xi = np.linspace(0, coarse_w - 1, terrain.width)
    yi = np.linspace(0, coarse_l - 1, terrain.length)
    x0 = np.clip(np.floor(xi).astype(int), 0, coarse_w - 2)
    y0 = np.clip(np.floor(yi).astype(int), 0, coarse_l - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    z = (
        coarse[x0][:, y0] * (1 - fx) * (1 - fy)
        + coarse[x0 + 1][:, y0] * fx * (1 - fy)
        + coarse[x0][:, y0 + 1] * (1 - fx) * fy
        + coarse[x0 + 1][:, y0 + 1] * fx * fy
    )
    terrain.height_field_raw += np.rint(z).astype(np.int16)
    return terrain


def sloped_terrain(terrain: SubTerrain, slope=1.0):
    """Linear slope along x (terrain_utils.py:54-71)."""
    x = np.arange(terrain.width).reshape(-1, 1)
    max_height = int(slope * (terrain.horizontal_scale / terrain.vertical_scale) * terrain.width)
    terrain.height_field_raw += (max_height * x / terrain.width).astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain: SubTerrain, slope=1.0, platform_size=1.0):
    """Pyramid slope with a flat center platform (terrain_utils.py:74-106)."""
    cx, cy = terrain.width // 2, terrain.length // 2
    x = (cx - np.abs(cx - np.arange(terrain.width))) / cx
    y = (cy - np.abs(cy - np.arange(terrain.length))) / cy
    max_height = int(slope * (terrain.horizontal_scale / terrain.vertical_scale) * (terrain.width / 2))
    terrain.height_field_raw += (max_height * x[:, None] * y[None, :]).astype(np.int16)

    platform = int(platform_size / terrain.horizontal_scale / 2)
    x1, y1 = terrain.width // 2 - platform, terrain.length // 2 - platform
    corner = terrain.height_field_raw[x1, y1]
    lo, hi = min(corner, 0), max(corner, 0)
    terrain.height_field_raw = np.clip(terrain.height_field_raw, lo, hi)
    return terrain


def discrete_obstacles_terrain(terrain: SubTerrain, max_height, min_size, max_size,
                               num_rects, platform_size=1.0, rng=None):
    """Random rectangular blocks (terrain_utils.py:109-146)."""
    rng = rng or np.random
    max_h = int(max_height / terrain.vertical_scale)
    min_s = int(min_size / terrain.horizontal_scale)
    max_s = int(max_size / terrain.horizontal_scale)
    platform = int(platform_size / terrain.horizontal_scale)

    (w, l) = terrain.height_field_raw.shape
    height_choices = [-max_h, -max_h // 2, max_h // 2, max_h]
    size_choices = list(range(min_s, max_s, 4))
    for _ in range(num_rects):
        rw = rng.choice(size_choices)
        rl = rng.choice(size_choices)
        i = rng.choice(range(0, w - rw, 4))
        j = rng.choice(range(0, l - rl, 4))
        terrain.height_field_raw[i : i + rw, j : j + rl] = rng.choice(height_choices)

    x1, x2 = (terrain.width - platform) // 2, (terrain.width + platform) // 2
    y1, y2 = (terrain.length - platform) // 2, (terrain.length + platform) // 2
    terrain.height_field_raw[x1:x2, y1:y2] = 0
    return terrain


def wave_terrain(terrain: SubTerrain, num_waves=1, amplitude=1.0):
    """Crossed sine waves (terrain_utils.py:149-169)."""
    amp = int(0.5 * amplitude / terrain.vertical_scale)
    if num_waves > 0:
        div = terrain.length / (num_waves * np.pi * 2)
        x = np.arange(terrain.width).reshape(-1, 1)
        y = np.arange(terrain.length).reshape(1, -1)
        terrain.height_field_raw += (amp * np.cos(y / div) + amp * np.sin(x / div)).astype(np.int16)
    return terrain


def stairs_terrain(terrain: SubTerrain, step_width, step_height):
    """Straight staircase (terrain_utils.py:172-192)."""
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    num_steps = terrain.width // sw
    height = sh
    for i in range(num_steps):
        terrain.height_field_raw[i * sw : (i + 1) * sw, :] += height
        height += sh
    return terrain


def pyramid_stairs_terrain(terrain: SubTerrain, step_width, step_height, platform_size=1.0):
    """Concentric stair pyramid (terrain_utils.py:195-224)."""
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)

    height = 0
    sx, ex, sy, ey = 0, terrain.width, 0, terrain.length
    while (ex - sx) > platform and (ey - sy) > platform:
        sx += sw
        ex -= sw
        sy += sw
        ey -= sw
        height += sh
        terrain.height_field_raw[sx:ex, sy:ey] = height
    return terrain


def stepping_stones_terrain(terrain: SubTerrain, stone_size, stone_distance, max_height,
                            platform_size=1.0, depth=-10.0, rng=None):
    """Stone grid over a deep pit (terrain_utils.py:227-283)."""
    rng = rng or np.random
    ss = max(1, int(stone_size / terrain.horizontal_scale))
    sd = int(stone_distance / terrain.horizontal_scale)
    max_h = int(max_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    height_range = np.arange(-max_h - 1, max_h, step=1)

    terrain.height_field_raw[:, :] = int(depth / terrain.vertical_scale)
    start_y = 0
    while start_y < terrain.length:
        stop_y = min(terrain.length, start_y + ss)
        start_x = rng.randint(0, ss)
        stop_x = max(0, start_x - sd)
        terrain.height_field_raw[0:stop_x, start_y:stop_y] = rng.choice(height_range)
        while start_x < terrain.width:
            stop_x = min(terrain.width, start_x + ss)
            terrain.height_field_raw[start_x:stop_x, start_y:stop_y] = rng.choice(height_range)
            start_x += ss + sd
        start_y += ss + sd

    x1, x2 = (terrain.width - platform) // 2, (terrain.width + platform) // 2
    y1, y2 = (terrain.length - platform) // 2, (terrain.length + platform) // 2
    terrain.height_field_raw[x1:x2, y1:y2] = 0
    return terrain


def gap_terrain(terrain: SubTerrain, gap_size, platform_size=1.0):
    """Square moat around a platform (legged_gym utils/terrain.py:166-178)."""
    gap = int(gap_size / terrain.horizontal_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    cx, cy = terrain.width // 2, terrain.length // 2
    x1 = (terrain.width - platform) // 2
    x2 = x1 + gap
    y1 = (terrain.length - platform) // 2
    y2 = y1 + gap
    terrain.height_field_raw[cx - x2 : cx + x2, cy - y2 : cy + y2] = -1000
    terrain.height_field_raw[cx - x1 : cx + x1, cy - y1 : cy + y1] = 0
    return terrain


def pit_terrain(terrain: SubTerrain, depth, platform_size=1.0):
    """Sunken center platform (legged_gym utils/terrain.py:180-187)."""
    d = int(depth / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.width // 2 - platform, terrain.width // 2 + platform
    y1, y2 = terrain.length // 2 - platform, terrain.length // 2 + platform
    terrain.height_field_raw[x1:x2, y1:y2] = -d
    return terrain
