"""Port parity for the terrain: the generators, the composed grid and the
three height lookups the env runs, against the JAX package on the CPU.

- The same ``np.random.RandomState`` gives the same heightfield, terrain
  origins and riser threshold, bit for bit, for a curriculum grid and a
  randomized one (the generators that draw from the rng included).
- The lookups (``terrain/composer.Terrain.height``, ``measured``,
  ``ground_channels``) against the JAX env's tile forms
  (``tile_height_fn``, ``tile_measured_1tap`` on ``tile_min``,
  ``tile_ground_channels``, all on tiles from ``extract_tiles`` at the same
  centers), at the env's own query points: the contact points of the
  default pose around a reset env, the 121-point measured grid around a
  yawed base, points near the border between two patches, points across
  stair risers, and points beyond the tile (which both sides clip to its
  edge).

Tolerances: the 3-tap min and the riser corners are integer taps, so the
measured heights are equal and the riser channels agree to float32
rounding of their closed form (atol 2e-6 m, 2e-6 on the slopes, walls'
signs equal). The bilinear height is a sum of four products taken in
another order (and on the TPU at ``Precision.HIGH``, three bf16 passes):
heights up to 2000 raw units of 5 mm, so atol 1e-5 m (4 ulp of 10 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.terrain.composer import Terrain as JaxTerrain
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.terrain.composer import Terrain

H_ATOL = 1e-5
CH_ATOL = 2e-6


def terrain_cfgs(mesh_type, curriculum=True, rows=3, cols=4):
    """The GR1T1 config's terrain section of each side, cut to a small grid."""
    out = []
    for reg in (jax_registry, torch_registry):
        cfg, _ = reg.get_cfgs("GR1T1")
        t = cfg.terrain
        t.mesh_type, t.curriculum, t.num_rows, t.num_cols = mesh_type, curriculum, rows, cols
        t.max_init_terrain_level = rows - 1
        out.append(t)
    return out


@pytest.fixture(scope="module", params=["heightfield", "trimesh"])
def terrains(request):
    jc, tc = terrain_cfgs(request.param)
    return JaxTerrain(jc), Terrain(tc)


@pytest.mark.parametrize("curriculum", [True, False])
def test_same_seed_same_field(curriculum):
    jc, tc = terrain_cfgs("trimesh", curriculum=curriculum)
    jt, tt = JaxTerrain(jc), Terrain(tc)
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins_grid, jt.env_origins_grid)
    np.testing.assert_array_equal(tt.terrain_origins.numpy(), np.asarray(jt.terrain_origins))
    np.testing.assert_array_equal(tt.field[: tt.shape[0], : tt.shape[1]].numpy(),
                                  np.asarray(jt.height_samples))
    assert tt.slope_threshold_raw == jt.slope_threshold_raw == 0.75 * 0.1 / 0.005
    assert len(np.unique(tt.height_field_raw)) > 50   # the generators ran


def test_heightfield_has_no_riser_threshold():
    jc, tc = terrain_cfgs("heightfield")
    assert Terrain(tc).slope_threshold_raw is None is JaxTerrain(jc).slope_threshold_raw


def query_sets(tt):
    """{name: (centers (N, 2), x (N, Q), y (N, Q))} of float32 world points."""
    rng = np.random.RandomState(3)
    org = tt.env_origins_grid.reshape(-1, 3).astype(np.float32)
    sets = {}
    # contact points of the default pose around reset envs (yawed roots)
    env, _ = torch_registry.make_env("GR1T1", device="cpu")
    rel = env._default_point_rel.numpy()                       # (P, 3)
    yaw = rng.uniform(-np.pi, np.pi, len(org))
    root = org[:, :2] + rng.uniform(-1, 1, (len(org), 2))
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    px = root[:, :1] + c * rel[None, :, 0] - s * rel[None, :, 1]
    py = root[:, 1:] + s * rel[None, :, 0] + c * rel[None, :, 1]
    sets["contact points after a reset"] = (root, px, py)
    # the measured grid (11 x 11, 0.1 m) around a yawed base
    gx, gy = np.meshgrid(np.linspace(-0.5, 0.5, 11), np.linspace(-0.5, 0.5, 11), indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    sets["measured grid around a yawed base"] = (
        root, root[:, :1] + c * gx - s * gy, root[:, 1:] + s * gx + c * gy)
    # across the border between patches (rows and columns of the grid)
    b = tt._border_m
    cen = np.stack([b + 8.0 * rng.randint(1, 3, 16) + rng.uniform(-0.3, 0.3, 16),
                    b + 8.0 * rng.randint(1, 3, 16) + rng.uniform(-0.3, 0.3, 16)], axis=1)
    off = rng.uniform(-1.3, 1.3, (16, 40, 2))
    sets["near patch borders"] = (cen, cen[:, None, 0] + off[..., 0], cen[:, None, 1] + off[..., 1])
    # across stair risers: cells whose x edge rises more than the threshold
    hs = tt.height_field_raw.astype(np.float32)
    ix, iy = np.nonzero(np.abs(np.diff(hs, axis=0)) > 15.0)
    pick = rng.choice(len(ix), 16, replace=False)
    cx = (ix[pick] + 1.0) * tt._hs - b
    cy = (iy[pick] + 0.5) * tt._hs - b
    cen = np.stack([cx, cy], axis=1)
    off = rng.uniform(-0.12, 0.12, (16, 40, 2))
    sets["across risers"] = (cen, cen[:, None, 0] + off[..., 0], cen[:, None, 1] + off[..., 1])
    # beyond the tile: both sides clip the local index to the tile's edge
    off = rng.uniform(-3.5, 3.5, (len(org), 40, 2))
    sets["beyond the tile"] = (root, root[:, None, 0] + off[..., 0], root[:, None, 1] + off[..., 1])
    return {k: tuple(np.asarray(a, np.float32) for a in v) for k, v in sets.items()}


SETS = ["contact points after a reset", "measured grid around a yawed base", "near patch borders",
        "across risers", "beyond the tile"]


@pytest.mark.parametrize("which", SETS)
def test_lookups_match_the_tile_forms(terrains, which):
    jt, tt = terrains
    cen, x, y = query_sets(tt)[which]
    tiles = jt.extract_tiles(jnp.asarray(cen))
    tcen, tx, ty = (torch.from_numpy(a) for a in (cen, x, y))
    sx, sy = tt.tile_starts(tcen)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(tiles[1]))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(tiles[2]))

    want = np.asarray(jt.tile_height_fn(*tiles, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(tt.height(tcen, tx, ty).numpy(), want, rtol=0, atol=H_ATOL)

    want = np.asarray(jt.tile_measured_1tap(jt.tile_min(tiles[0]), tiles[1], tiles[2],
                                            jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(tt.measured(tcen, tx, ty).numpy(), want)

    want = np.asarray(jt.tile_ground_channels(*tiles, jnp.asarray(x), jnp.asarray(y)))
    got = tt.ground_channels(tcen, tx, ty).numpy()
    np.testing.assert_array_equal(got[..., [5, 8]], want[..., [5, 8]])   # wall signs
    np.testing.assert_allclose(got, want, rtol=0, atol=CH_ATOL)
    if which == "across risers" and tt.slope_threshold_raw is not None:
        assert (want[..., [5, 8]] != 0).mean() > 0.3   # the walls are there


def test_sample_origins_blocks_types():
    _, tc = terrain_cfgs("heightfield")
    tt = Terrain(tc)
    origins, levels, types = tt.sample_origins(torch.Generator().manual_seed(0), 10, tc)
    assert int(levels.max()) <= tc.max_init_terrain_level and int(levels.min()) >= 0
    # types in equal blocks of envs over the columns (legged_robot.py:1176-1178)
    np.testing.assert_array_equal(types.numpy(), np.floor(np.arange(10) / (10 / tc.num_cols)))
    np.testing.assert_array_equal(origins.numpy(),
                                  tt.terrain_origins[levels.long(), types.long()].numpy())
