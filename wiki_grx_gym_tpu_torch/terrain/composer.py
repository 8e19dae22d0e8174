"""Terrain grid composer and the height lookups the env runs.

Port of ``wiki_grx_gym_tpu/terrain/composer.py``. The host side is the same
numpy program (`legged_gym/utils/terrain.py:38-164`): a num_rows (levels) x
num_cols (types) grid of terrain_length x terrain_width subterrains inside a
border, with per-cell difficulty and type selection and env origins at cell
centers (z = max height of the central 2 x 2 m). The same ``rng`` gives the
same heightfield bit for bit.

The device side answers the env's three queries on the field held on the
env's device, each for (N, Q) world points around one center per env:

- :meth:`Terrain.height`: bilinear height (the contact planes' taps);
- :meth:`Terrain.measured`: the conservative 3-tap min (the measured-heights
  observation, `legged_robot.py:1260-1274`);
- :meth:`Terrain.ground_channels`: the 9 riser-aware channels of the trimesh
  mode (:func:`riser_channels`).

The engine path (``sim/engine.physics_step``) asks the whole field at
world points, as the JAX engine does: :meth:`Terrain.height_fn` (bilinear,
its contact height), :meth:`Terrain.measured_heights` (the 3-tap min) and
:meth:`Terrain.ground_query` (the 9 riser channels by gather).

The JAX env asks the same questions of a 48 x 48 tile cut around the
center (``extract_tiles`` and the one-hot products on the MXU, a TPU
device). Here each query is a direct gather from the whole field, at the
indices the tile path reads: the tile's start is computed as there, and a
query's local index is clipped to the tile (``clip(..., 0, TILE - 2)``), so
a point beyond the tile reads the tile's edge exactly as the JAX lookup
does. Integer taps (the 3-tap min, the riser corners) are then equal to the
JAX values; the bilinear sum is taken in another order than the one-hot
product (tests/test_torch_terrain.py states the tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.utils.maths import _div
from wiki_grx_gym_tpu_torch.terrain import generators as G


def riser_channels(h00, h10, h01, h11, hxb0, hxb1, hyb0, hyb1,
                   x0w, y0w, fx, fy, hs_m, vs, thr):
    """Vertical-surface (stair-riser) ground channels of a cell from its
    four corner heights and one backward neighbour row per axis, in raw
    height units: where a cell-edge height difference exceeds ``thr`` the
    surface is a vertical wall at the high side's grid line (the
    reference's trimesh slope-threshold correction, `terrain_utils.py:
    315-328`). ``hxb*`` are the heights at ``(x0-1, y0)/(x0-1, y0+1)``,
    ``hyb*`` at ``(x0, y0-1)/(x0+1, y0-1)``; ``x0w/y0w`` the world
    coordinates of the cell's (x0, y0) corner, ``fx/fy`` the in-cell
    fractions, ``hs_m/vs`` the horizontal and vertical scales.

    Returns (..., 9) channels in world meters:
    ``(c, gx, gy, wx_pos, wx_top, wx_sign, wy_pos, wy_top, wy_sign)``: the
    tread plane ``h(x, y) = c + gx x + gy y`` and up to one wall per axis,
    whose solid is ``sign * (coord - pos) > 0`` below ``top`` (``sign = 0``:
    no wall)."""
    dx0, dx1 = h10 - h00, h11 - h01

    def ir(a, d, f):
        # riser-flattened 1-D interpolation: (value, d value / d f)
        f_eff = torch.where(d > thr, 0.0, torch.where(d < -thr, 1.0, f))
        g = torch.where(torch.abs(d) > thr, 0.0, d)
        return a + f_eff * d, g

    v0, g0 = ir(h00, dx0, fx)
    v1, g1 = ir(h01, dx1, fx)
    dyv = v1 - v0
    h, gy_raw = ir(v0, dyv, fy)
    # the x-gradient of the tread under the point: the low y-side when the
    # y edge is a riser, the fy-blend otherwise
    wy_low = torch.where(dyv > thr, 0.0, torch.where(dyv < -thr, 1.0, fy))
    gx_raw = (1.0 - wy_low) * g0 + wy_low * g1

    g2m = vs / hs_m
    gx = gx_raw * g2m
    gy = gy_raw * g2m
    c = h * vs - gx * (x0w + fx * hs_m) - gy * (y0w + fy * hs_m)

    def axis_wall(d_in, d_back, low0w, hi_up, hi_dn, hi_b_this, hi_b_prev):
        """One axis's wall from the in-cell edge (first) or the back edge."""
        in_up = d_in > thr
        in_dn = d_in < -thr
        b_up = d_back > thr
        b_dn = d_back < -thr
        sign = torch.where(
            in_up, 1.0,
            torch.where(in_dn, -1.0, torch.where(b_up, 1.0, torch.where(b_dn, -1.0, 0.0))),
        )
        pos_w = torch.where(in_up, low0w + hs_m, low0w)
        top = torch.where(
            in_up, hi_up,
            torch.where(in_dn, hi_dn, torch.where(b_up, hi_b_this, hi_b_prev)),
        ) * vs
        return pos_w, top, sign

    dxi = (1.0 - fy) * dx0 + fy * dx1
    dxb = (1.0 - fy) * (h00 - hxb0) + fy * (h01 - hxb1)
    wx_pos, wx_top, wx_sign = axis_wall(
        dxi, dxb, x0w,
        (1.0 - fy) * h10 + fy * h11,
        (1.0 - fy) * h00 + fy * h01,
        (1.0 - fy) * h00 + fy * h01,
        (1.0 - fy) * hxb0 + fy * hxb1,
    )

    dy0, dy1 = h01 - h00, h11 - h10
    dyi = (1.0 - fx) * dy0 + fx * dy1
    dyb = (1.0 - fx) * (h00 - hyb0) + fx * (h10 - hyb1)
    wy_pos, wy_top, wy_sign = axis_wall(
        dyi, dyb, y0w,
        (1.0 - fx) * h01 + fx * h11,
        (1.0 - fx) * h00 + fx * h10,
        (1.0 - fx) * h00 + fx * h10,
        (1.0 - fx) * hyb0 + fx * hyb1,
    )
    return torch.stack([c, gx, gy, wx_pos, wx_top, wx_sign, wy_pos, wy_top, wy_sign], dim=-1)


class Terrain:
    """The terrain grid (host numpy) and its lookups on ``device``."""

    # the JAX env's tile: TILE x TILE cells on a BSTRIDE grid of starts
    TILE = 48
    BSTRIDE = 16

    def __init__(self, cfg, rng: np.random.RandomState | None = None, device="cpu"):
        self.cfg = cfg
        self.rng = rng or np.random.RandomState(0)
        self.type = cfg.mesh_type
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        props = list(cfg.terrain_proportions) + [0.0] * (8 - len(cfg.terrain_proportions))
        self.proportions = [sum(props[: i + 1]) for i in range(len(props))]

        self.num_sub_terrains = cfg.num_rows * cfg.num_cols
        self.env_origins_grid = np.zeros((cfg.num_rows, cfg.num_cols, 3))

        self.width_px = int(self.env_width / cfg.horizontal_scale)
        self.length_px = int(self.env_length / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_cols = int(cfg.num_cols * self.width_px) + 2 * self.border
        self.tot_rows = int(cfg.num_rows * self.length_px) + 2 * self.border

        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols), dtype=np.int16)
        if cfg.curriculum:
            self._curriculum()
        elif cfg.selected:
            self._selected()
        else:
            self._randomized()

        self._hs = float(cfg.horizontal_scale)
        self._vs = float(cfg.vertical_scale)
        self._border_m = float(cfg.border_size)
        # trimesh: vertical surfaces above the slope threshold, in raw units;
        # None = heightfield semantics
        st = getattr(cfg, "slope_treshold", None)
        self.slope_threshold_raw = (
            float(st) * self._hs / self._vs
            if (cfg.mesh_type == "trimesh" and st is not None)
            else None
        )
        self._to_device(device)

    @classmethod
    def from_heightfield(cls, field: np.ndarray, horizontal_scale: float, vertical_scale: float,
                         border_size: float = 0.0, slope_threshold: float | None = None, device="cpu"):
        """A Terrain around an explicit raw (int16) heightfield (tests and
        tooling): no generators, one cell whose origin is the field's
        center at height 0. ``slope_threshold`` (as
        ``cfg.terrain.slope_treshold``) gives trimesh semantics."""
        t = cls.__new__(cls)
        t.cfg = None
        t.type = "trimesh" if slope_threshold is not None else "heightfield"
        t.height_field_raw = np.asarray(field, np.int16)
        t._hs = float(horizontal_scale)
        t._vs = float(vertical_scale)
        t._border_m = float(border_size)
        t.env_length = field.shape[0] * horizontal_scale
        t.env_width = field.shape[1] * horizontal_scale
        t.env_origins_grid = np.asarray([[[t.env_length / 2.0, t.env_width / 2.0, 0.0]]])
        t.slope_threshold_raw = (
            float(slope_threshold) * t._hs / t._vs if slope_threshold is not None else None
        )
        t._to_device(device)
        return t

    # ------------------------------------------------------------------
    # host-side composition (the same program as the JAX package's)
    # ------------------------------------------------------------------

    def _new_patch(self) -> G.SubTerrain:
        return G.SubTerrain(
            width=self.width_px,
            length=self.width_px,
            vertical_scale=self.cfg.vertical_scale,
            horizontal_scale=self.cfg.horizontal_scale,
        )

    def _randomized(self):
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            choice = self.rng.uniform(0, 1)
            difficulty = self.rng.choice([0.5, 0.75, 0.9])
            self._add(self.make_terrain(choice, difficulty), i, j)

    def _curriculum(self):
        for j in range(self.cfg.num_cols):
            for i in range(self.cfg.num_rows):
                difficulty = i / self.cfg.num_rows
                choice = j / self.cfg.num_cols + 0.001
                self._add(self.make_terrain(choice, difficulty), i, j)

    def _selected(self):
        kwargs = dict(self.cfg.terrain_kwargs)
        terrain_type = kwargs.pop("type")
        fn = getattr(G, terrain_type)
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            patch = self._new_patch()
            fn(patch, **kwargs)
            self._add(patch, i, j)

    def make_terrain(self, choice: float, difficulty: float) -> G.SubTerrain:
        """Difficulty and type mix as utils/terrain.py:109-145."""
        t = self._new_patch()
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        obstacle_height = 0.05 + difficulty * 0.2
        stone_size = 1.5 * (1.05 - difficulty)
        stone_distance = 0.05 if difficulty == 0 else 0.1
        gap_size = 1.0 * difficulty
        pit_depth = 1.0 * difficulty
        p = self.proportions
        if choice < p[0]:
            if choice < p[0] / 2:
                slope *= -1
            G.pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
        elif choice < p[1]:
            G.pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
            G.random_uniform_terrain(
                t, min_height=-0.05, max_height=0.05, step=0.005, downsampled_scale=0.2,
                rng=self.rng,
            )
        elif choice < p[3]:
            if choice < p[2]:
                step_height *= -1
            G.pyramid_stairs_terrain(t, step_width=0.31, step_height=step_height, platform_size=3.0)
        elif choice < p[4]:
            G.discrete_obstacles_terrain(
                t, obstacle_height, 1.0, 2.0, 20, platform_size=3.0, rng=self.rng
            )
        elif choice < p[5]:
            G.stepping_stones_terrain(
                t, stone_size=stone_size, stone_distance=stone_distance, max_height=0.0,
                platform_size=4.0, rng=self.rng,
            )
        elif choice < p[6]:
            G.gap_terrain(t, gap_size=gap_size, platform_size=3.0)
        else:
            G.pit_terrain(t, depth=pit_depth, platform_size=4.0)
        return t

    def _add(self, patch: G.SubTerrain, row: int, col: int):
        """utils/terrain.py:147-164."""
        sx = self.border + row * self.length_px
        sy = self.border + col * self.width_px
        self.height_field_raw[sx: sx + self.length_px, sy: sy + self.width_px] = (
            patch.height_field_raw
        )
        ox = (row + 0.5) * self.env_length
        oy = (col + 0.5) * self.env_width
        x1 = int((self.env_length / 2.0 - 1) / self.cfg.horizontal_scale)
        x2 = int((self.env_length / 2.0 + 1) / self.cfg.horizontal_scale)
        y1 = int((self.env_width / 2.0 - 1) / self.cfg.horizontal_scale)
        y2 = int((self.env_width / 2.0 + 1) / self.cfg.horizontal_scale)
        oz = np.max(patch.height_field_raw[x1:x2, y1:y2]) * self.cfg.vertical_scale
        self.env_origins_grid[row, col] = [ox, oy, oz]

    # ------------------------------------------------------------------
    # the field on the device, and the tile layout the lookups follow
    # ------------------------------------------------------------------

    def _to_device(self, device):
        """The float32 field (edge-padded to at least TILE x TILE, as the
        JAX tile pyramid pads it), the origins and the tile starts on
        ``device``."""
        t, s = self.TILE, self.BSTRIDE
        hs = self.height_field_raw
        self.shape = hs.shape
        hp = np.pad(hs, ((0, max(t - hs.shape[0], 0)), (0, max(t - hs.shape[1], 0))), mode="edge")
        nbx, nby = (hp.shape[0] + s - 1) // s, (hp.shape[1] + s - 1) // s
        self.device = torch.device(device)
        self.field = torch.as_tensor(hp.astype(np.float32), device=self.device)
        self.terrain_origins = torch.as_tensor(self.env_origins_grid.astype(np.float32), device=self.device)
        self._tile_sx = torch.as_tensor(np.clip(np.arange(nbx) * s - (t - s) // 2, 0, hp.shape[0] - t),
                                        device=self.device)
        self._tile_sy = torch.as_tensor(np.clip(np.arange(nby) * s - (t - s) // 2, 0, hp.shape[1] - t),
                                        device=self.device)

    def tile_starts(self, center_xy: torch.Tensor):
        """(N, 2) world xy -> the (N,) row and column starts of each env's
        tile (``extract_tiles``'s ``sx``, ``sy``)."""
        s = self.BSTRIDE
        px = _div(center_xy[:, 0] + self._border_m, self._hs)
        py = _div(center_xy[:, 1] + self._border_m, self._hs)
        bx = torch.clamp(_div(px, float(s)).to(torch.int64), 0, len(self._tile_sx) - 1)
        by = torch.clamp(_div(py, float(s)).to(torch.int64), 0, len(self._tile_sy) - 1)
        return self._tile_sx[bx], self._tile_sy[by]

    def _gather(self, gx, gy):
        """Field values at integer (N, Q) row and column indices."""
        return self.field.reshape(-1)[gx * self.field.shape[1] + gy]

    def _cell(self, center_xy, x, y):
        """The tile path's cell of each query: global row and column of its
        (x0, y0) corner (clipped to the field, then to the tile), the
        in-cell fractions, and the tile starts."""
        t = self.TILE
        sx, sy = self.tile_starts(center_xy)
        sxf, syf = sx[:, None].to(x.dtype), sy[:, None].to(y.dtype)
        px = torch.clamp(_div(x + self._border_m, self._hs), 0.0, self.shape[0] - 2.0)
        py = torch.clamp(_div(y + self._border_m, self._hs), 0.0, self.shape[1] - 2.0)
        lx = torch.clamp(px - sxf, 0.0, t - 2.0)
        ly = torch.clamp(py - syf, 0.0, t - 2.0)
        x0, y0 = torch.floor(lx), torch.floor(ly)
        return x0, y0, lx - x0, ly - y0, sx[:, None], sy[:, None]

    def height(self, center_xy, x, y):
        """Bilinear height (m) at (N, Q) world points, ``tile_height_fn``'s
        values for tiles cut at ``center_xy`` (N, 2)."""
        x0, y0, fx, fy, sx, sy = self._cell(center_xy, x, y)
        gx, gy = sx + x0.to(torch.int64), sy + y0.to(torch.int64)
        h00, h10 = self._gather(gx, gy), self._gather(gx + 1, gy)
        h01, h11 = self._gather(gx, gy + 1), self._gather(gx + 1, gy + 1)
        h = (h00 * (1.0 - fx) + h10 * fx) * (1.0 - fy) + (h01 * (1.0 - fx) + h11 * fx) * fy
        return h * self._vs

    def measured(self, center_xy, x, y):
        """The 3-tap min height (m) at (N, Q) world points,
        ``tile_measured_1tap`` on ``tile_min`` of tiles cut at ``center_xy``."""
        t = self.TILE
        sx, sy = self.tile_starts(center_xy)
        px = torch.clamp(_div(x + self._border_m, self._hs).to(torch.int64), 0, self.shape[0] - 2)
        py = torch.clamp(_div(y + self._border_m, self._hs).to(torch.int64), 0, self.shape[1] - 2)
        gx = sx[:, None] + torch.clamp(px - sx[:, None], 0, t - 2)
        gy = sy[:, None] + torch.clamp(py - sy[:, None], 0, t - 2)
        h = torch.minimum(self._gather(gx, gy),
                          torch.minimum(self._gather(gx + 1, gy), self._gather(gx, gy + 1)))
        return h * self._vs

    def ground_channels(self, center_xy, x, y):
        """(N, Q) world points -> (N, Q, 9) riser-aware ground channels
        (:func:`riser_channels`), ``tile_ground_channels``' values for tiles
        cut at ``center_xy``."""
        x0, y0, fx, fy, sx, sy = self._cell(center_xy, x, y)
        xi, yi = x0.to(torch.int64), y0.to(torch.int64)
        gx, gy = sx + xi, sy + yi
        gxb, gyb = sx + torch.clamp(xi - 1, min=0), sy + torch.clamp(yi - 1, min=0)
        g = self._gather
        x0w = (sx.to(x.dtype) + x0) * self._hs - self._border_m
        y0w = (sy.to(y.dtype) + y0) * self._hs - self._border_m
        return riser_channels(
            g(gx, gy), g(gx + 1, gy), g(gx, gy + 1), g(gx + 1, gy + 1),
            g(gxb, gy), g(gxb, gy + 1), g(gx, gyb), g(gx + 1, gyb),
            x0w, y0w, fx, fy, self._hs, self._vs, self._thr,
        )

    # ------------------------------------------------------------------
    # the engine's lookups: the whole field at world points
    # ------------------------------------------------------------------

    @property
    def _thr(self) -> float:
        return float("inf") if self.slope_threshold_raw is None else self.slope_threshold_raw

    def height_fn(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Bilinear height (m) for contact at world points of any shape."""
        px = torch.clamp(_div(x + self._border_m, self._hs), 0.0, self.shape[0] - 2.0)
        py = torch.clamp(_div(y + self._border_m, self._hs), 0.0, self.shape[1] - 2.0)
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx, fy = px - x0, py - y0
        xi, yi = x0.to(torch.int64), y0.to(torch.int64)
        g = lambda a, b: self._gather(a, b).to(x.dtype)
        h = (g(xi, yi) * (1 - fx) * (1 - fy) + g(xi + 1, yi) * fx * (1 - fy)
             + g(xi, yi + 1) * (1 - fx) * fy + g(xi + 1, yi + 1) * fx * fy)
        return h * self._vs

    def measured_heights(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The conservative 3-tap min height (m) at world points of any
        shape (legged_robot.py:1258-1274)."""
        px = torch.clamp(_div(x + self._border_m, self._hs).to(torch.int64), 0, self.shape[0] - 2)
        py = torch.clamp(_div(y + self._border_m, self._hs).to(torch.int64), 0, self.shape[1] - 2)
        h = torch.minimum(torch.minimum(self._gather(px, py), self._gather(px + 1, py)),
                          self._gather(px, py + 1))
        return h.to(x.dtype) * self._vs

    def ground_query(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """World points of any shape -> (..., 9) riser-aware ground channels
        (:func:`riser_channels`) by gathers from the whole field; JAX's
        ``Terrain.ground_channels(x, y)``."""
        px = torch.clamp(_div(x + self._border_m, self._hs), 0.0, self.shape[0] - 2.0)
        py = torch.clamp(_div(y + self._border_m, self._hs), 0.0, self.shape[1] - 2.0)
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx, fy = px - x0, py - y0
        xi, yi = x0.to(torch.int64), y0.to(torch.int64)
        xb, yb = torch.clamp(xi - 1, min=0), torch.clamp(yi - 1, min=0)
        g = lambda a, b: self._gather(a, b).to(x.dtype)
        x0w = x0 * self._hs - self._border_m
        y0w = y0 * self._hs - self._border_m
        return riser_channels(
            g(xi, yi), g(xi + 1, yi), g(xi, yi + 1), g(xi + 1, yi + 1),
            g(xb, yi), g(xb, yi + 1), g(xi, yb), g(xi + 1, yb),
            x0w, y0w, fx, fy, self._hs, self._vs, self._thr,
        )

    def sample_origins(self, generator: torch.Generator, num_envs: int, cfg, offset: int = 0,
                       total: int = None):
        """Initial terrain levels, types and origins of ``num_envs`` envs
        (legged_robot.py:1167-1183): levels uniform in [0, max_init] from
        ``generator``, types in equal blocks of envs. ``offset``/``total``:
        these are envs ``[offset, offset + num_envs)`` of ``total`` (default
        all), whose blocks the types follow."""
        total = num_envs if total is None else int(total)
        max_init = cfg.max_init_terrain_level if cfg.curriculum else cfg.num_rows - 1
        levels = torch.randint(0, max_init + 1, (num_envs,), generator=generator,
                               device=self.device, dtype=torch.int32)
        types = np.floor(np.arange(offset, offset + num_envs).astype(np.float32)
                         / np.float32(total / cfg.num_cols)).astype(np.int32)
        types = torch.as_tensor(types, device=self.device)
        origins = self.terrain_origins[levels.long(), types.long()]
        return origins, levels, types
