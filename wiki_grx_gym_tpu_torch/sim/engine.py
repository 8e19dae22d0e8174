"""Physics state containers (port of the containers of
``wiki_grx_gym_tpu/sim/engine.py``).

``physics_step`` itself (the batched engine path) waits for ROADMAP queue 1
item 9; slice 1 steps the physics through K1 and its lane program."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PhysicsState:
    """Minimal-coordinate state, batched (N, ...)."""

    base_pos: torch.Tensor      # (N, 3) world
    base_quat: torch.Tensor     # (N, 4) x, y, z, w
    base_lin_vel: torch.Tensor  # (N, 3) world, velocity of the base origin
    base_ang_vel: torch.Tensor  # (N, 3) world
    q: torch.Tensor             # (N, D)
    qd: torch.Tensor            # (N, D)
    anchor: torch.Tensor        # (N, P, 3) stick-friction anchors (world)

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class BodyRandomization:
    """Per-env domain randomization of the physical model, (N,) leaves."""

    friction: torch.Tensor         # (N,)
    restitution: torch.Tensor      # (N,)
    base_mass_scale: torch.Tensor  # (N,)
    base_com_offset: torch.Tensor  # (N, 3)

    def replace(self, **kw) -> "BodyRandomization":
        return dataclasses.replace(self, **kw)
