"""PyTorch + CUDA port of ``wiki_grx_gym_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference: every module here is held
against its JAX counterpart by the parity tests in ``tests/test_torch_*.py``.
This package imports neither JAX nor anything of the JAX package; it keeps
its own copies of the configs and robot specs it needs.

Slice 1 covers the policy rollout of the 10-DOF GR1T1 lower limb on the
flat plane: configs and task registry, robot specs, quaternion maths,
forward kinematics, the decimation kernel K1 (``csrc/decimation.cu``, with
its plain PyTorch lane program in ``sim/scalarized.py`` +
``envs/post_lanes.py``), the env step, the actor-critic, the runner's
rollout and ``scripts/play.py``. See ROADMAP.md for what comes next.
"""

__all__ = ["resolve_device"]

from wiki_grx_gym_tpu_torch.device import resolve_device  # noqa: E402
