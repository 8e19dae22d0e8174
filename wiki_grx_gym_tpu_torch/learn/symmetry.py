"""Mirror-symmetry loss (port of ``wiki_grx_gym_tpu/learn/symmetry.py``).

The left/right reflection about the robot's sagittal (x-z) plane is a
static (permutation, sign) pair derived from the robot model once: for a
joint ``i`` whose counterpart is ``j`` (the same name with left and right
swapped; itself if unpaired), the mirrored angle is ``q'_j = -q_i`` when
``axis_j == M axis_i`` and ``+q_i`` when ``axis_j == -M axis_i``, with
``M = diag(1, -1, 1)`` and the axes in world frame at the zero pose (pitch
joints keep their sign, roll and yaw joints flip). The loss is the squared
distance between the policy's mean on mirrored observations and the
mirrored mean; PPO adds it through ``extra_loss_fn(flat, minibatch)``, so an
update with it takes the xla path (``FusedPPOGrad.supported`` is false).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MIRROR = np.diag([1.0, -1.0, 1.0]).astype(np.float32)

# left/right name patterns, most specific first
_LR_PATTERNS = (("left", "right"), ("l_", "r_"), ("_l", "_r"))


def _counterpart_name(name: str) -> str:
    for a, b in _LR_PATTERNS:
        if a in name:
            return name.replace(a, b)
        if b in name:
            return name.replace(b, a)
    return name


class MirrorSpec(NamedTuple):
    """Static reflection operators (host numpy)."""

    dof_perm: np.ndarray   # (D,) int: mirrored dof index
    dof_sign: np.ndarray   # (D,) float: sign applied after permuting
    obs_perm: np.ndarray   # (O,) int
    obs_sign: np.ndarray   # (O,) float


def mirror_dof_map(model):
    """(perm, sign) such that ``q_mirrored = sign * q[perm]``."""
    from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics

    names = list(model.dof_names)
    perm = np.zeros(len(names), np.int64)
    for i, nm in enumerate(names):
        cp = _counterpart_name(nm)
        if cp not in names:
            raise ValueError(f"no mirror counterpart for dof {nm!r}")
        perm[i] = names.index(cp)

    # world joint axes at the zero pose
    d = model.num_dof
    z = lambda k: torch.zeros(k, dtype=torch.float32)
    kin = forward_kinematics(model, torch.tensor([0.0, 0.0, 0.0, 1.0]), z(3), z(3), z(d), z(d))
    axes = kin.subspace[1:, :3].numpy()   # (D, 3) world axis per joint

    sign = np.zeros(d, np.float32)
    for i in range(d):
        j = perm[i]
        dot = float(np.dot(_MIRROR @ axes[i], axes[j]))
        if abs(dot) < 0.9:
            raise ValueError(
                f"dofs {names[i]!r}/{names[j]!r} axes are not mirror images "
                f"(|cos|={abs(dot):.3f}); cannot derive a symmetry map")
        # axis_j == +M axis_i: the angle negates; == -M axis_i: it is kept
        sign[j] = -1.0 if dot > 0 else 1.0
    return perm, sign


def build_mirror_spec(env) -> MirrorSpec:
    """Reflection operators for the actor obs layout
    ``[cmd(3), ang_vel(3), gravity(3), dof_pos(D), dof_vel(D), actions(D)]``."""
    dof_perm, dof_sign = mirror_dof_map(env.model)
    blocks = [
        (np.arange(3), np.array([1.0, -1.0, -1.0], np.float32)),   # commands vx, vy, wyaw
        (np.arange(3), np.array([-1.0, 1.0, -1.0], np.float32)),   # base angular velocity (pseudo-vector)
        (np.arange(3), np.array([1.0, -1.0, 1.0], np.float32)),    # projected gravity
    ] + [(dof_perm, dof_sign)] * 3                                 # dof_pos, dof_vel, actions
    obs_perm, obs_sign, off = [], [], 0
    for perm, sign in blocks:
        obs_perm.append(np.asarray(perm) + off)
        obs_sign.append(sign)
        off += len(perm)
    if off != env.obs_dim:
        raise ValueError(f"obs layout mismatch: mirror covers {off} dims, obs_dim={env.obs_dim}")
    return MirrorSpec(dof_perm=dof_perm, dof_sign=dof_sign.astype(np.float32),
                      obs_perm=np.concatenate(obs_perm),
                      obs_sign=np.concatenate(obs_sign).astype(np.float32))


class _DeviceMirror:
    """The reflection of a :class:`MirrorSpec` applied to tensors, its
    permutations and signs moved to the tensors' device at the first call
    for each device and type and then reused: the loss makes no host copy,
    which a CUDA graph's capture refuses (its warm-up makes them)."""

    def __init__(self, spec: MirrorSpec):
        self.spec = spec
        self._ops = {}

    def _apply(self, x, which):
        key = (which, x.device, x.dtype)
        if key not in self._ops:
            perm, sign = getattr(self.spec, f"{which}_perm"), getattr(self.spec, f"{which}_sign")
            self._ops[key] = (torch.as_tensor(perm, device=x.device),
                              torch.as_tensor(sign, device=x.device, dtype=x.dtype))
        perm, sign = self._ops[key]
        return x[..., perm] * sign

    def obs(self, obs):
        return self._apply(obs, "obs")

    def actions(self, actions):
        return self._apply(actions, "dof")


def mirror_obs(spec: MirrorSpec, obs: torch.Tensor) -> torch.Tensor:
    return _DeviceMirror(spec).obs(obs)


def mirror_actions(spec: MirrorSpec, actions: torch.Tensor) -> torch.Tensor:
    return _DeviceMirror(spec).actions(actions)


def make_mirror_loss(env, net, coef: float):
    """``extra_loss_fn(flat, mb) -> scalar``: ``coef`` x the mean squared
    distance between the policy mean on mirrored observations and the
    mirrored policy mean, both functions of the flat params ``flat``; zero
    iff the policy is sagittal-plane equivariant on the batch."""
    mirror = _DeviceMirror(build_mirror_spec(env))
    coef = float(coef)

    def loss_fn(flat, mb):
        obs = mb["obs"].to(torch.float32)
        mean = net.action_mean(obs, flat=flat)
        mean_of_mirror = net.action_mean(mirror.obs(obs), flat=flat)
        return coef * torch.mean(torch.square(mean_of_mirror - mirror.actions(mean)))

    return loss_fn


def make_mirror_loss_recurrent(env, net, coef: float):
    """The recurrent policy's mirror loss over the (T, M) trajectory
    minibatch. The LSTM memory after a mirrored input prefix is the
    "mirrored hidden state": no operator acts on the hidden vector, so the
    loss compares the sequence policy from a ZERO initial memory on the
    observations and on their mirror (equivariant from the zero state means
    equivariant on every mirrored prefix by induction; the rollout's
    ``hidden0`` would condition the two on different histories)."""
    mirror = _DeviceMirror(build_mirror_spec(env))
    coef = float(coef)

    def loss_fn(flat, mb):
        obs, done_prev = mb["obs"].to(torch.float32), mb["done_prev"]
        zero = net.initial_hidden(obs.shape[1], obs.device)
        mean = net.action_mean_seq(obs, done_prev, zero, flat=flat)
        mean_of_mirror = net.action_mean_seq(mirror.obs(obs), done_prev, zero, flat=flat)
        return coef * torch.mean(torch.square(mean_of_mirror - mirror.actions(mean)))

    return loss_fn
