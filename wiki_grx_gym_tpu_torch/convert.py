"""Carry weights and state from the JAX package's formats into the port.

- :func:`actor_critic_from_numpy`: JAX ``ActorCriticParams`` as numpy
  (``actor``/``critic`` lists of ``(W (in, out), b)`` pairs plus ``std``)
  into the port's ``ActorCritic`` (``nn.Linear`` keeps W as (out, in)).
- :func:`recurrent_from_numpy` / :func:`recurrent_to_numpy`: JAX
  ``RecurrentParams`` as numpy (``memory_a``/``memory_c`` lists of layers
  with ``w_ih`` (I, 4H), ``w_hh`` (H, 4H), ``b_ih``, ``b_hh``, then the
  heads and ``std``) into the port's ``ActorCriticRecurrent`` flat buffer
  and back, bit for bit (the memories keep JAX's layout, the heads'
  weights are transposed).
- :func:`load_actor_npz`: the actor of a ``policy.npz`` written by the JAX
  ``export_policy_npz`` into the port's ``ActorCritic`` (with its LSTM
  layers into an ``ActorCriticRecurrent``).
- :func:`env_state_from_numpy`: a JAX ``EnvState`` flattened to numpy into
  the port's ``EnvState``. The port's ``rng`` is a ``torch.Generator``.
- :func:`ppo_state_from_numpy`: JAX params plus the raveled optax Adam
  ``mu``/``nu``, the count and the learning rate into the port's
  ``PPOState``. :func:`flat_from_jax_order` and :func:`flat_to_jax_order`
  convert one flat vector between JAX's ``ravel_pytree`` order (W (in, out))
  and the port's layout (W (out, in)); the leaves and offsets are the same.

Nothing here imports JAX: the inputs are plain numpy arrays and dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.sim.engine import BodyRandomization, PhysicsState


def _get(tree, key):
    return tree[key] if isinstance(tree, dict) else getattr(tree, key)


def _has(tree, key):
    return key in tree if isinstance(tree, dict) else hasattr(tree, key)


def _linears(seq):
    return [m for m in seq if isinstance(m, torch.nn.Linear)]


@torch.no_grad()
def _fill_stack(linears, pairs):
    if len(linears) != len(pairs):
        raise ValueError(f"{len(pairs)} layers given, the network has {len(linears)}")
    for lin, (w, b) in zip(linears, pairs):
        w = torch.as_tensor(np.asarray(w, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        if w.t().shape != lin.weight.shape or b.shape != lin.bias.shape:
            raise ValueError(f"shape {tuple(w.shape)} does not fit {lin}")
        lin.weight.copy_(w.t())
        lin.bias.copy_(b)


@torch.no_grad()
def actor_critic_from_numpy(net, tree):
    """Fill ``net`` (the port's ``ActorCritic``) from JAX params as numpy:
    ``tree.actor``/``tree.critic`` lists of (W (in, out), b) and ``tree.std``
    (attribute or dict access). Returns ``net``."""
    _fill_stack(_linears(net.actor), _get(tree, "actor"))
    _fill_stack(_linears(net.critic), _get(tree, "critic"))
    net.std_param.copy_(torch.as_tensor(np.asarray(_get(tree, "std"), np.float32)))
    return net


LSTM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


@torch.no_grad()
def load_actor_npz(net, path: str):
    """Fill the actor and std of ``net`` from a ``policy.npz`` in the
    ``export_policy_npz`` format (``actor_w{i}`` (in, out), ``actor_b{i}``,
    ``std``, and for a recurrent actor ``lstm{i}_w_ih`` ... in JAX's
    layout). Returns ``net``."""
    blob = np.load(path, allow_pickle=False)
    n_layers = sum(1 for k in blob.files if k.startswith("actor_w"))
    pairs = [(blob[f"actor_w{i}"], blob[f"actor_b{i}"]) for i in range(n_layers)]
    lstm = sorted(k for k in blob.files if k.startswith("lstm"))
    memory_a = getattr(net, "memories", lambda: ((), ()))()[0]
    if len(lstm) != 4 * len(memory_a):
        raise ValueError(f"{path}: LSTM keys {lstm} do not fit the net's {len(memory_a)} actor layers")
    for i, layer in enumerate(memory_a):
        for view, k in zip(layer, LSTM_KEYS):
            src = torch.as_tensor(np.asarray(blob[f"lstm{i}_{k}"], np.float32))
            if src.shape != view.shape:
                raise ValueError(f"{path}: lstm{i}_{k} is {tuple(src.shape)}, the net's {tuple(view.shape)}")
            view.copy_(src)
    _fill_stack(_linears(net.actor), pairs)
    net.std_param.copy_(torch.as_tensor(np.asarray(blob["std"], np.float32)))
    return net


def _jax_leaf_vector(tree):
    """JAX ``ActorCriticParams`` (or ``RecurrentParams``) as numpy -> its
    ``ravel_pytree`` vector."""
    leaves = []
    for stack in ("memory_a", "memory_c"):
        for layer in (_get(tree, stack) if _has(tree, stack) else ()):
            leaves += [np.asarray(_get(layer, k), np.float32).reshape(-1) for k in LSTM_KEYS]
    for stack in ("actor", "critic"):
        for w, b in _get(tree, stack):
            leaves += [np.asarray(w, np.float32).reshape(-1), np.asarray(b, np.float32).reshape(-1)]
    leaves.append(np.asarray(_get(tree, "std"), np.float32).reshape(-1))
    return np.concatenate(leaves)


def _reorder(net, vec, to_port: bool):
    vec = np.asarray(vec, np.float32).reshape(-1)
    if vec.shape != (net.num_params,):
        raise ValueError(f"expected {net.num_params} values, got {vec.shape[0]}")
    out = np.empty_like(vec)
    for name, off, shape in net.layout:
        x = vec[off: off + int(np.prod(shape))]
        if len(shape) == 2 and not name.startswith("memory"):   # heads: port (out, in) <-> JAX (in, out)
            x = (x.reshape(shape[1], shape[0]) if to_port else x.reshape(shape)).T.reshape(-1)
        out[off: off + x.size] = x
    return out


def flat_from_jax_order(net, vec):
    """A ``ravel_pytree`` vector of JAX ``ActorCriticParams`` (or of a tree
    shaped like it: Adam moments, gradients) -> numpy in ``net.layout``."""
    return _reorder(net, vec, to_port=True)


def flat_to_jax_order(net, flat):
    """The inverse of :func:`flat_from_jax_order` (numpy or a tensor in)."""
    if isinstance(flat, torch.Tensor):
        flat = flat.detach().cpu().numpy()
    return _reorder(net, flat, to_port=False)


@torch.no_grad()
def recurrent_from_numpy(net, tree):
    """Fill ``net`` (the port's ``ActorCriticRecurrent``) from JAX
    ``RecurrentParams`` as numpy (attribute or dict access). Returns ``net``."""
    net.params_flat.copy_(torch.as_tensor(flat_from_jax_order(net, _jax_leaf_vector(tree))))
    return net


def recurrent_to_numpy(net, flat=None):
    """``RecurrentParams`` as a numpy dict from the port's flat buffer (or
    ``flat``): ``memory_a``/``memory_c`` lists of {w_ih, w_hh, b_ih, b_hh},
    ``actor``/``critic`` lists of (W (in, out), b), ``std``."""
    vec = flat_to_jax_order(net, net.params_flat if flat is None else flat)
    leaf = {name: vec[off: off + int(np.prod(shape))].reshape(shape) for name, off, shape in net.layout}
    out = {}
    for stack in ("memory_a", "memory_c"):
        out[stack] = [{k: leaf[f"{stack}.{i}.{k}"] for k in LSTM_KEYS} for i in range(net.rnn_layers)]
    for stack in ("actor", "critic"):
        pairs = []
        for name, _, shape in net.layout:
            if name.startswith(stack + ".") and name.endswith(".weight"):
                w = leaf[name].reshape(shape[1], shape[0])   # JAX order: (in, out)
                pairs.append((w, leaf[name[: -len("weight")] + "bias"]))
        out[stack] = pairs
    out["std"] = leaf["std"]
    return out


def ppo_state_from_numpy(net, params, mu, nu, count, lr, device="cpu"):
    """The port's ``PPOState`` from the JAX side's numpy pieces: ``params``
    (``ActorCriticParams`` as numpy, attribute or dict access), the raveled
    optax Adam moments ``mu``/``nu`` (``PPO._opt_state_pieces``), the Adam
    count and the live learning rate."""
    from wiki_grx_gym_tpu_torch.learn.ppo import PPOState

    t = lambda a: torch.as_tensor(np.array(a), device=device)
    return PPOState(
        params=t(flat_from_jax_order(net, _jax_leaf_vector(params))),
        m=t(flat_from_jax_order(net, mu)),
        v=t(flat_from_jax_order(net, nu)),
        count=t(np.asarray(count, np.int32).reshape(())),
        learning_rate=t(np.asarray(lr, np.float32).reshape(())),
    )


def env_state_from_numpy(d, device="cpu", generator: torch.Generator = None):
    """A JAX ``EnvState`` flattened to numpy -> the port's ``EnvState``.

    ``d`` maps every ``EnvState`` field name to a numpy array, with
    ``physics`` and ``rand`` as dicts of their own fields; ``ground_plane``
    and ``measured_cache`` may be absent or None (the plane). ``rng`` (a JAX
    key) is not carried: the state gets ``generator`` (a fresh one on
    ``device``, seeded 0, if None). The host's step count is
    ``common_step``."""
    from wiki_grx_gym_tpu_torch.envs.legged_env import EnvState

    t = lambda a: torch.as_tensor(np.array(a), device=device)
    ph, rd = d["physics"], d["rand"]
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return EnvState(
        physics=PhysicsState(**{k: t(ph[k]) for k in (
            "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")}),
        rng=generator,
        episode_length=t(np.asarray(d["episode_length"], np.int32)),
        common_step=t(np.asarray(d["common_step"], np.int32)),
        commands=t(d["commands"]),
        actions=t(d["actions"]),
        last_actions=t(d["last_actions"]),
        last_last_actions=t(d["last_last_actions"]),
        last_dof_vel=t(d["last_dof_vel"]),
        torques=t(d["torques"]),
        feet_air_time=t(d["feet_air_time"]),
        feet_land_time=t(d["feet_land_time"]),
        feet_contact_last=t(np.asarray(d["feet_contact_last"], bool)),
        episode_sums=t(d["episode_sums"]),
        rand=BodyRandomization(**{k: t(rd[k]) for k in (
            "friction", "restitution", "base_mass_scale", "base_com_offset")}),
        motor_strength=t(d["motor_strength"]),
        env_origins=t(d["env_origins"]),
        terrain_levels=t(np.asarray(d["terrain_levels"], np.int32)),
        terrain_types=t(np.asarray(d["terrain_types"], np.int32)),
        cmd_lin_vel_x_range=t(d["cmd_lin_vel_x_range"]),
        ground_plane=None if d.get("ground_plane") is None else t(d["ground_plane"]),
        measured_cache=None if d.get("measured_cache") is None else t(d["measured_cache"]),
    )
