"""The plain reference's env step against the program's, on the CPU: from
the same state, actions and uniform draws (some envs timing out, a push
due), the program's step (K1's plain program on the CPU) and the
reference's give the same observations, critic observations, rewards and
resets, bit for bit, in both configurations; and a sample of envs steps as
the whole batch does."""

import json

import pytest
import torch

from benchmark import program, spec
from benchmark.reference.env import RefEnv

N = 32


class _Holder:
    pass


def _program_step(task: str, seed: int):
    from wiki_grx_gym_tpu_torch.envs import task_registry

    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = N
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device="cpu")
    g = env.make_generator(seed)
    st = env.init_state(g)
    k = env._step_u_cols[1]
    for _ in range(4):
        st, _ = env.step(st, 0.5 * torch.randn((N, env.num_actions), generator=g), u=torch.rand((N, k), generator=g))
    timed_out = torch.where(torch.arange(N) % 3 == 0, torch.full_like(st.episode_length, env.max_episode_length),
                            st.episode_length)
    st = st.replace(episode_length=timed_out, common_step=torch.tensor(env.push_interval - 1, dtype=torch.int32))
    holder = _Holder()
    holder.state = _Holder()
    holder.state.env_state = st
    before = program.Run.env_state(holder, torch.arange(N))
    actions = 0.5 * torch.randn((N, env.num_actions), generator=g)
    u = torch.rand((N, k), generator=g)
    _, out = env.step(st, actions, u=u)
    return before, actions, u, out


@pytest.mark.parametrize("name", ["gr1t1", "gr1t1_full"])
def test_the_reference_steps_as_the_program(name):
    config = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    before, actions, u, out = _program_step(config["task"], 7)
    env_cfg = json.loads(json.dumps(config["env_cfg"]))
    env_cfg["env"]["num_envs"] = N
    ref = RefEnv(env_cfg, N)
    want = ref.step(before, actions, u)
    assert int(out.reset.sum()) > 0
    assert torch.equal(want["reset"], out.reset)
    assert torch.equal(want["obs"], out.obs)
    assert torch.equal(want["critic_obs"], out.pri_obs)
    assert torch.equal(want["rew"], out.rew)
    # a sample of the envs steps as the batch does
    ids = torch.tensor([1, 4, 9, 30])
    part = {k: (v if k in ("common_step", "cmd_lin_vel_x_range") else v[ids]) for k, v in before.items()}
    some = ref.step(part, actions[ids], u[ids], env_ids=ids)
    assert torch.equal(some["obs"], want["obs"][ids]) and torch.equal(some["rew"], want["rew"][ids])
