"""Port parity for K1's plain version at the 32-DOF full body: the port's
``ScalarDecimation.run`` with ``LanePost`` through the ``cuda_step`` wrapper
on CPU tensors, against the JAX ``PallasDecimation(..., lanes=True)``,
``GR1T1_full`` (33 bodies, 32 dofs, 240 self-collision pairs), 4 envs,
decimation 2, delay on.

The JAX side runs eagerly (``jax.disable_jit()``): XLA on the CPU takes more
than 30 minutes to compile the 32-DOF program, and eagerly one call takes
seconds. The states are reachable ones (the port's env a few policy steps
after ``init_state`` at the task's decimation, feet on the ground) plus
seeded random actions, delays and post inputs, as numpy, fed to both sides.

Tolerances are tests/test_torch_decimation.py's (state rtol 1e-5 / atol
1e-5, point forces atol 1e-4 N, post lanes rtol 1e-4 / atol 1e-5, booleans
exact), each widened by 3x the float32 noise floor of the port on the same
input (its float32 result against its float64 result), as there. The CUDA
kernel itself is held against this plain version on the card by
chip_smoke.py, and its team kernel against its one-thread kernel on the CPU
by tests/test_torch_full_body_race.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decimation import BOOL, PHYS, PHYS_GROUPS, POST, RAND, check_group, groups, run_port
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim.engine import BodyRandomization as JRand
from wiki_grx_gym_tpu.sim.engine import PhysicsState as JPhys
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step

TASK = "GR1T1_full"
N, DECIMATION, WARM_STEPS = 4, 2, 4


@pytest.fixture(scope="module")
def case():
    """(JAX output, port output, port float64 output, port wrapper)."""
    tc, _ = torch_registry.get_cfgs(TASK)
    tc.env.num_envs = N
    tenv, _ = torch_registry.make_env(TASK, env_cfg=tc, device="cpu")
    g = torch.Generator().manual_seed(0)
    s = tenv.init_state(g)
    for _ in range(WARM_STEPS):
        s, _ = tenv.step(s, 0.3 * torch.randn(N, tenv.num_actions, generator=g))
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    nd = tenv.num_actions
    phys = {k: getattr(s.physics, k).numpy().copy() for k in PHYS}
    rand = {k: getattr(s.rand, k).numpy().copy() for k in RAND}
    inputs = dict(
        actions=f32(np.clip(rng.randn(N, nd) * 0.3, tenv.clip_actions_min, tenv.clip_actions_max)),
        last_actions=s.last_actions.numpy().copy(),
        motor=s.motor_strength.numpy().copy(),
        delay=f32(rng.rand(N) * 3.0),
        last_qd=s.last_dof_vel.numpy().copy(),
    )
    extra = dict(
        commands=f32(rng.uniform(-1, 1, (N, 3))),
        last_last_actions=f32(rng.randn(N, nd) * 0.3),
        feet_air_time=f32(rng.rand(N, 2) * 0.6),
        feet_land_time=f32(rng.rand(N, 2) * 1.2),
        feet_contact_last=f32(rng.rand(N, 2) > 0.5),
    )

    jc, _ = jax_registry.get_cfgs(TASK)
    jc.env.num_envs = N
    jc.sim.use_pallas = "lanes"
    jc.control.decimation = DECIMATION
    with jax.disable_jit():
        jenv, _ = jax_registry.make_env(TASK, env_cfg=jc)
        pall = jenv._pallas_decimation
        assert pall.lanes and pall.post is not None
        jt = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        ji, jr = jt(inputs), jt(rand)
        want = jax.device_get(pall(JPhys(**jt(phys)), ji["actions"], ji["last_actions"], ji["motor"],
                                   ji["delay"], JRand(**jr), last_qd=ji["last_qd"], extra=jt(extra)))

    tc.control.decimation = DECIMATION
    op = torch_registry.make_env(TASK, env_cfg=tc, device="cpu")[0].decimation_op
    assert op.deci.decimation == pall.deci.decimation == DECIMATION
    assert op.in_schema == pall.in_schema and op.out_schema == pall.out_schema
    port_inputs = (phys, rand, inputs, extra)
    cuda_step.reset_launch_counts()
    got = run_port(op, port_inputs, torch.float32)
    assert cuda_step.LAUNCHES["k1"] == 0   # CPU tensors never launch the kernel
    return want, got, run_port(op, port_inputs, torch.float64), op


def test_full_body_program_sizes(case):
    op = case[3]
    assert op.sizes == cuda_step.K1Sizes(NB=33, ND=32, NP=29, NF=2, NPAIR=240, NR=24, NPOST=4,
                                         NIN=340, NOUT=374, TERRAIN=0, FOLD=1, CTRL=0, NPEN=0,
                                         NPENP=0)
    assert op.kernel_support_error() is None
    assert op.team == cuda_step.TEAM_SHAPE_FULL_BODY
    # dof 31's ancestors reach bit 31 of its 32-bit mask
    masks = cuda_step.team_lists(op.deci.sub)["anc_mask"]
    assert max(masks) < 2**32 and any(m >> 31 for m in masks)
    k = cuda_step._make_constants(op.deci, op.in_off, op.out_off, op.c_in, op.c_out)
    assert list(k.anc_mask) == masks


def test_full_body_states_have_feet_in_contact(case):
    assert float(case[1][8]["feet_contact"].sum()) >= N // 2


@pytest.mark.parametrize("name", PHYS_GROUPS + ["post/" + k for k in POST])
def test_full_body_output_group_matches(case, name):
    check_group(case[:3], name)


def test_full_body_checks_every_boolean_group(case):
    assert BOOL <= {"post/" + k for k in POST}
    assert set(groups(case[1])) == set(PHYS_GROUPS) | {"post/" + k for k in POST}
