"""K2's plain version (``FusedPPOGrad.grads_plain``) and the xla path's loss
against the JAX package.

- ``grads_plain`` against the JAX ``FusedPPOGrad.grads`` (f32 operands,
  interpreter mode, as tests/test_fused_update.py runs it) and against
  ``jax.value_and_grad(PPO._minibatch_loss)``, at hidden (64, 32) and 23
  actions, in four cases: 300 rows in tiles of 128 (a partial last tile), a
  fixed std, the unclipped value loss, and a NaN advantage (the loss that the
  update's NaN skip catches; NaNs must sit in the same places). Tolerances
  are those of tests/test_fused_update.py:104-121 (loss rtol 2e-5, kl rtol
  2e-4, each gradient leaf rtol 5e-4 with atol 5e-6 x its largest value):
  the sums run in another order.
- The tie conventions: ``jnp.maximum`` and ``jnp.clip`` give gradient 0.5 at
  a tie, ``torch.clamp`` 1 at the boundary; the port's ``_jmax``/``_jclip``
  must give JAX's, and the xla path's loss (``PPO._minibatch_loss`` under
  torch.autograd) must match ``jax.value_and_grad`` with the std exactly at
  its floor, where ``max(std, floor)`` ties.

On CPU tensors the wrapper runs the plain version and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.fused_update import FusedPPOGrad as JaxFused
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.networks import ActorCriticParams
from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO
from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.convert import flat_from_jax_order, flat_to_jax_order
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad, _jclip, _jmax
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO

O, P, A = 39, 168, 23


def make_nets(hidden=(64, 32), fixed_std=False, floor=0.0, clipped_vl=True):
    out = []
    for reg, cls in ((jax_registry, JaxActorCritic), (task_registry, ActorCritic)):
        _, train_cfg = reg.get_cfgs("GR1T1")
        pc = train_cfg.policy
        pc.actor_hidden_dims = list(hidden)
        pc.critic_hidden_dims = list(hidden)
        pc.fixed_std = fixed_std
        pc.noise_std_floor = floor
        train_cfg.algorithm.use_clipped_value_loss = clipped_vl
        out += [cls(O, P, A, pc), train_cfg.algorithm]
    return out   # jax net, jax alg cfg, port net, port alg cfg


def make_params(rng, hidden, std):
    """JAX ActorCriticParams (numpy-made, torch-default init ranges)."""
    def stack(dims):
        pairs = []
        for i, o in zip(dims[:-1], dims[1:]):
            bound = 1.0 / np.sqrt(i)
            pairs.append((jnp.asarray(rng.uniform(-bound, bound, (i, o)).astype(np.float32)),
                          jnp.asarray(rng.uniform(-bound, bound, o).astype(np.float32))))
        return pairs
    return ActorCriticParams(actor=stack([O, *hidden, A]), critic=stack([P, *hidden, 1]),
                             std=jnp.asarray(std, jnp.float32))


def make_minibatch(rng, rows):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return {
        "obs": f(rows, O), "critic_obs": f(rows, P),
        "actions": 0.3 * f(rows, A), "log_prob": 0.5 * f(rows) + 20.0,
        "mu": 0.3 * f(rows, A),
        "sigma": rng.uniform(0.15, 0.3, (rows, A)).astype(np.float32),
        "values": f(rows), "returns": f(rows), "advantages": f(rows),
    }


def fscal(mb):
    col = lambda x: x[:, None]
    return np.concatenate([mb["actions"], col(mb["log_prob"]), mb["mu"], mb["sigma"],
                           col(mb["values"]), col(mb["returns"]), col(mb["advantages"])], axis=-1)


CASES = {
    "partial_tile": dict(rows=300, tile=128),
    "fixed_std": dict(rows=200, tile=128, fixed_std=True),
    "unclipped_value_loss": dict(rows=200, tile=128, clipped_vl=False),
    "nan_loss": dict(rows=200, tile=128, nan_row=5),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    rows, tile = c["rows"], c["tile"]
    fixed = c.get("fixed_std", False)
    jnet, jalg, tnet, talg = make_nets(fixed_std=fixed, clipped_vl=c.get("clipped_vl", True))
    rng = np.random.RandomState(sorted(CASES).index(request.param))
    std = np.full(A, 0.2) if fixed else 0.2 + 0.1 * np.arange(A) / A
    params = make_params(rng, (64, 32), std)
    mb = make_minibatch(rng, rows)
    if "nan_row" in c:
        mb["advantages"][c["nan_row"]] = np.nan
    jppo = JaxPPO(jnet, jalg)
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(jppo._minibatch_loss, has_aux=True)(
        params, jmb, None)
    jfused = JaxFused(jnet, clip_param=jppo.clip_param, value_loss_coef=jppo.value_loss_coef,
                      entropy_coef=jppo.entropy_coef,
                      use_clipped_value_loss=jppo.use_clipped_value_loss, rows=rows,
                      num_mini_batches=1, tile=tile, op_dtype=jnp.float32, interpret=True)
    kbufs = dict(obs=jnp.asarray(mb["obs"])[None], cobs=jnp.asarray(mb["critic_obs"])[None],
                 fscal=jnp.asarray(fscal(mb))[None])
    k_loss, k_grads, k_aux = jfused.grads(params, kbufs, 0)

    tppo = PPO(tnet, talg)
    fused = FusedPPOGrad(tnet, clip_param=tppo.clip_param, value_loss_coef=tppo.value_loss_coef,
                         entropy_coef=tppo.entropy_coef,
                         use_clipped_value_loss=tppo.use_clipped_value_loss, rows=rows,
                         num_mini_batches=1, tile=tile, op_dtype=torch.float32)
    p = torch.from_numpy(flat_from_jax_order(tnet, ravel_pytree(params)[0]))
    wide = torch.from_numpy(np.concatenate([mb["obs"], mb["critic_obs"]], axis=-1))[None]
    bufs = fused.split_buffers(wide, torch.from_numpy(fscal(mb))[None], O)
    before = LAUNCHES["k2"]
    loss, g, aux = fused.grads(p, bufs, 0)              # CPU tensors: the plain version
    assert LAUNCHES["k2"] == before
    plain = fused.grads_plain(p, bufs, 0)
    torch.testing.assert_close(plain[1], g, rtol=0, atol=0, equal_nan=True)
    return dict(
        port=(float(loss), flat_to_jax_order(tnet, g), {k: float(v) for k, v in aux.items()}),
        kernel=(float(k_loss), np.asarray(ravel_pytree(k_grads)[0]),
                {k: float(v) for k, v in k_aux.items()}),
        autodiff=(float(ref_loss), np.asarray(ravel_pytree(ref_grads)[0]),
                  {k: float(v) for k, v in ref_aux.items()}),
        layout=tnet.layout, nan="nan_row" in c,
    )


@pytest.mark.parametrize("ref", ["kernel", "autodiff"])
def test_grads_plain_matches_jax(case, ref):
    loss, g, aux = case["port"]
    r_loss, r_g, r_aux = case[ref]
    if case["nan"]:
        assert np.isnan(loss) and np.isnan(r_loss)
    np.testing.assert_allclose(loss, r_loss, rtol=2e-5)
    np.testing.assert_allclose(aux["kl"], r_aux["kl"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(aux["value_loss"], r_aux["value_loss"], rtol=2e-5)
    np.testing.assert_allclose(aux["surrogate_loss"], r_aux["surrogate_loss"], rtol=2e-5, atol=1e-7)
    for name, off, shape in case["layout"]:
        sl = slice(off, off + int(np.prod(shape)))
        r = r_g[sl]
        finite = r[np.isfinite(r)]
        scale = max(1e-6, float(np.abs(finite).max())) if finite.size else 1.0
        np.testing.assert_allclose(g[sl], r, rtol=5e-4, atol=5e-6 * scale,
                                   err_msg=f"gradient of {name} vs the JAX {ref}")


# ---------------------------------------------------------------------------
# tie conventions (ROADMAP queue 3): JAX's 0.5, not torch.clamp's 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,x", [
    ("clip", 0.8), ("clip", 1.2), ("clip", 1.0), ("clip", 1.5),
    ("max", 0.3), ("max", 0.2), ("max", 0.4),
])
def test_tie_conventions_match_jax(fn, x):
    if fn == "clip":
        jf, tf = (lambda v: jnp.clip(v, 0.8, 1.2)), (lambda v: _jclip(v, 0.8, 1.2))
    else:
        jf, tf = (lambda v: jnp.maximum(v, 0.3)), (lambda v: _jmax(v, 0.3))
    want = float(jax.grad(jf)(jnp.float32(x)))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    (got,) = torch.autograd.grad(tf(xt), xt)
    assert float(got) == want
    assert float(tf(xt).detach()) == float(jf(jnp.float32(x)))


def test_xla_loss_matches_autodiff_with_std_at_its_floor():
    """The xla path's loss and its torch.autograd gradient against
    jax.value_and_grad of the JAX loss, with the floor at 0.3 and half the
    std entries exactly at it (a max(std, floor) tie)."""
    jnet, jalg, tnet, talg = make_nets(floor=0.3)
    rng = np.random.RandomState(17)
    std = np.where(np.arange(A) % 2 == 0, 0.3, 0.35).astype(np.float32)
    params = make_params(rng, (64, 32), std)
    mb = make_minibatch(rng, 150)
    jppo, tppo = JaxPPO(jnet, jalg), PPO(tnet, talg)
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(jppo._minibatch_loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in mb.items()}, None)
    p = torch.from_numpy(flat_from_jax_order(tnet, ravel_pytree(params)[0])).requires_grad_(True)
    loss, aux = tppo._minibatch_loss(p, {k: torch.from_numpy(v) for k, v in mb.items()})
    (g,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    for k in ("value_loss", "surrogate_loss", "kl"):
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=2e-5, atol=1e-7)
    ref = np.asarray(ravel_pytree(ref_grads)[0])
    got = flat_to_jax_order(tnet, g)
    for name, off, shape in tnet.layout:
        sl = slice(off, off + int(np.prod(shape)))
        np.testing.assert_allclose(got[sl], ref[sl], rtol=5e-4,
                                   atol=5e-6 * max(1e-6, float(np.abs(ref[sl]).max())),
                                   err_msg=name)
