"""The port's deploy runtime against the JAX package's (``deploy/runtime.py``).

JAX params are placed in the port's nets through ``convert`` (GR1T1's MLP
actor-critic, and a 2-layer, 64-hidden LSTM as in tests/test_deploy.py).
Then:

- the port's ``.grxpolicy`` is byte-identical to JAX's for the same weights;
- the port's ``NativePolicy`` gives JAX's ``NativePolicy`` outputs bit for
  bit on 64 seeded observations (the same C++ source, the same file);
- the native forward agrees with the port's CPU actor within rtol 1e-4 /
  atol 1e-5 (tests/test_deploy.py's limits: float32 sums in another order);
  the LSTM streamed for 20 steps, and again after ``reset()``;
- a bad magic number raises ``IOError``; the C++ sources are
  byte-identical copies (the header's comment naming the file's writer
  aside); the library is built under the checkout's
  ``build/`` directory, never in the JAX package's.
"""

import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.deploy import runtime as jax_runtime
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.recurrent import ActorCriticRecurrent as JaxRecurrent
from wiki_grx_gym_tpu_torch.convert import actor_critic_from_numpy, recurrent_from_numpy
from wiki_grx_gym_tpu_torch.deploy import runtime
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent

ROOT = Path(__file__).resolve().parents[1]
NATIVE_TOL = dict(rtol=1e-4, atol=1e-5)
STREAM = 20


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def lstm_cfgs():
    (_, jcfg), (_, tcfg) = jax_registry.get_cfgs("GR1T1_lstm"), torch_registry.get_cfgs("GR1T1_lstm")
    for p in (jcfg.policy, tcfg.policy):
        p.rnn_hidden_size = 64
        p.rnn_num_layers = 2
    return jcfg.policy, tcfg.policy


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{"mlp"/"lstm": (JAX net, JAX params, port net, JAX file, port file)}."""
    d = tmp_path_factory.mktemp("deploy")
    _, train_cfg = torch_registry.get_cfgs("GR1T1")
    jnet = JaxActorCritic(39, 168, 10, train_cfg.policy)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7))
    params = params.replace(std=params.std * jnp.linspace(0.5, 1.5, 10))
    tnet = actor_critic_from_numpy(ActorCritic(39, 168, 10, train_cfg.policy), _numpy(params))
    jcfg, tcfg = lstm_cfgs()
    jrnet = JaxRecurrent(39, 168, 10, jcfg)
    rparams = jrnet.init(jax.random.PRNGKey(11))
    trnet = recurrent_from_numpy(ActorCriticRecurrent(39, 168, 10, tcfg), _numpy(rparams))
    out = {}
    for kind, (jn, p, tn) in {"mlp": (jnet, params, tnet), "lstm": (jrnet, rparams, trnet)}.items():
        jpath, tpath = str(d / f"jax_{kind}.grxpolicy"), str(d / f"port_{kind}.grxpolicy")
        jax_runtime.export_policy_bin(p, jpath)
        runtime.export_policy_bin(tn, tpath)
        out[kind] = (jn, p, tn, jpath, tpath)
    return out


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_grxpolicy_is_byte_identical_to_jax(exported, kind):
    _, _, _, jpath, tpath = exported[kind]
    got, want = Path(tpath).read_bytes(), Path(jpath).read_bytes()
    assert struct.unpack("<II", got[:8]) == (runtime.MAGIC, 2 if kind == "lstm" else 1)
    assert got == want


def test_native_matches_jax_runtime_bit_for_bit(exported):
    _, _, _, jpath, tpath = exported["mlp"]
    obs = np.random.RandomState(0).randn(64, 39).astype(np.float32)
    got = runtime.NativePolicy(tpath)(obs)
    want = jax_runtime.NativePolicy(jpath)(obs)
    assert got.dtype == np.float32 and got.shape == (64, 10)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_native_matches_the_port_actor(exported):
    _, _, tnet, _, tpath = exported["mlp"]
    native = runtime.NativePolicy(tpath)
    assert (native.input_dim, native.output_dim, native.num_lstm_layers) == (39, 10, 0)
    obs = np.random.RandomState(1).randn(64, 39).astype(np.float32)
    with torch.no_grad():
        want = tnet.act_inference(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(native(obs), want, **NATIVE_TOL)
    single = native(obs[3])
    assert single.shape == (10,)
    np.testing.assert_allclose(single, want[3], **NATIVE_TOL)


def test_native_lstm_streams_the_port_policy(exported):
    """The native streaming forward against the port's stateful policy for
    20 steps, then ``reset()`` zeroes both memories and the stream replays."""
    _, _, tnet, _, tpath = exported["lstm"]
    native = runtime.NativePolicy(tpath)
    assert (native.input_dim, native.output_dim, native.num_lstm_layers) == (39, 10, 2)
    obs = np.random.RandomState(3).randn(STREAM, 39).astype(np.float32)

    def port_stream(n):
        hidden, out = tnet.initial_hidden(1), []
        with torch.no_grad():
            for t in range(n):
                a, hidden = tnet.act_inference_rnn(torch.from_numpy(obs[t: t + 1]), hidden)
                out.append(a[0].numpy())
        return np.stack(out)

    want = port_stream(STREAM)
    got = np.stack([native(obs[t]) for t in range(STREAM)])
    np.testing.assert_allclose(got, want, **NATIVE_TOL)
    assert not np.allclose(got[0], got[1])   # the memory moved
    native.reset()
    np.testing.assert_allclose(native(obs[:5]), want[:5], **NATIVE_TOL)   # a batch is a stream


def test_bad_magic_raises_ioerror(exported, tmp_path):
    _, _, _, _, tpath = exported["mlp"]
    blob = bytearray(Path(tpath).read_bytes())
    blob[:4] = struct.pack("<I", 0x12345678)
    bad = tmp_path / "bad.grxpolicy"
    bad.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="failed to load"):
        runtime.NativePolicy(str(bad))


# the header's comment names the writer of the file it reads: the port's own
# export in the port's copy; every other byte is the JAX package's
WRITER = {"policy_runtime.h": (
    "// (.grxpolicy, written by wiki_grx_gym_tpu.deploy.runtime.export_policy_bin)\n// and evaluates",
    "// (.grxpolicy, written by wiki_grx_gym_tpu_torch.deploy.runtime.export_policy_bin,\n"
    "// byte for byte the JAX package's format) and evaluates")}


@pytest.mark.parametrize("name", ["policy_runtime.cc", "policy_runtime.h"])
def test_native_sources_are_byte_identical_copies(name):
    jax_src = (ROOT / "wiki_grx_gym_tpu" / "deploy" / "native" / name).read_bytes()
    port_src = (runtime.NATIVE_DIR / name).read_bytes()
    if name in WRITER:
        jax_line, port_line = (x.encode() for x in WRITER[name])
        assert jax_src.count(jax_line) == 1 and port_src.count(port_line) == 1
        jax_src = jax_src.replace(jax_line, port_line)
    assert port_src == jax_src


def test_library_is_built_under_build():
    path = Path(runtime.ensure_library()).resolve()
    assert path.parent == (ROOT / "build" / "deploy").resolve()
    assert re.fullmatch(r"libgrxpolicy-[0-9a-f]{16}\.so", path.name), path.name
    assert path.is_file()


def test_a_library_of_another_machine_is_not_reused(monkeypatch):
    """The library's name changes with the machine (and so with a foreign
    build copied in): ``ensure_library`` then builds anew, never loads it."""
    here = runtime.library_path()
    runtime.library_path.cache_clear()
    monkeypatch.setattr(runtime.platform, "machine", lambda: "another-machine")
    try:
        assert runtime.library_path() != here and runtime.library_path().parent == here.parent
    finally:
        runtime.library_path.cache_clear()


def test_export_refuses_what_the_runtime_cannot_run():
    _, train_cfg = torch_registry.get_cfgs("GR1T1")
    train_cfg.policy.activation = "selu"
    with pytest.raises(ValueError, match="activation"):
        runtime.export_policy_bin(ActorCritic(39, 168, 10, train_cfg.policy), "unused.grxpolicy")
