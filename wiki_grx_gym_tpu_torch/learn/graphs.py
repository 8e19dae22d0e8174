"""CUDA graphs over static, donated buffers: the port's counterpart of JAX's
``jax.jit`` with buffer donation.

The JAX package compiles three things once and then calls them: the
training iteration (``wiki_grx_gym_tpu/learn/runner.py:134``,
``jax.jit(self._iteration, donate_argnums=(0,))``: the whole iteration is
one call, and the state's buffers are reused for the new state), the env
step (``envs/legged_env.py:1503``, ``step_jit``, which play steps through)
and the bench's rollout (root ``bench.py:124``, ``rollout_jit``). Here each
is a ``torch.cuda.CUDAGraph``:

- **The static state** (:func:`make_static`): a copy of every tensor of a
  state tree (``RunnerState``, ``EnvState``, ``PPOState`` and what they
  hold), made once; its generators are the state's own. :func:`copy_in`
  copies a state into it leaf by leaf, skipping the leaves that are the
  static ones themselves, so the state a call returned goes back in for
  free; a static generator takes the seed and offset of another generator
  given in its place.
- **A graph** (:class:`Graph`) of one body ``() -> (new state, outputs)``
  over the static state. Its first call runs the body eagerly on a side
  stream: the warm-up that a capture needs (every kernel loaded, every
  cache of the port filled) and that call's real result, its kernel
  launches counted as any eager call's. Then the capture: the state's
  generators registered with the graph (``register_generator_state``: each
  replay draws from, and advances, their current seed and offset), the
  kernel wrappers' launches collected in a ``build.LaunchTally``, the body,
  and the copy of the new state into the static state (the donation); then
  ``instantiate``. Every later call is one replay, which adds the tally to
  ``build.LAUNCHES``. A failed warm-up, capture, instantiation or replay
  raises; nothing runs the body eagerly instead.
- **The iteration** (:class:`CompiledIteration`, ``OnPolicyRunner._train_iter``):
  graph replays over one static ``RunnerState``, for every config on K1 or
  the engine in one process, and under data and tensor parallelism over
  NCCL (JAX's ``jit(_iteration)`` on its ``("dp", "mp")`` mesh, the
  collectives compiled into the program; across ranks the rule takes
  the graphs runs on several cards have held, ``mesh.COMPILED_COLLECTIONS``
  and ``COMPILED_UPDATES``, though the graphs capture every path's
  collectives). (A) the collection: T x (act -> ``env.step``
  -> store), the last values, GAE, the permutation and the update's
  inputs; the new env state, observations and (recurrent) LSTM memory are
  donated into the static state, the metrics' sums into a static vector.
  A has one graph per source of draws: the generators (``learn``), or
  noise, u and a permutation copied into static buffers (the checks). Its
  form follows a static rule, the env's physics backend:

  - K1 (``"kernel"``): one graph of the whole collection (a step is
    ~300-1,000 kernels);
  - the engine (``"engine"``, ``cfg.sim.use_pallas = False``): a step is
    ~26k kernels, so T steps would be a ~1.7M-node graph. (A1) one rollout
    step's graph (``OnPolicyRunner.rollout_step``) over the static state, a
    static ``Transition`` buffer and static ``acc`` sums, the step index on
    the device: the step's noise and u read at the index (injected), its
    fields written at it (``index_copy_``), the index advanced; replayed T
    times. (A2) the collection's tail: the last values, GAE, the update's
    inputs and the metrics' sums, then the sums and the index zeroed for
    the next collection. The recurrent start memory (``hidden0``) is
    copied eagerly before A1's first replay.

  (B) the update over
  the static ``PPOState`` (p, m, v, count and LR written in place), by
  path:

  - mega (K3): K3's update graph (``FusedPPOGrad.donated_update``), A
    staging its inputs (the packed shuffle) into K3's context;
  - step (K2 a grad step) and xla (autograd of the loss; with an extra
    loss term such as the symmetry loss, ``remat_update``, the bf16 update
    dtype): one graph of the whole update, every grad step unrolled with
    its host minibatch index ``s % MB``, then the metrics; A writes the
    packed shuffle into static buffers, the step path stages it into K2's
    persistent context (``FusedPPOGrad.step_context``);
  - recurrent (``PPO.update_recurrent``, autograd over the LSTM replay):
    one grad step's graph, replayed epochs x minibatches times (the whole
    update would be ~1.6M nodes), the step index on the device (minibatch
    ``index % MB``, the index advanced by the graph), each step's losses
    into a static (steps, 3) history; then a graph of the metrics. A copies
    the static memory into a static ``hidden0`` first (the replay's start
    memory, JAX's ``hidden0 = state.hidden``) and writes the env
    permutation's columns and the replay's fields into static buffers.

  CUDA events between A and B time the two; one synchronize ends the
  iteration. On K1, marks captured in A split its time into the actor, the
  env, K1, GAE and the shuffle (``learn/spans.py``); ``last_timing`` is read
  lazily, after the call. The host's steps are ``torch.profiler`` ranges
  (``CompiledIteration.copy_in``, ``stage_draws``, ``launch_collection``,
  ``launch_update``, ``wait``, ``read_spans``).

  **Collectives** (``parallel/mesh.py``, NCCL): each graph captures the
  collectives its body issues, on every rank in the same order as the
  eager ``iteration``: the command curriculum's all-reduce in the env
  step (A, A1), GAE's two all-reduces, under the global shuffle the
  all-gather of the update's inputs (``PPO._gather``: K3's and K2's
  contexts, the static buffers and the recurrent start memories are then
  the global batch's) and the broadcast of rank 0's block permutation (A,
  A2), and in B each grad step's all-reduce of (gradient, loss, metrics)
  (``PPO.reduce``; none under the global shuffle), under mp the forward's
  and backward's all-reduces (``learn/networks.py``) and the clip norm's, then the metric
  sums' all-reduce ahead of the metrics vector (``runner.global_sums``).
  The warm-up's collectives make every group's communicator before its
  capture. The ranks' digest check (``learn``) runs eagerly between the
  replays, on the same communicators. Every capture runs in the
  ``"thread_local"`` error mode (``fused_update.CAPTURE_ERROR_MODE``), and
  Python's garbage collector is held off during it (``build.gc_held``).
- **The env step** (:class:`StepGraph`, ``LeggedEnv.step_graph``) and the
  bench's rollout (:meth:`CompiledIteration.rollout`, not donated: each
  replay starts from the static state, as ``rollout_jit`` from its input).

This module imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from wiki_grx_gym_tpu_torch import build as _build
from wiki_grx_gym_tpu_torch.learn.fused_update import CAPTURE_ERROR_MODE
from wiki_grx_gym_tpu_torch.learn.ppo import PPOState
from wiki_grx_gym_tpu_torch.learn.spans import Spans, Timing
from wiki_grx_gym_tpu_torch.parallel import mesh as _mesh


# ---------------------------------------------------------------------------
# state trees: dataclasses, named tuples, tuples, dicts of tensors,
# generators and None
# ---------------------------------------------------------------------------


def _children(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, tuple):
        names = getattr(x, "_fields", None) or [str(i) for i in range(len(x))]
        return list(zip(names, x))
    if isinstance(x, dict):
        return [(str(k), v) for k, v in x.items()]
    return None


def leaves(tree, prefix: str = ""):
    """``[(path, leaf)]`` of a state tree in a fixed order: every tensor,
    generator and None (and any other leaf) with its dotted path."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += leaves(child, f"{prefix}.{name}" if prefix else name)
    return out


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf (the rest kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        vals = [map_tensors(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def generators(tree) -> List[torch.Generator]:
    """The distinct generators of a state tree, in leaf order."""
    out = []
    for _, x in leaves(tree):
        if isinstance(x, torch.Generator) and all(x is not g for g in out):
            out.append(x)
    return out


def make_static(tree):
    """The static copy of a state tree: each tensor cloned into a fresh
    contiguous buffer; generators, None and the rest kept as they are."""
    return map_tensors(lambda t: t.clone(memory_format=torch.contiguous_format), tree)


def _pairs(static, tree, what: str):
    a, b = leaves(static), leaves(tree)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise ValueError(f"{what}: the state's fields {[p for p, _ in b]} are not the static state's "
                         f"{[p for p, _ in a]}")
    return [(p, s, x) for (p, s), (_, x) in zip(a, b)]


def _check_leaf(path, dst, src, what):
    if dst is None or src is None:
        if dst is not src:
            raise ValueError(f"{what}: {path} is {type(src).__name__}, the static state's "
                             f"{type(dst).__name__}")
        return False
    if torch.is_tensor(dst):
        if not torch.is_tensor(src) or src.shape != dst.shape or src.dtype != dst.dtype \
                or src.device != dst.device:
            desc = (f"{src.dtype} {tuple(src.shape)} on {src.device}" if torch.is_tensor(src)
                    else type(src).__name__)
            raise ValueError(f"{what}: {path} is {desc}, the static buffer "
                             f"{dst.dtype} {tuple(dst.shape)} on {dst.device}")
        return src is not dst
    if isinstance(dst, torch.Generator):
        if not isinstance(src, torch.Generator) or src.device != dst.device:
            raise ValueError(f"{what}: {path} is not a generator on {dst.device}")
        return src is not dst
    if src != dst:
        raise ValueError(f"{what}: {path} is {src!r}, the static state's {dst!r}")
    return False


def copy_in(static, tree):
    """Copy ``tree`` into the static state: each tensor leaf that is not the
    static buffer itself (same shape, type and device, else ValueError),
    and each generator that is not the static one (its seed and offset)."""
    for path, dst, src in _pairs(static, tree, "copy_in"):
        if _check_leaf(path, dst, src, "copy_in"):
            if torch.is_tensor(dst):
                dst.copy_(src)
            else:
                dst.set_state(src.get_state())


def donate(static, new):
    """Copy the new state ``new`` (a body's result) into the static state,
    as donation reuses the input's buffers: each tensor leaf that is not the
    static buffer itself. A generator must be the static one (the body
    draws from it in place), and no new leaf may share memory with another
    static buffer (it could be overwritten before it is read)."""
    pairs = _pairs(static, new, "donate")
    storages = {}
    for path, dst, _ in pairs:
        if torch.is_tensor(dst):
            storages[dst.untyped_storage().data_ptr()] = path
    for path, dst, src in pairs:
        if isinstance(dst, torch.Generator) and src is not dst:
            raise ValueError(f"donate: {path} is another generator than the static state's")
        if _check_leaf(path, dst, src, "donate"):
            other = storages.get(src.untyped_storage().data_ptr())
            if other is not None:
                raise ValueError(f"donate: the new {path} shares memory with the static {other}")
    for path, dst, src in pairs:
        if torch.is_tensor(dst) and src is not dst:
            dst.copy_(src)


# ---------------------------------------------------------------------------
# one graph
# ---------------------------------------------------------------------------


class Graph:
    """A CUDA graph of ``body`` over the static state ``static``: the first
    call warms up (eagerly, on a side stream, donating) and captures, every
    later call replays. ``body() -> (new state or None, outputs)``; with
    ``donate`` the new state is copied into ``static`` at the end of each
    run. ``count_nodes``: optional ``fn(CUDAGraph) -> dict`` recording the
    captured graph's size. The capture's error mode is
    ``fused_update.CAPTURE_ERROR_MODE``. Records ``warmup_ms``, ``capture_ms``,
    ``instantiate_ms``, ``replays``, the warm-up's kernel launches, the
    capture's tally and the collectives it captured (``parallel.mesh.CAPTURED``).
    ``spans``: a ``spans.Spans`` installed while the body is captured (its
    marks then replay with the graph), or None."""

    def __init__(self, name: str, body, static, donate: bool = True, count_nodes=None, spans=None):
        self.name, self.body, self.static, self.donate = name, body, static, donate
        self.spans = spans
        self.generators = generators(static)
        self.count_nodes = count_nodes
        self.graph = None
        self.outputs = None
        self.tally = None
        self.nodes = None
        self.collectives = None
        self.replays = 0
        self.warmup_ms = self.capture_ms = self.instantiate_ms = None
        self.warmup_launches = None

    def recording(self):
        """The context of the run the graph keeps: its spans installed."""
        return contextlib.nullcontext() if self.spans is None else self.spans.recording()

    def _run(self):
        new, out = self.body()
        if self.donate:
            donate(self.static, new)
        return out

    def __call__(self):
        if self.graph is None:
            out = self._warm_up()
            self._capture()
            return out
        self.graph.replay()
        self.tally.replayed()
        self.replays += 1
        return self.outputs

    def _warm_up(self):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            out = self._run()
        main.wait_stream(side)
        torch.cuda.synchronize()
        self.warmup_ms = 1e3 * (time.perf_counter() - t0)
        self.warmup_launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state): the graph would replay the same draws")
        for g in self.generators:
            graph.register_generator_state(g)
        before = dict(_mesh.CAPTURED)
        with _build.capture_tally() as tally, _build.gc_held():
            with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE), self.recording():
                t0 = time.perf_counter()
                out = self._run()
                t1 = time.perf_counter()
        graph.instantiate()
        self.instantiate_ms = 1e3 * (time.perf_counter() - t1)
        self.capture_ms = 1e3 * (t1 - t0)
        self.collectives = _captured_since(before)
        self.graph, self.tally, self.outputs = graph, tally, out
        if self.count_nodes is not None:
            self.nodes = self.count_nodes(graph)

    def release(self):
        """Destroy the captured graph (the next call warms up and captures
        again)."""
        _release(self)

    def report(self) -> dict:
        """What the graph cost to make and what it holds."""
        return {"name": self.name, "warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
                "instantiate_ms": self.instantiate_ms, "replays": self.replays,
                "warmup_launches": self.warmup_launches,
                "launches_per_replay": None if self.tally is None else dict(self.tally.counts),
                "nodes": self.nodes, "collectives": self.collectives}


def _release(holder):
    """Destroy ``holder.graph`` (a ``torch.cuda.CUDAGraph`` or None)."""
    if holder is not None and holder.graph is not None:
        holder.graph.reset()
        holder.graph = None


def _captured_since(before) -> Dict[str, int]:
    """The collectives captured since ``before`` (a copy of ``CAPTURED``)."""
    return {k: n - before.get(k, 0) for k, n in _mesh.CAPTURED.items() if n != before.get(k, 0)}


# CUgraphNodeType (cuda.h)
_NODE_TYPES = {0: "kernels", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty", 6: "wait_event",
               7: "event_record", 8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
_COOPERATIVE = 2   # CU_LAUNCH_ATTRIBUTE_COOPERATIVE (cuda.h)


def node_kinds(graph) -> Dict[str, int]:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by type, child graphs' included, and among the
    kernel nodes those launched cooperatively (``cooperative``: K3's steps)
    and those of NCCL (``nccl_kernels``: a function name holding ``nccl``),
    read through the CUDA driver (``cuGraphGetNodes``,
    ``cuGraphKernelNodeGetAttribute``, ``cuFuncGetName``). Raises if the
    driver refuses a call."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or cu.cuGraphKernelNodeGetParams

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"node_kinds: {what} returned CUresult {err}")

    out: Dict[str, int] = {"kernels": 0, "cooperative": 0, "nccl_kernels": 0}

    def walk(g):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            t = ctypes.c_int(0)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)), "cuGraphNodeGetType")
            kind = _NODE_TYPES.get(t.value, f"type {t.value}")
            out[kind] = out.get(kind, 0) + 1
            if kind == "kernels":
                attr = ctypes.c_int * 16   # CUlaunchAttributeValue (64 bytes), .cooperative first
                coop = attr()
                check(cu.cuGraphKernelNodeGetAttribute(ctypes.c_void_p(node), _COOPERATIVE, coop),
                      "cuGraphKernelNodeGetAttribute")
                out["cooperative"] += bool(coop[0])
                buf = (ctypes.c_char * 256)()   # CUDA_KERNEL_NODE_PARAMS: the CUfunction first
                check(params(ctypes.c_void_p(node), buf), "cuGraphKernelNodeGetParams")
                name = ctypes.c_char_p()
                func = ctypes.c_void_p.from_buffer(buf).value
                if func and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) == 0 and name.value \
                        and b"nccl" in name.value.lower():
                    out["nccl_kernels"] += 1
            elif kind == "graph":
                child = ctypes.c_void_p()
                check(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node), ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                walk(child)

    walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return out


# ---------------------------------------------------------------------------
# the training iteration
# ---------------------------------------------------------------------------


class CompiledIteration:
    """``OnPolicyRunner._train_iter``'s graphs and static state (the module
    docstring's "the iteration"). Made from the first state it is given;
    ``runner.eager_reason`` must be None (the runner checks). ``path``: the
    update's, ``"mega"``, ``"step"``, ``"xla"`` or ``"recurrent"``."""

    def __init__(self, runner, state):
        self.runner = runner
        self.static = make_static(state)
        env, alg = runner.env, runner.alg
        dev = runner.device
        self.path = "recurrent" if runner.recurrent else alg.path
        self.steps = alg.num_learning_epochs * alg.num_mini_batches
        self.sums = torch.zeros(4 + len(env.all_reward_names), device=dev)   # the metrics' sums (A)
        self.collect: Dict[str, Graph] = {}   # "draw" / "inject" -> graph A (K1) or A1 (the engine)
        # the engine: A1 a rollout step over these, replayed T times, then A2
        self.per_step = env.backend == "engine"
        self.tail: Dict[str, Graph] = {}      # "draw" / "inject" -> graph A2
        if self.per_step:
            self.buf, self.acc = runner.rollout_buffers(state)
            self.rollout_index = torch.zeros(1, dtype=torch.long, device=dev)   # the step, on the device
        # graph B: K3's donated update context (mega, made in A's warm-up),
        # the whole update's Graph (step, xla) or one grad step's (recurrent)
        self.update = None
        self.epilogue = None  # recurrent: the metrics after the last grad step (a graph)
        self.fused = None
        self.k2 = None       # the step path's K2 context (FusedPPOGrad.step_context)
        self.inputs = None   # the update's inputs in static buffers (step, xla, recurrent), written by A
        self.dims = None     # step, xla: (rows a minibatch, obs width, action width)
        self.inject = None   # the injected noise, u and perm (static buffers)
        self.metric_keys = None
        self.metrics = None  # the (K,) metrics vector of the last update
        self.update_collectives = None   # mega: the collectives K3's graph captured (its epilogue's)
        self.last = None     # the last call's collection outputs
        self.calls = 0       # the calls made (last_timing reads its own call's marks)
        self._rollout = None
        if runner.dp is not None and dev.type == "cuda":   # the graphs go before the group (mesh.destroy)
            _mesh.hold(self)
        if self.path == "recurrent":
            self.hidden0 = make_static(state.hidden)   # the replay's start memory (JAX's hidden0)
            self.step_index = torch.zeros(1, dtype=torch.long, device=dev)   # the grad step, on the device
            self.hist = torch.zeros((self.steps, 3), device=dev)   # each step's (value, surrogate, KL)

    def release(self):
        """Destroy every captured graph (a later call captures again)."""
        for g in (*self.collect.values(), *self.tail.values(), self.update, self.epilogue, self._rollout):
            _release(g)

    def reports(self) -> List[dict]:
        out = [g.report() for g in (*self.collect.values(), *self.tail.values())]
        if self.path == "mega":
            if self.update is not None and self.update.graph is not None:
                out.append({"name": "update (K3, donated)", "capture_ms": self.update.capture_ms,
                            "instantiate_ms": self.update.instantiate_ms, "nodes": self.update.nodes,
                            "collectives": self.update_collectives})
        else:
            out += [g.report() for g in (self.update, self.epilogue) if g is not None]
        if self._rollout is not None:
            out.append(self._rollout.report())
        return out

    # -- graph A ---------------------------------------------------------------

    def _collection_body(self, mode):
        runner, s = self.runner, self.static

        def body():
            inj = self.inject if mode == "inject" else {}
            if runner.spans is not None:
                runner.spans("actor")
            with torch.no_grad():
                if self.path == "recurrent":
                    copy_in(self.hidden0, s.hidden)
                rs, batch, acc, last_values, returns, adv = runner._collect(
                    s, noise=inj.get("noise"), u=inj.get("u"))
                self._stage_update(batch, returns, adv, inj.get("perm"))
                self.sums.copy_(runner._collection_sums(rs, acc))
            out = {"batch": batch, "acc": acc, "last_values": last_values, "returns": returns,
                   "advantages": adv}
            return self._collected(rs), out

        return body

    def _collected(self, rs):
        """The state the collection donates: the rollout's env state,
        observations, generators and (recurrent) new memory; the PPO state
        is the update's."""
        return rs.replace(ppo=self.static.ppo)

    def _stage_update(self, batch, returns, adv, perm):
        """The update's inputs, from the collection's outputs: the
        permutation (``perm``, or drawn from the static generator) and the
        shuffle, staged into K3's context (mega) or into static buffers."""
        alg, s = self.runner.alg, self.static
        if self.runner.spans is not None:
            self.runner.spans("stage")
        if self.path == "recurrent":
            data, cols, hidden0 = alg.recurrent_inputs(batch, returns, adv, self.hidden0, generator=s.rng,
                                                       perm=perm)
            inputs = {"data": data, "cols": cols}
            if hidden0 is not self.hidden0:   # the global shuffle's gathered start memories
                inputs["hidden0"] = hidden0
            self.step_index.zero_()
        else:
            shuf_w, shuf_f, rows = alg.prepare_update(batch, returns, adv, generator=s.rng, perm=perm)
            if self.path == "mega":
                fused = alg._get_fused(rows)
                bufs = fused.split_buffers(shuf_w, shuf_f, batch.obs.shape[-1])
                if self.update is None:   # the warm-up: K3's context over the static PPOState
                    p = s.ppo
                    self.fused = fused
                    self.update = fused.donated_update(p.params.device, bufs, p.params, p.m, p.v)
                if fused is not self.fused:
                    raise RuntimeError("the update's geometry changed between the collection's calls")
                self.update.stage_inputs(fused, s.ppo.count, s.ppo.learning_rate, bufs)
                return
            inputs = {"shuf_w": shuf_w, "shuf_f": shuf_f}
            self.dims = (rows, batch.obs.shape[-1], batch.actions.shape[-1])
        if self.inputs is None:   # the warm-up: the static buffers, holding this call's inputs
            self.inputs = make_static(inputs)
        else:
            copy_in(self.inputs, inputs)

    def _rollout_step_body(self, mode):
        """A1: one rollout step at the device index, the index advanced;
        the new state donated into the static one."""
        runner, s = self.runner, self.static

        def body():
            t = self.rollout_index
            eps = u = None
            if mode == "inject":
                eps = self.inject["noise"].index_select(0, t)[0]
                u = self.inject["u"].index_select(0, t)[0]
            rs = runner.rollout_step(s, self.buf, self.acc, t, eps, u)
            self._advance_rollout()
            return self._collected(rs), None

        return body

    def _advance_rollout(self):
        self.rollout_index.add_(1)

    def _tail_body(self, mode):
        """A2: the last values, GAE, the update's inputs and the metrics'
        sums from the static state and buffers; then the sums (copied out
        first) and the step index zeroed for the next collection."""
        runner, s = self.runner, self.static

        def body():
            perm = self.inject["perm"] if mode == "inject" else None
            with torch.no_grad():
                last_values, returns, adv = runner._returns(s, self.buf)
                self._stage_update(self.buf, returns, adv, perm)
                self.sums.copy_(runner._collection_sums(s, self.acc))
                acc = {k: v.clone() for k, v in self.acc.items()}
                for v in self.acc.values():
                    v.zero_()
                self.rollout_index.zero_()
            out = {"batch": self.buf, "acc": acc, "last_values": last_values, "returns": returns,
                   "advantages": adv}
            return None, out

        return body

    def _collection(self, mode) -> Graph:
        if mode not in self.collect:
            kw = dict(count_nodes=node_kinds)
            if self.per_step:
                self.collect[mode] = Graph(f"rollout step ({mode})", self._rollout_step_body(mode), self.static,
                                           **kw)
                self.tail[mode] = Graph(f"collection tail ({mode})", self._tail_body(mode), self.static,
                                        donate=False, **kw)
            else:   # marks: 4 a step at most, the tail's 2, the stamps around the launch
                spans = Spans(4 * self.runner.num_steps_per_env + 8, self.runner.device,
                              (self.runner, self.runner.env))
                self.collect[mode] = Graph(f"collection ({mode})", self._collection_body(mode), self.static,
                                           spans=spans, **kw)
        return self.collect[mode]

    def _collect(self, mode):
        """Graph A, or on the engine A1 replayed T times and A2. Returns the
        collection's outputs."""
        graph = self._collection(mode)
        if not self.per_step:
            return graph()
        if self.path == "recurrent":
            copy_in(self.hidden0, self.static.hidden)
        for _ in range(self.runner.num_steps_per_env):
            graph()
        return self.tail[mode]()

    # -- graph B ---------------------------------------------------------------

    def _metrics_vector(self, update_metrics):
        """The iteration's metrics (``runner._metrics``) as one vector, their
        keys in ``metric_keys``; with dp the sums all-reduced first
        (``runner.global_sums``: captured after the update's collectives,
        where the eager iteration runs it)."""
        metrics = self.runner._metrics(self.runner.global_sums(self.sums), self.static.env_state,
                                       update_metrics)
        self.metric_keys = list(metrics)
        return torch.stack(list(metrics.values()))

    def _epilogue(self, donate: bool):
        """After K3's last step: the metrics vector and, with ``donate``, the
        new Adam count and learning rate written into the static PPOState."""
        p = self.static.ppo
        lr, upd = self.update.outputs()
        self.metrics = self._metrics_vector(dict(upd, lr=lr))
        if donate:
            p.count.add_(self.update.steps)
            p.learning_rate.copy_(lr)

    def _capture_update(self):
        with torch.no_grad():
            self._epilogue(donate=False)   # its kernels (and collectives) run once before the capture
            before = dict(_mesh.CAPTURED)
            self.update.capture(self.fused, epilogue=lambda: self._epilogue(donate=True))
            self.update_collectives = _captured_since(before)

    def _grad_step(self, grad_fn, i):
        """``PPO.grad_step`` on the static PPOState, its result donated into
        it (the K2 context reads p where it lies). Returns the step's (value
        loss, surrogate loss, KL)."""
        st = self.static.ppo
        p, m, v, count, lr, row = self.runner.alg.grad_step(st.params, st.m, st.v, st.count,
                                                            st.learning_rate, grad_fn, i)
        donate(st, PPOState(params=p, m=m, v=v, count=count, learning_rate=lr))
        return row

    def _means(self, means):
        lr = self.static.ppo.learning_rate
        return {"value_loss": means[0], "surrogate_loss": means[1], "kl": means[2], "lr": lr}

    def _update_body(self):
        """The step and xla paths' update graph: every grad step unrolled,
        minibatch ``s % MB`` of step s, then the metrics."""
        alg, st = self.runner.alg, self.static.ppo
        rows, obs_dim, a = self.dims
        shuf_w, shuf_f = self.inputs["shuf_w"], self.inputs["shuf_f"]
        if self.path == "step":
            if self.k2 is None:   # the warm-up: K2's context over the static params and inputs
                fused = alg._get_fused(rows)
                self.k2 = fused.step_context(st.params, fused.split_buffers(shuf_w, shuf_f, obs_dim))
            self.k2.stage()
            grad_fn = lambda p, i: self.k2.grads(i)
        else:
            grad_fn = lambda p, i: alg.loss_and_grad(p, alg.minibatch(shuf_w, shuf_f, obs_dim, a, i))
        hist = [self._grad_step(grad_fn, k % alg.num_mini_batches) for k in range(self.steps)]
        return None, self._metrics_vector(self._means(torch.stack(hist).mean(dim=0)))

    def _recurrent_step_body(self):
        """The recurrent path's graph of one grad step, replayed ``steps``
        times an update: minibatch ``index % MB``, its row of the history,
        the index advanced, all on the device."""
        alg = self.runner.alg
        data, cols = self.inputs["data"], self.inputs["cols"]
        hidden0 = self.inputs.get("hidden0", self.hidden0)
        i = torch.remainder(self.step_index, alg.num_mini_batches)
        grad_fn = lambda p, j: alg.recurrent_grad(p, alg.recurrent_minibatch(data, cols, hidden0, j))
        row = self._grad_step(grad_fn, i)
        self.hist.index_copy_(0, self.step_index, row[None])
        self._advance()
        return None, None

    def _advance(self):
        self.step_index.add_(1)

    def _update(self):
        """Graph B, its first call warming up and capturing. Returns the
        metrics vector."""
        if self.path == "mega":
            if self.update.graph is None:
                self._capture_update()
            self.update.replay()
            return self.metrics
        st = self.static.ppo
        if self.path != "recurrent":
            if self.update is None:
                self.update = Graph(f"update ({self.path})", self._update_body, st, donate=False,
                                    count_nodes=node_kinds)
            return self.update()
        if self.update is None:
            self.update = Graph("update grad step (recurrent)", self._recurrent_step_body, st, donate=False,
                                count_nodes=node_kinds)
            means = lambda: (None, self._metrics_vector(self._means(self.hist.mean(dim=0))))
            self.epilogue = Graph("update metrics (recurrent)", means, st, donate=False)
        for _ in range(self.steps):
            self.update()
        return self.epilogue()

    # -- the calls ---------------------------------------------------------------

    def _stage_draws(self, noise, u, perm):
        given = [x is not None for x in (noise, u, perm)]
        if not any(given):
            return "draw"
        if not all(given):
            raise ValueError("inject noise, u and perm together, or none of them")
        dev = self.runner.device
        if self.inject is None:
            self.inject = {k: torch.empty(x.shape, dtype=dtype, device=dev)
                           for k, x, dtype in (("noise", noise, torch.float32), ("u", u, torch.float32),
                                               ("perm", perm, torch.long))}
        for k, x in (("noise", noise), ("u", u), ("perm", perm)):
            x = x if torch.is_tensor(x) else torch.as_tensor(x)
            if x.shape != self.inject[k].shape:
                raise ValueError(f"{k} is {tuple(x.shape)}, the graph's {tuple(self.inject[k].shape)}")
            self.inject[k].copy_(x)
        return "inject"

    def __call__(self, state, noise=None, u=None, perm=None):
        """One iteration. ``runner.last_timing`` (a ``spans.Timing``, read
        lazily and valid until the next call): ``collection_s`` and
        ``update_s`` from CUDA events, on K1 from the collection graph's
        second call on the six phases of ``learn/spans.py``, and ``launch_s``,
        the host's seconds in the graphs' launch calls (at the first call
        their warm-ups and captures)."""
        runner, s = self.runner, self.static
        with record_function("CompiledIteration.copy_in"):
            copy_in(s, state)
            runner.net.bind(s.ppo.params)
        with record_function("CompiledIteration.stage_draws"):
            mode = self._stage_draws(noise, u, perm)
        graph = self._collection(mode)
        spans = graph.spans if graph.graph is not None else None   # its marks run in a replay
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        with record_function("CompiledIteration.launch_collection"):
            if spans is not None:
                spans.start()
            t0 = time.perf_counter()
            self.last = self._collect(mode)
            launch_s = time.perf_counter() - t0
            if spans is not None:
                spans.end()
        ev[1].record()
        with record_function("CompiledIteration.launch_update"):
            t0 = time.perf_counter()
            self.metrics = self._update()
            launch_s += time.perf_counter() - t0
        ev[2].record()
        with record_function("CompiledIteration.wait"):
            ev[2].synchronize()
        self.calls += 1
        runner.last_timing = Timing(functools.partial(self._timing, self.calls, ev, spans, launch_s))
        return s, {k: self.metrics[i] for i, k in enumerate(self.metric_keys)}

    def _timing(self, call, ev, spans, launch_s) -> Dict[str, float]:
        """``last_timing``'s values of call ``call`` (the readout of its
        events and marks)."""
        if call != self.calls:
            raise RuntimeError(f"last_timing of call {call} read after call {self.calls}: the graph's marks "
                               "were written again")
        with record_function("CompiledIteration.read_spans"):
            out = {"collection_s": ev[0].elapsed_time(ev[1]) / 1e3, "update_s": ev[1].elapsed_time(ev[2]) / 1e3}
            if spans is not None:
                out.update(spans.read())
            out["launch_s"] = launch_s
        return out

    def rollout(self, state):
        """The rollout alone as a graph over the static state, not donated:
        each replay starts from the static state (the generators advance).
        Returns (new state, Transition, acc) as ``runner.rollout``. K1 only:
        the engine's rollout is A1's replays, which advance the static
        state (it raises there)."""
        if self.per_step:
            raise NotImplementedError("the engine's rollout is not graphed alone (one step's graph replayed T "
                                      "times donates into the static state); time _train_iter")
        copy_in(self.static, state)
        self.runner.net.bind(self.static.ppo.params)
        if self._rollout is None:
            body = lambda: (None, self.runner.rollout(self.static))
            self._rollout = Graph("rollout", body, self.static, donate=False)
        return self._rollout()


# ---------------------------------------------------------------------------
# the env step
# ---------------------------------------------------------------------------


class StepGraph:
    """``LeggedEnv.step_graph``'s graph for one batch shape: the env's step
    over a static ``EnvState`` and static actions, the new state donated
    into the static one. A call copies its state (the leaves that are not
    the static ones) and actions in, replays and returns (the static state,
    the step's outputs)."""

    def __init__(self, env, state, actions):
        self.static = make_static(state)
        self.actions = actions.clone(memory_format=torch.contiguous_format)

        def body():
            with torch.no_grad():
                return env.step(self.static, self.actions)

        self.graph = Graph("env.step", body, self.static)
        if env.dp is not None and env.device.type == "cuda":   # the graph goes before the group (mesh.destroy)
            _mesh.hold(self.graph)

    def __call__(self, state, actions):
        copy_in(self.static, state)
        if actions.shape != self.actions.shape or actions.dtype != self.actions.dtype:
            raise ValueError(f"actions {actions.dtype} {tuple(actions.shape)}, the graph's "
                             f"{self.actions.dtype} {tuple(self.actions.shape)}")
        self.actions.copy_(actions)
        return self.static, self.graph()

