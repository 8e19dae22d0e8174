"""K2 and K3, the PPO update kernels: wrapper, plain versions and dispatch.

Counterpart of ``wiki_grx_gym_tpu/learn/fused_update.py:FusedPPOGrad``:

- ``grads`` (K2): one minibatch's clipped-PPO loss and its gradient with
  respect to every parameter: both MLP forwards, the loss, and the
  hand-derived backward with JAX's tie conventions (0.5 at ``max``/``clip``
  ties). CUDA source ``csrc/ppo_grads.cu``; replaces
  ``FusedPPOGrad.grads`` (``pallas_call`` at fused_update.py:462).
- ``update_scan`` (K3): the whole update, epochs x minibatches of K2 steps,
  each followed by the entropy/std-gradient finalisation, the adaptive-KL
  learning rate, the NaN-loss skip, clip by global norm, Adam with the
  carried count and K3's own bias correction ``1 - exp(c log b)``, and the
  std floor. CUDA source ``csrc/ppo_update.cu`` (the optimizer step, one
  cooperative launch ``k3_fused_step`` a grad step; the gradients come from
  K2's chain); replaces ``FusedPPOGrad.update_scan`` (``pallas_call`` at
  fused_update.py:708). The update's steps x (K2's chain + K3's step) are
  captured once into a CUDA graph (``_UpdateGraph``, cached on the
  ``FusedPPOGrad`` by device, operand type, rows, buffer shapes, step count
  and every constant the kernels take) and replayed per update: one host
  launch an update.

Parameters, Adam moments and gradients are flat float32 vectors in the
layout of ``networks.ActorCritic.layout`` (ravel_pytree leaf order, W stored
(out, in)). The minibatch buffers are those of ``PPO._pack_shuffle``:
``(MB, rows, O+P)`` obs||critic_obs and ``(MB, rows, 3A+4)`` f32 scalars
(actions | log_prob | mu | sigma | values | returns | advantages).

Dispatch is by the device of the parameters: CPU tensors run the plain
versions (``grads_plain``, ``update_scan_plain`` with its optimizer step
``_k3_step_plain``: literal translations of the TPU kernel's tile program
and optimizer step), CUDA tensors launch the kernels (built with nvcc at
first use, ``build.build``) or raise: a failed capture, a refused
cooperative launch or too few co-resident blocks raises, nothing falls back
to launches one by one. The plain versions run on any device; on the card
they are the kernels' reference.

K2 has two chains. bf16 operands (the main path) run on the tensor cores
(TMA + wgmma): the wrapper repacks the obs buffers into zero-padded
TMA-addressable copies (``repack_rows``; an update's graph copies each
update's buffers into its own), the kernel packs the weights the same way
each step (``packed_layout``, plain version ``pack_weights``), and
``k2_prepare`` encodes the tensor maps and the launch plan once. float32
operands (the exact check) run the SIMT chain. ``gemm_check`` runs the
tensor-core GEMM alone (f32 out, no epilogue), for the sharp per-product
checks on the card.

``LAUNCHES["k2"]`` counts K2 gradient chains (one per grad step, in ``grads``
and inside ``update_scan``: a replay adds its steps), ``LAUNCHES["k3"]``
counts whole updates (graph replays).

The compiled iteration (``learn/graphs.py``) runs the same update graph over
a donated state: :meth:`FusedPPOGrad.donated_update` makes a context whose
p, m and v are the caller's static tensors (updated in place, no copies),
whose inputs the caller stages inside its own graph
(:meth:`_UpdateGraph.stage_inputs`), and whose capture ends with the
caller's epilogue (the count, the learning rate and the metrics written into
the static state). The step path's update graph launches K2 from a
persistent context (:meth:`FusedPPOGrad.step_context`): the argument
struct, launch plan, scratch and operands made once over the static params,
which the plain clip and Adam update in place between the grad steps.
"""

from __future__ import annotations

import ctypes
import math
import threading
import time
from typing import Dict

import torch

from wiki_grx_gym_tpu_torch import build as _build
from wiki_grx_gym_tpu_torch.build import LAUNCHES

_LOG_2PI = math.log(2.0 * math.pi)
MAX_LAYERS = 8     # per MLP (csrc/ppo_grads.cu MAXL)
MAX_ACT = 32       # action dims (csrc/ppo_grads.cu MAXA)
WGRAD_ROWS = 640   # rows per split of K2's weight-gradient reduction
LOSS_ROWS = 64     # rows per block of K2's loss kernel (csrc/ppo_grads.cu LOSS_THREADS)
K3_BLOCKS = 216    # blocks of K3's step over the flat vector (all co-resident)

# K2 and K3 each build into their own library; unlike K1 they may contract
# into FMA (their plain version on the card is GPU PyTorch, which does)
FLAGS = list(_build.BASE_FLAGS)
K2_SOURCE = _build.CSRC / "ppo_grads.cu"
# every CUDA graph capture of the port (here and in learn/graphs.py): unsafe
# calls are refused on the capturing thread only. Other threads of the
# process (NCCL's watchdog querying its eager collectives' events, the
# autograd engine's) may then make theirs without ending the capture, as
# "global" would end it.
CAPTURE_ERROR_MODE = "thread_local"
K3_SOURCE = _build.CSRC / "ppo_update.cu"


def _elu(z):
    # exp(z) - 1, not expm1: the TPU kernel's form (fused_update.py:56-60)
    return torch.where(z > 0, z, torch.exp(z) - 1.0)


def _elu_grad_from_h(h):
    return torch.where(h > 0, torch.ones_like(h), h + 1.0)


def _max_grad(a, b):
    """d max(a, b) / da with JAX's tie convention (0.5 at a == b)."""
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.where(a > b, one, torch.where(a < b, zero, 0.5 * one))


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx: 1 interior, 0 outside, 0.5 at the boundary."""
    one = torch.ones_like(x)
    return torch.where((x > lo) & (x < hi), one,
                       torch.where((x == lo) | (x == hi), 0.5 * one, 0.0 * one))


_SCALARS: Dict[tuple, torch.Tensor] = {}


def scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``device``, made once per (value, type,
    device) and reused: a tensor made from a host number is a host copy,
    which a CUDA graph's capture refuses (the first call comes before any
    capture, in its warm-up)."""
    key = (float(value), dtype, torch.device(device))
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def _jmax(a, b):
    """jnp.maximum: NaN-propagating (torch.maximum is too)."""
    return torch.maximum(a, scalar(b, a.dtype, a.device))


def _jclip(x, lo, hi):
    """jnp.clip = minimum(maximum(x, lo), hi), NaN-propagating."""
    return torch.minimum(_jmax(x, lo), scalar(hi, x.dtype, x.device))


# ---------------------------------------------------------------------------
# kernel libraries (ctypes; structs mirror csrc/ppo_grads.cu and ppo_update.cu)
# ---------------------------------------------------------------------------

_I, _F, _L, _P = ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p


class _K2Args(ctypes.Structure):
    _fields_ = [
        ("rows", _I), ("act_dim", _I), ("n_actor", _I), ("n_critic", _I),
        ("actor_dims", _I * (MAX_LAYERS + 1)), ("critic_dims", _I * (MAX_LAYERS + 1)),
        ("op_bf16", _I), ("fixed_std", _I), ("clipped_vl", _I), ("wgrad_splits", _I),
        ("wgrad_rows", _I), ("loss_blocks", _I),
        ("clip_param", _F), ("init_noise_std", _F), ("coef_scale", _F),
        ("gval_scale", _F), ("logp_const", _F), ("lo", _F), ("hi", _F), ("pad0", _F),
        ("obs_ld", _L), ("obs_mb_stride", _L), ("cobs_ld", _L), ("cobs_mb_stride", _L),
        ("fs_ld", _L), ("fs_mb_stride", _L),
        ("w_off", _L * (2 * MAX_LAYERS)), ("b_off", _L * (2 * MAX_LAYERS)),
        ("std_off", _L),
        ("obs", _P), ("cobs", _P), ("fscal", _P), ("p", _P),
        ("g", _P), ("aux", _P), ("h", _P * (2 * MAX_LAYERS)),
        ("mean", _P), ("value", _P), ("gbuf", _P * 4), ("part", _P), ("loss_part", _P),
        ("gtop", _P * 2), ("gtop_ld", _I * 2), ("loss_w", _I), ("mb_count", _I),
        ("q_off", _L * (2 * MAX_LAYERS)), ("part_off", _L * (2 * MAX_LAYERS)),
        ("bsum_off", _L * (2 * MAX_LAYERS)), ("q_ld", _I * (2 * MAX_LAYERS)),
        ("q_total", _L), ("q", _P), ("gin", _P * (2 * MAX_LAYERS)), ("bsum", _P), ("plan", _P),
    ]


class _K3Args(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("std_off", _L),
        ("p", _P), ("m", _P), ("v", _P), ("g", _P), ("aux", _P), ("state", _P),
        ("count0", _P), ("part", _P), ("step", _P),
        ("act_dim", _I), ("fixed_std", _I), ("adaptive", _I), ("nblocks", _I),
        ("rows_f", _F), ("value_loss_coef", _F), ("entropy_coef", _F), ("ent_const", _F),
        ("ent_fixed", _F), ("kl_hi", _F), ("kl_lo", _F), ("lr_min", _F), ("lr_max", _F),
        ("max_grad_norm", _F), ("b1", _F), ("b2", _F), ("omb1", _F), ("omb2", _F),
        ("log_b1", _F), ("log_b2", _F), ("eps", _F), ("std_floor", _F),
    ]


_LIBS: Dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
# per kernel: library name, source, argument struct (its size is checked
# against the library's <kernel>_args_size())
_KERNELS = {"k2": ("k2_ppo_grads", K2_SOURCE, _K2Args), "k3": ("k3_ppo_update", K3_SOURCE, _K3Args)}


def _lib(name: str) -> ctypes.CDLL:
    with _LIB_LOCK:
        if name not in _LIBS:
            lib_name, source, struct = _KERNELS[name]
            lib = ctypes.CDLL(str(_build.build(lib_name, source, FLAGS)))
            step, size = getattr(lib, f"{name}_step"), getattr(lib, f"{name}_args_size")
            step.argtypes, step.restype = [_P, _I, _P], _I
            size.argtypes, size.restype = [], _I
            if name == "k2":
                for fn in (lib.k2_prepare, lib.k2_release):
                    fn.argtypes, fn.restype = [_P], _I
                lib.k2_load.argtypes, lib.k2_load.restype = [], _I
                lib.k2_gemm_check.argtypes = [_I, _P, _L, _P, _L, _P, _I, _I, _I, _P]
                lib.k2_gemm_check.restype = _I
            else:
                lib.k3_step_ref.argtypes, lib.k3_step_ref.restype = [_P, _I, _P], _I
                lib.k3_coresident.argtypes, lib.k3_coresident.restype = [_P], _I
            if size() != ctypes.sizeof(struct):
                raise RuntimeError(f"{name} argument struct: kernel {size()} bytes, "
                                   f"wrapper {ctypes.sizeof(struct)}")
            _LIBS[name] = lib
    return _LIBS[name]


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


_CORESIDENT: Dict[int, int] = {}


def k3_coresident(dev) -> int:
    """Blocks of ``k3_fused_step`` that can be resident at once on ``dev``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs; 0 where the
    card refuses cooperative launches). Raises below ``K3_BLOCKS``: the
    step's grid barrier needs every block resident."""
    idx = torch.device(dev).index or 0
    if idx not in _CORESIDENT:
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _check(_lib("k3").k3_coresident(ctypes.addressof(n)), "K3 occupancy query")
        _CORESIDENT[idx] = n.value
    if _CORESIDENT[idx] < K3_BLOCKS:
        raise RuntimeError(f"K3's step needs {K3_BLOCKS} co-resident blocks of a cooperative launch; "
                           f"{torch.cuda.get_device_name(idx)} holds {_CORESIDENT[idx]}")
    return _CORESIDENT[idx]


def k3_step_once(fused, p, m, v, g, aux, count, lr, s=0, reference=False):
    """One K3 optimizer step alone on the card, for checks and timings (the
    update runs it inside its graph): the fused step ``k3_step`` or, with
    ``reference``, its reference pair ``k3_step_ref`` (k3_norm + k3_adam),
    over copies of p, m, v and of K2's gradient ``g``, with K2's row sums
    ``aux``, as grad step ``s`` of an update from Adam count ``count`` with
    the live LR ``lr`` in the slot step s reads, and there running metric
    sums (vl, surr, kl) of (0.5, -0.25, 0.125), so that a check sees the
    step add to them. Returns the step's buffers: p, m, v, g, state (both
    slots), part (the blocks' partial sums), step (ok, surr, vl, kl)."""
    out = {"p": p.clone(), "m": m.clone(), "v": v.clone(), "g": g.clone(), "aux": aux}
    b = fused._k3_context(out["p"], out["m"], out["v"], out)
    out["count0"].copy_(count.reshape(1))
    slot = (s & 1) * 8
    out["state"][slot] = lr.reshape(())
    out["state"][slot + 1: slot + 4] = torch.tensor([0.5, -0.25, 0.125])
    lib = _lib("k3")
    step = lib.k3_step_ref if reference else lib.k3_step
    with torch.cuda.device(p.device):
        _check(step(ctypes.addressof(b), int(s), torch.cuda.current_stream(p.device).cuda_stream),
               "K3 reference pair" if reference else "K3 step")
    return {"p": out["p"], "m": out["m"], "v": out["v"], "g": out["g"], "state": out["state"],
            "part": out["k3_part"], "step": out["k3_step"]}


class _Plan:
    """Owns the launch plan ``k2_prepare`` built for one argument struct
    (its tensor maps point into the tensors of the same context)."""

    def __init__(self, lib, args):
        self.lib, self.args, self.addr = lib, args, ctypes.addressof(args)
        _check(lib.k2_prepare(self.addr), "K2 prepare")

    def __del__(self):
        self.lib.k2_release(self.addr)


# ---------------------------------------------------------------------------
# operand layouts of K2's tensor-core chain (plain torch; the CPU tests hold
# them, the kernels read them)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def packed_layout(layer_dims):
    """Where each layer's W (out, in) lies in K2's packed bf16 copy of the
    weights: ``([(offset, row stride), ...], total)`` in elements. Each row is
    padded to a multiple of 16 (32 B, one wgmma k-step) and each matrix starts
    128-B aligned, so every row is 16-B aligned as TMA needs."""
    out, cur = [], 0
    for din, dout in layer_dims:
        ld = _round_up(din, 16)
        off = _round_up(cur, 64)
        out.append((off, ld))
        cur = off + dout * ld
    return out, _round_up(cur, 64)


def pack_weights(p, layout, q_layout, q_total):
    """Plain version of K2's ``pack_params``: the weights of the flat f32
    params ``p`` (``layout``: networks.ActorCritic.layout) in bf16 at the
    packed offsets, zero everywhere else."""
    q = torch.zeros(q_total, dtype=torch.bfloat16, device=p.device)
    weights = [(off, shape) for name, off, shape in layout if name.endswith("weight")]
    for (off, (dout, din)), (qo, ld) in zip(weights, q_layout):
        q[qo: qo + dout * ld].view(dout, ld)[:, :din] = p[off: off + dout * din].view(dout, din)
    return q


def repack_rows(x, width: int, dtype=torch.bfloat16, out=None):
    """``(MB, rows, f)`` obs (a strided view into the shuffle buffer) as a
    contiguous ``(MB, rows, width)`` buffer of ``dtype``, zero beyond column
    f: for bf16 with width a multiple of 8, the layout TMA reads (16-B
    aligned rows). Written into ``out`` (made so by an earlier call) when
    given."""
    mb, rows, f = x.shape
    if out is None:
        out = torch.zeros((mb, rows, width), dtype=dtype, device=x.device)
    out[..., :f].copy_(x)
    return out


GEMM_KINDS = ("forward", "input_gradient", "weight_gradient")


def gemm_check_plain(kind: int, a, b):
    """Plain version of ``k2_gemm_check``: the product of the bf16 values in
    float64. kind 0: a (M, K) b (N, K)^T; 1: a (M, K) b (K, N); 2: a (K, M)^T
    b (K, N)."""
    a, b = a.double(), b.double()
    return {0: lambda: a @ b.t(), 1: lambda: a @ b, 2: lambda: a.t() @ b}[kind]()


def gemm_check(kind: int, a, b):
    """One product of K2's tensor-core GEMM (``wg_gemm`` through
    ``k2_gemm_check``: the main path's kernel, f32 output, no epilogue) on
    bf16 operands laid out as the main path lays them (see
    :func:`gemm_check_plain`). CPU tensors take the plain version."""
    if a.device.type == "cpu":
        return gemm_check_plain(kind, a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise RuntimeError(f"K2's GEMM runs on CUDA tensors, got {a.device} and {b.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("gemm_check takes two 2-D bf16 tensors")
    if kind == 0:
        (M, K), N = a.shape, b.shape[0]
        ok = b.shape[1] == K
    elif kind == 1:
        (M, K), N = a.shape, b.shape[1]
        ok = b.shape[0] == K
    elif kind == 2:
        (K, M), N = a.shape, b.shape[1]
        ok = b.shape[0] == K
    else:
        raise ValueError(f"kind must be 0, 1 or 2, got {kind}")
    if not ok:
        raise ValueError(f"{GEMM_KINDS[kind]}: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")

    def padded(x):   # rows 16-B aligned, as TMA needs; the padding is never read
        out = torch.zeros((x.shape[0], _round_up(x.shape[1], 8)), dtype=x.dtype, device=x.device)
        out[:, :x.shape[1]] = x
        return out

    a, b = padded(a), padded(b)
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    lib = _lib("k2")
    with torch.cuda.device(a.device):
        err = lib.k2_gemm_check(kind, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), c.data_ptr(),
                                M, N, K, torch.cuda.current_stream(a.device).cuda_stream)
    _check(err, "K2 GEMM check")
    return c


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


class FusedPPOGrad:
    """Static spec captured at construction (layer dims, loss and optimizer
    constants, batch geometry), as ``FusedPPOGrad`` of the JAX package."""

    def __init__(
        self,
        net,                    # learn.networks.ActorCritic (MLP, elu, no out act)
        clip_param: float,
        value_loss_coef: float,
        entropy_coef: float,
        use_clipped_value_loss: bool,
        rows: int,
        num_mini_batches: int,
        num_epochs: int = 1,
        tile: int = 512,        # row tile of the plain version (the TPU kernel's)
        op_dtype=torch.bfloat16,
        max_grad_norm: float = 1.0,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-8,
        adaptive_lr: bool = True,
        desired_kl: float = 0.01,
        lr_min: float = 1e-5,
        lr_max: float = 1e-2,
    ):
        self.net = net
        self.obs_dim = int(net.num_actor_input)
        self.cobs_dim = int(net.num_critic_input)
        self.act_dim = int(net.num_actions)
        self.actor_dims = [self.obs_dim] + list(net.actor_hidden) + [self.act_dim]
        self.critic_dims = [self.cobs_dim] + list(net.critic_hidden) + [1]
        self.fixed_std = bool(net.fixed_std)
        self.init_noise_std = float(net.init_noise_std)
        self.std_floor = 0.0 if self.fixed_std else float(net.noise_std_floor)
        self.clip_param = float(clip_param)
        self.value_loss_coef = float(value_loss_coef)
        self.entropy_coef = float(entropy_coef)
        self.use_clipped_value_loss = bool(use_clipped_value_loss)
        self.rows = int(rows)
        self.num_mini_batches = int(num_mini_batches)
        self.num_epochs = int(num_epochs)
        self.tile = int(min(tile, max(8, rows)))
        self.n_tiles = -(-self.rows // self.tile)
        if op_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"op_dtype must be float32 or bfloat16, got {op_dtype}")
        self.op_dtype = op_dtype
        self.max_grad_norm = float(max_grad_norm)
        self.adam_b1 = float(adam_b1)
        self.adam_b2 = float(adam_b2)
        self.adam_eps = float(adam_eps)
        self.adaptive_lr = bool(adaptive_lr)
        self.desired_kl = float(desired_kl)
        self.lr_min = float(lr_min)
        self.lr_max = float(lr_max)
        self.std_off = net.layout[-1][1]
        # K2's packed bf16 weights (the tensor-core chain's operand layout)
        self.layer_dims = list(zip(self.actor_dims[:-1], self.actor_dims[1:])) + \
            list(zip(self.critic_dims[:-1], self.critic_dims[1:]))
        self.q_layout, self.q_total = packed_layout(self.layer_dims)
        # the updates' CUDA graphs (update_graph); copies share this dict
        self._graphs: Dict[tuple, "_UpdateGraph"] = {}

    def gemm_shapes(self, rows=None):
        """The tensor-core products of one bf16 grad step, as
        ``(kind, M, N, K, label)`` for :func:`gemm_check` (kind 0 forward,
        1 input gradient, 2 weight gradient) at ``rows`` rows (default: the
        minibatch's)."""
        r = self.rows if rows is None else int(rows)
        out = []
        for mlp, dims in (("actor", self.actor_dims), ("critic", self.critic_dims)):
            for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
                out.append((0, r, dout, din, f"{mlp} {l} forward"))
                if l > 0:
                    out.append((1, r, din, dout, f"{mlp} {l} input gradient"))
                out.append((2, dout, din, r, f"{mlp} {l} weight gradient"))
        return out

    @staticmethod
    def supported(net, extra_loss_fn) -> bool:
        """The kernels cover the reference MLP path: elu hidden activations,
        linear heads, no calculate_other_loss hook."""
        return (
            extra_loss_fn is None
            and getattr(net, "actor_hidden", None) is not None
            and net.activation == "elu"
            and not net.actor_out_act
            and not net.critic_out_act
        )

    def split_buffers(self, shuf_w, shuf_f, obs_dim: int):
        """The update's shuffle buffers as the kernels' operands: obs and
        critic_obs are views into the wide ``(MB, rows, O+P)`` buffer (no
        copy); the f32 fields stay packed ``(MB, rows, 3A+4)``."""
        mb = self.num_mini_batches
        w = shuf_w.reshape(mb, self.rows, -1)
        return dict(obs=w[..., :obs_dim], cobs=w[..., obs_dim:],
                    fscal=shuf_f.reshape(mb, self.rows, -1))

    # ------------------------------------------------------------------
    # plain version: the TPU kernel's tile program, literally
    # ------------------------------------------------------------------

    def _rnd(self, x):
        """Round to the operand dtype and back (a cast to op, as the TPU
        kernel's ``.astype(op)``); the products then run in float32 on values
        the operand dtype holds exactly, i.e. op operands with f32 sums."""
        if self.op_dtype == torch.float32:
            return x.to(torch.float32)
        return x.to(self.op_dtype).to(torch.float32)

    def _op_leaves(self, p):
        """Weights cast to the operand dtype once per call; biases and std f32."""
        actor, critic, std = self.net.leaves(p)
        rw = lambda pairs: [(self._rnd(w), b) for w, b in pairs]
        return rw(actor), rw(critic), std

    def _mlp_forward(self, x, layers):
        """One MLP's forward on a tile at the TPU kernel's rounding points:
        (the inputs of each layer, the last layer's output)."""
        hs, z = [x], None
        for li, (w, b) in enumerate(layers):
            z = hs[-1] @ w.t() + b               # W (out, in): x W^T
            if li < len(layers) - 1:
                hs.append(self._rnd(_elu(z)))
        return hs, z

    def _tile_body(self, t, data, aW, cW, std_p, g_leaves):
        """One batch tile of ``_tile_body`` (fused_update.py:200): forward
        both MLPs, the loss, the backward; accumulates into ``g_leaves``
        (views into the flat gradient). Returns (surr_sum, vl_sum, kl_sum)."""
        T, A, B = self.tile, self.act_dim, float(self.rows)
        dev = std_p.device
        obs_mb, cobs_mb, fs_mb = data
        r0, r1 = t * T, min((t + 1) * T, self.rows)

        def tile_of(x):   # rows [r0, r1) padded to T
            x = x[r0:r1]
            return torch.cat([x, x.new_zeros((T - x.shape[0],) + x.shape[1:])]) if x.shape[0] < T else x

        mask = (torch.arange(T, device=dev) + t * T < self.rows)[:, None]

        def clean(x, fill=0.0):
            return torch.where(mask, x, torch.full_like(x, fill))

        obs_t = self._rnd(clean(tile_of(obs_mb)))
        cobs_t = self._rnd(clean(tile_of(cobs_mb)))
        fs = tile_of(fs_mb).to(torch.float32)
        actions = clean(fs[:, 0:A])
        old_logp = clean(fs[:, A:A + 1])
        old_mu = clean(fs[:, A + 1:2 * A + 1])
        old_sigma = clean(fs[:, 2 * A + 1:3 * A + 1], 1.0)
        old_values = clean(fs[:, 3 * A + 1:3 * A + 2])
        returns = clean(fs[:, 3 * A + 2:3 * A + 3])
        adv = clean(fs[:, 3 * A + 3:3 * A + 4])

        h_a, mean = self._mlp_forward(obs_t, aW)
        h_c, value = self._mlp_forward(cobs_t, cW)

        if self.fixed_std:
            std = torch.full((1, A), self.init_noise_std, device=dev)
        else:
            std = std_p.reshape(1, A)
        var = std * std

        diff = actions - mean
        logp = (-0.5 * torch.sum(diff * diff / var, dim=1, keepdim=True)
                - (0.5 * A * _LOG_2PI + torch.sum(torch.log(std))))
        ratio = torch.exp(logp - old_logp)
        lo, hi = 1.0 - self.clip_param, 1.0 + self.clip_param
        ratio_c = _jclip(ratio, lo, hi)
        surr1 = -adv * ratio
        surr2 = -adv * ratio_c
        surr = torch.maximum(surr1, surr2)
        kl_row = torch.sum(
            torch.log(std / old_sigma + 1e-5)
            + (old_sigma * old_sigma + (old_mu - mean) ** 2) / (2.0 * var)
            - 0.5,
            dim=1, keepdim=True,
        )

        e = value - returns
        if self.use_clipped_value_loss:
            vdelta = value - old_values
            ec = old_values + _jclip(vdelta, -self.clip_param, self.clip_param) - returns
            e2, ec2 = e * e, ec * ec
            vl = torch.maximum(e2, ec2)
            gm = _max_grad(e2, ec2)
            gv_raw = gm * (2.0 * e) + (1.0 - gm) * (
                2.0 * ec * _clip_grad(vdelta, -self.clip_param, self.clip_param))
        else:
            vl = e * e
            gv_raw = 2.0 * e

        gm_s = _max_grad(surr1, surr2)
        d_ratio = gm_s * (-adv) + (1.0 - gm_s) * (-adv * _clip_grad(ratio, lo, hi))
        zero = torch.zeros((), device=dev)
        coef = torch.where(mask, d_ratio * ratio * (1.0 / B), zero)
        g_mean = coef * (diff / var)
        g_val = torch.where(mask, gv_raw * (self.value_loss_coef / B), zero)

        ga, gc, g_std = g_leaves
        if not self.fixed_std:
            g_std += torch.sum(coef * (diff * diff / var - 1.0) / std, dim=0)

        def bwd(g_out, hs, layers, d_layers):
            g = self._rnd(g_out)
            for li in range(len(layers) - 1, -1, -1):
                w, _ = layers[li]
                dw, db = d_layers[li]
                dw += g.t() @ hs[li]                 # (out, in)
                db += torch.sum(g, dim=0)
                if li > 0:
                    gx = g @ w
                    g = self._rnd(gx * _elu_grad_from_h(hs[li]))

        bwd(g_mean, h_a, aW, ga)
        bwd(g_val, h_c, cW, gc)

        s = lambda x: torch.sum(torch.where(mask, x, zero))
        return s(surr), s(vl), s(kl_row)

    def _raw_grads_plain(self, p, bufs, mb_index):
        """The tile loop of K2: flat raw gradient (std part without the
        entropy term) and the (surr, vl, kl) sums."""
        g = torch.zeros_like(p)
        ga, gc, g_std = self.net.leaves(g)
        aW, cW, std_p = self._op_leaves(p)
        data = (bufs["obs"][mb_index], bufs["cobs"][mb_index], bufs["fscal"][mb_index])
        sums = torch.zeros(3, device=p.device)
        for t in range(self.n_tiles):
            ss, sv, sk = self._tile_body(t, data, aW, cW, std_p, (ga, gc, g_std))
            sums = sums + torch.stack([ss, sv, sk])
        return g, sums

    def _entropy(self, std):
        if self.fixed_std:
            return scalar(self.act_dim * (0.5 + 0.5 * _LOG_2PI) + self.act_dim * math.log(self.init_noise_std),
                          torch.float32, std.device)
        return torch.sum(0.5 + 0.5 * _LOG_2PI + torch.log(std))

    def _finalize_grads(self, p, g, sums):
        """``grads`` after the kernel (fused_update.py:478-505): means, the
        std gradient's entropy term, the loss."""
        B = float(self.rows)
        surr_mean, vl_mean, kl_mean = sums[0] / B, sums[1] / B, sums[2] / B
        std = p[self.std_off:]
        g_std = g[self.std_off:]
        if self.fixed_std:
            g_std.zero_()
        else:
            g_std.copy_(g_std - self.entropy_coef / std)
        loss = surr_mean + self.value_loss_coef * vl_mean - self.entropy_coef * self._entropy(std)
        return loss, g, {"value_loss": vl_mean, "surrogate_loss": surr_mean, "kl": kl_mean}

    def grads_plain(self, p, bufs, mb_index: int):
        """Plain version of :meth:`grads`, on any device."""
        g, sums = self._raw_grads_plain(p, bufs, mb_index)
        return self._finalize_grads(p, g, sums)

    def _k3_step_plain(self, p, m, v, g, sums, count, lr):
        """Plain version of K3's optimizer step (``_finalize_step``
        :579-657; the kernel ``k3_fused_step``), on any device. ``g``: K2's
        raw flat gradient (the std part without the entropy term); ``sums``:
        its (surr, vl, kl) row sums; ``count``: the Adam count before this
        step; ``lr``: the live learning rate (0-d float32). Returns (p', m',
        v', lr', this step's (vl, surr, kl) means); the inputs are not
        modified."""
        B = float(self.rows)
        b1, b2 = self.adam_b1, self.adam_b2
        surr_mean, vl_mean, kl_mean = sums[0] / B, sums[1] / B, sums[2] / B
        std = p[self.std_off:]
        ent = self._entropy(std)
        g = g.clone()
        if not self.fixed_std:
            g[self.std_off:] += -self.entropy_coef / std
        loss = surr_mean + self.value_loss_coef * vl_mean - self.entropy_coef * ent
        if self.adaptive_lr:
            lr_dn = _jmax(lr / 1.5, self.lr_min)
            lr_up = torch.minimum(lr * 1.5, scalar(self.lr_max, torch.float32, lr.device))
            lr = torch.where(kl_mean > self.desired_kl * 2.0, lr_dn,
                             torch.where((kl_mean < self.desired_kl / 2.0) & (kl_mean > 0.0),
                                         lr_up, lr))
        okf = torch.where(torch.isfinite(loss), 1.0, 0.0)
        gsq = 0.0
        for _, off, shape in self.net.layout:
            gsq = gsq + torch.sum(torch.square(g[off: off + math.prod(shape)] * okf))
        gnorm = torch.sqrt(gsq)
        gscale = okf * torch.where(gnorm < self.max_grad_norm, 1.0, self.max_grad_norm / gnorm)
        c = (count + 1).to(torch.float32)
        # K3's bias correction (fused_update.py:624-625), not optax's 1 - b**c
        bc1 = 1.0 - torch.exp(c * float(math.log(b1)))
        bc2 = 1.0 - torch.exp(c * float(math.log(b2)))
        gg = g * gscale
        m = b1 * m + (1.0 - b1) * gg
        v = b2 * v + (1.0 - b2) * (gg * gg)
        p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + self.adam_eps)
        if self.std_floor > 0.0:
            p[self.std_off:] = _jmax(p[self.std_off:], self.std_floor)
        return p, m, v, lr, torch.stack([vl_mean, surr_mean, kl_mean])

    def update_scan_plain(self, p, m, v, count, lr, bufs):
        """Plain version of :meth:`update_scan` (``_update_kernel`` :511 with
        ``_finalize_step`` :579-657), on any device."""
        lr = lr.to(torch.float32).clone()
        steps = self.num_epochs * self.num_mini_batches
        sums = torch.zeros(3, device=p.device)   # vl, surr, kl over steps
        for s in range(steps):
            g, st = self._raw_grads_plain(p, bufs, s % self.num_mini_batches)
            p, m, v, lr, means = self._k3_step_plain(p, m, v, g, st, count + s, lr)
            sums = sums + means
        n = float(steps)
        metrics = {"value_loss": sums[0] / n, "surrogate_loss": sums[1] / n,
                   "kl": sums[2] / n, "lr": lr}
        return p, m, v, lr, metrics

    # ------------------------------------------------------------------
    # kernel path
    # ------------------------------------------------------------------

    def _k2_operands(self, bufs, dev, out=None):
        """The minibatch buffers as K2 reads them: obs and critic obs copied
        into contiguous buffers of the operand type (the TPU kernel's
        ``.astype(op)`` on the data; bf16 rows zero-padded to 16 columns, as
        TMA reads them), the f32 scalars as given. With ``out`` (the
        operands of an earlier call) every buffer, the scalars too, is
        copied into ``out``'s. Checks shapes, types and devices."""
        mb, rows, A = self.num_mini_batches, self.rows, self.act_dim
        bf = self.op_dtype == torch.bfloat16
        ops = {}
        for name, feat in (("obs", self.obs_dim), ("cobs", self.cobs_dim)):
            x = bufs[name]
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, params on {dev}")
            if x.dim() != 3 or tuple(x.shape) != (mb, rows, feat):
                raise ValueError(f"{name} must be ({mb}, {rows}, {feat}), got {tuple(x.shape)}")
            ops[name] = repack_rows(x, _round_up(feat, 16) if bf else feat, self.op_dtype,
                                    None if out is None else out[name])
        fs = bufs["fscal"]
        if fs.dtype != torch.float32 or tuple(fs.shape) != (mb, rows, 3 * A + 4) or fs.stride(-1) != 1 \
                or fs.device != dev:
            raise ValueError(f"fscal must be float32 ({mb}, {rows}, {3 * A + 4}) on {dev}")
        ops["fscal"] = fs if out is None else out["fscal"].copy_(fs)
        return ops

    def _k2_context(self, p, bufs):
        """K2's argument struct over params ``p`` and the operands of
        ``bufs`` (:meth:`_k2_operands`). Returns (struct, the tensors it
        points into)."""
        return self._k2_args(p, self._k2_operands(bufs, p.device))

    def _k2_args(self, p, ops):
        """Check the params, allocate K2's scratch and fill its argument
        struct over ``p`` and the operands ``ops``; for bf16 operands also
        build the launch plan (tensor maps). Returns (struct, the tensors it
        points into)."""
        if p.device.type != "cuda":
            raise RuntimeError(f"K2 runs on CUDA tensors, got device {p.device}")
        dev, op = p.device, self.op_dtype
        bf = op == torch.bfloat16
        net = self.net
        if p.dtype != torch.float32 or p.shape != (net.num_params,) or not p.is_contiguous():
            raise ValueError(f"params must be a contiguous float32 ({net.num_params},) tensor")
        if self.act_dim > MAX_ACT or max(len(self.actor_dims), len(self.critic_dims)) - 1 > MAX_LAYERS:
            raise NotImplementedError(
                f"K2 takes at most {MAX_LAYERS} layers and {MAX_ACT} actions")
        mb, rows = self.num_mini_batches, self.rows
        keep = dict(ops, p=p)
        obs, cobs, fs = ops["obs"], ops["cobs"], ops["fscal"]
        A = self.act_dim

        a = _K2Args()
        a.rows, a.act_dim = rows, A
        a.n_actor, a.n_critic = len(self.actor_dims) - 1, len(self.critic_dims) - 1
        for i, d in enumerate(self.actor_dims):
            a.actor_dims[i] = d
        for i, d in enumerate(self.critic_dims):
            a.critic_dims[i] = d
        a.op_bf16 = int(bf)
        a.fixed_std = int(self.fixed_std)
        a.clipped_vl = int(self.use_clipped_value_loss)
        a.wgrad_rows = WGRAD_ROWS
        a.wgrad_splits = -(-rows // WGRAD_ROWS)
        a.loss_blocks = -(-rows // LOSS_ROWS)
        a.loss_w = 2 * A + 4 if bf else A + 3
        a.mb_count = mb
        B = float(rows)
        a.clip_param = self.clip_param
        a.init_noise_std = self.init_noise_std
        a.coef_scale = 1.0 / B
        a.gval_scale = self.value_loss_coef / B
        a.logp_const = 0.5 * A * _LOG_2PI
        a.lo, a.hi = 1.0 - self.clip_param, 1.0 + self.clip_param
        a.obs_ld, a.obs_mb_stride = obs.stride(1), obs.stride(0)
        a.cobs_ld, a.cobs_mb_stride = cobs.stride(1), cobs.stride(0)
        a.fs_ld, a.fs_mb_stride = fs.stride(1), fs.stride(0)
        # offsets by layer: the actor's layers, then the critic's (layout order)
        for i, (name, off, _) in enumerate(net.layout[:-1]):
            (a.w_off if name.endswith("weight") else a.b_off)[i // 2] = off
        a.std_off = self.std_off

        e = lambda *shape, dtype=op: torch.empty(shape, dtype=dtype, device=dev)
        keep["g"] = e(net.num_params, dtype=torch.float32)
        keep["aux"] = e(4, dtype=torch.float32)
        keep["mean"] = e(rows, A, dtype=torch.float32)
        keep["value"] = e(rows, dtype=torch.float32)
        # the bf16 chain's activations and input gradients: rows 16-B aligned
        # (csrc/ppo_grads.cu act_ld; the pad columns are never read)
        act_ld = (lambda w: _round_up(w, 8)) if bf else (lambda w: w)
        ha = [e(rows, act_ld(w)) for w in self.actor_dims[1:-1]]
        hc = [e(rows, act_ld(w)) for w in self.critic_dims[1:-1]]
        keep["h"] = ha + hc
        keep["loss_part"] = e(a.loss_blocks * a.loss_w, dtype=torch.float32)
        # per layer slot: (MLP k, layer l, in, out); actor slots first (layout order)
        slots = [(k, l, din, dout) for k, dims in enumerate((self.actor_dims, self.critic_dims))
                 for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))]

        a.obs, a.cobs, a.fscal = obs.data_ptr(), cobs.data_ptr(), fs.data_ptr()
        a.p = p.data_ptr()
        a.g, a.aux = keep["g"].data_ptr(), keep["aux"].data_ptr()
        # hidden activations: the actor's in slots [0, nA-1), the critic's from MAX_LAYERS
        for i, h in enumerate(ha):
            a.h[i] = h.data_ptr()
        for i, h in enumerate(hc):
            a.h[MAX_LAYERS + i] = h.data_ptr()
        a.mean, a.value = keep["mean"].data_ptr(), keep["value"].data_ptr()
        a.loss_part = keep["loss_part"].data_ptr()

        if not bf:
            # f32 chain: ping-pong backward gradients, one layer's partials at a time
            gw = max(self.actor_dims[1:-1] + self.critic_dims[1:-1] + [A, 1])
            keep["gbuf"] = [e(rows, gw) for _ in range(4)]
            for i, gb in enumerate(keep["gbuf"]):
                a.gbuf[i] = gb.data_ptr()
            a.gtop[0], a.gtop[1] = a.gbuf[0], a.gbuf[2]
            a.gtop_ld[0], a.gtop_ld[1] = A, 1
            keep["part"] = e(a.wgrad_splits * max(o * (i + 1) for _, _, i, o in slots), dtype=torch.float32)
            a.part = keep["part"].data_ptr()
            return a, keep

        # bf16 chain: packed weights, every layer's gradients and partials kept
        # until the one reduction at the end
        a.q_total = self.q_total
        for i, (off, ld) in enumerate(self.q_layout):
            a.q_off[i], a.q_ld[i] = off, ld
        keep["q"] = e(self.q_total)
        a.q = keep["q"].data_ptr()
        keep["gtop"] = [e(rows, _round_up(A, 8)), e(rows, 8)]
        for k, t in enumerate(keep["gtop"]):
            a.gtop[k], a.gtop_ld[k] = t.data_ptr(), t.stride(0)
        keep["gin"] = []
        part_n = bsum_n = 0
        row_tiles = -(-rows // 64)   # wg_gemm's output rows per tile
        for i, (k, l, din, dout) in enumerate(slots):
            if l >= 1:   # the gradient at this layer's input
                t = e(rows, act_ld(din))
                keep["gin"].append(t)
                a.gin[k * MAX_LAYERS + l] = t.data_ptr()
            a.part_off[i] = part_n
            part_n += _round_up(a.wgrad_splits * din * dout, 4)   # 16-B aligned layers
            nl = len(self.actor_dims if k == 0 else self.critic_dims) - 1
            if l < nl - 1:   # bias partials, written by the input gradient of layer l + 1
                a.bsum_off[i] = bsum_n
                bsum_n += row_tiles * dout
        keep["part"] = e(part_n, dtype=torch.float32)
        keep["bsum"] = e(max(bsum_n, 1), dtype=torch.float32)
        a.part, a.bsum = keep["part"].data_ptr(), keep["bsum"].data_ptr()
        keep["plan"] = _Plan(_lib("k2"), a)
        return a, keep

    def _k2_launch(self, lib, args, mb_index: int, dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.k2_step(ctypes.addressof(args), int(mb_index), stream)
        _check(err, "K2 launch")
        _build.count_launch("k2")

    def grads(self, p, bufs, mb_index: int):
        """Gradient of ``PPO._minibatch_loss`` for minibatch ``mb_index``.

        ``p``: flat float32 params. ``bufs``: dict from :meth:`split_buffers`.
        Returns (loss, flat float32 gradient, aux dict of 0-d tensors)."""
        if p.device.type == "cpu":
            return self.grads_plain(p, bufs, mb_index)
        if p.device.type != "cuda":
            raise RuntimeError(f"K2 runs on CUDA tensors, got device {p.device}")
        if not 0 <= int(mb_index) < self.num_mini_batches:
            raise IndexError(f"minibatch {mb_index} of {self.num_mini_batches}")
        lib = _lib("k2")
        args, keep = self._k2_context(p, bufs)
        self._k2_launch(lib, args, mb_index, p.device)
        return self._finalize_grads(p, keep["g"], keep["aux"][:3])

    def step_context(self, p, bufs):
        """A persistent context of :meth:`grads` for the step path inside a
        CUDA graph (:class:`_StepContext`): K2 over the flat params ``p``,
        read where they lie, and over the minibatch buffers ``bufs`` (views
        of the caller's static buffers)."""
        return _StepContext(self, p, bufs)

    def _k3_args(self, ptrs, nblocks: int = K3_BLOCKS):
        """K3's argument struct: this spec's constants, and the device
        addresses in ``ptrs`` (p, m, v, g, aux, state, count0, part, step;
        a field left out stays null)."""
        b = _K3Args()
        for name, addr in ptrs.items():
            setattr(b, name, addr)
        b.n, b.std_off = self.net.num_params, self.std_off
        b.act_dim, b.fixed_std = self.act_dim, int(self.fixed_std)
        b.adaptive, b.nblocks = int(self.adaptive_lr), nblocks
        b.rows_f = float(self.rows)
        b.value_loss_coef, b.entropy_coef = self.value_loss_coef, self.entropy_coef
        b.ent_const = 0.5 + 0.5 * _LOG_2PI
        b.ent_fixed = (self.act_dim * (0.5 + 0.5 * _LOG_2PI)
                       + self.act_dim * math.log(self.init_noise_std))
        b.kl_hi, b.kl_lo = self.desired_kl * 2.0, self.desired_kl / 2.0
        b.lr_min, b.lr_max = self.lr_min, self.lr_max
        b.max_grad_norm = self.max_grad_norm
        b.b1, b.b2 = self.adam_b1, self.adam_b2
        b.omb1, b.omb2 = 1.0 - self.adam_b1, 1.0 - self.adam_b2
        b.log_b1, b.log_b2 = math.log(self.adam_b1), math.log(self.adam_b2)
        b.eps, b.std_floor = self.adam_eps, self.std_floor
        return b

    def _k3_context(self, p2, m2, v2, keep):
        """K3's argument struct over the update's p, m, v (updated in place)
        and K2's gradient and row sums in ``keep``, into which it puts K3's
        own buffers: ``count0`` (the Adam count at the update's start, int32
        [1]), ``state`` (the LR/metric state: two 8-float slots, step s reads
        slot s & 1; the caller fills count0 and state[0] = lr, the rest 0),
        ``k3_part`` and ``k3_step`` (the step record: ok, surr, vl, kl).
        Checks that the card holds K3's blocks at once."""
        dev = p2.device
        k3_coresident(dev)
        keep.update(count0=torch.zeros(1, dtype=torch.int32, device=dev),
                    state=torch.zeros(16, dtype=torch.float32, device=dev),
                    k3_part=torch.zeros(K3_BLOCKS, dtype=torch.float32, device=dev),
                    k3_step=torch.zeros(4, dtype=torch.float32, device=dev))
        return self._k3_args(dict(
            p=p2.data_ptr(), m=m2.data_ptr(), v=v2.data_ptr(), g=keep["g"].data_ptr(),
            aux=keep["aux"].data_ptr(), state=keep["state"].data_ptr(), count0=keep["count0"].data_ptr(),
            part=keep["k3_part"].data_ptr(), step=keep["k3_step"].data_ptr()))

    def _graph_key(self, dev, bufs):
        """What an update's CUDA graph bakes in: the device, the operand
        type, rows, minibatches and epochs (the step count), the buffer
        shapes, and every constant of K2's and K3's argument structs."""
        dev = torch.device(dev)
        if dev.index is None:
            dev = torch.device(dev.type, torch.cuda.current_device())
        spec = (self.obs_dim, self.cobs_dim, self.act_dim, tuple(self.actor_dims), tuple(self.critic_dims),
                self.fixed_std, self.init_noise_std, self.std_floor, self.clip_param, self.value_loss_coef,
                self.entropy_coef, self.use_clipped_value_loss, self.max_grad_norm, self.adam_b1,
                self.adam_b2, self.adam_eps, self.adaptive_lr, self.desired_kl, self.lr_min, self.lr_max)
        return (dev, self.op_dtype, self.rows, self.num_mini_batches, self.num_epochs,
                tuple(tuple(bufs[k].shape) for k in ("obs", "cobs", "fscal")), spec)

    def update_graph(self, dev, bufs):
        """The update's persistent context and CUDA graph for these buffers
        (:class:`_UpdateGraph`), made at first use. The cache is one dict
        that copies of this ``FusedPPOGrad`` share, keyed by
        :meth:`_graph_key`."""
        key = self._graph_key(dev, bufs)
        if key not in self._graphs:
            self._graphs[key] = _UpdateGraph(self, dev, bufs)
        return self._graphs[key]

    def donated_update(self, dev, bufs, p, m, v):
        """A context (not cached) for updates that read and write the flat
        float32 ``p``, ``m`` and ``v`` in place (a donated state): the caller
        stages each update's inputs (:meth:`_UpdateGraph.stage_inputs`),
        captures once (:meth:`_UpdateGraph.capture`, with its epilogue) and
        replays (:meth:`_UpdateGraph.replay`)."""
        for name, x in (("p", p), ("m", m), ("v", v)):
            if x.dtype != torch.float32 or x.shape != (self.net.num_params,) or x.device != p.device \
                    or x.device.type != "cuda" or not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32 ({self.net.num_params},) on p's CUDA device")
        return _UpdateGraph(self, dev, bufs, state=(p, m, v))

    def update_scan(self, p, m, v, count, lr, bufs):
        """The whole PPO update. ``p``, ``m``, ``v``: flat float32 params and
        Adam moments; ``count``: the Adam step count (int32 0-d tensor);
        ``lr``: the live learning rate (float32 0-d tensor). Returns
        (p', m', v', lr_final, metric means); the inputs are not modified.
        On the card the inputs are copied into the update's context and its
        CUDA graph replayed (captured at the first call for these shapes);
        nothing is read back to the host."""
        if p.device.type == "cpu":
            return self.update_scan_plain(p, m, v, count, lr, bufs)
        if p.device.type != "cuda":
            raise RuntimeError(f"K3 runs on CUDA tensors, got device {p.device}")
        dev = p.device
        for name, x in (("p", p), ("m", m), ("v", v)):
            if x.dtype != torch.float32 or x.shape != (self.net.num_params,) or x.device != dev:
                raise ValueError(f"{name} must be float32 ({self.net.num_params},) on {dev}")
        if count.dtype != torch.int32 or count.numel() != 1 or count.device != dev:
            raise ValueError("count must be a one-element int32 tensor on the params' device")
        if lr.numel() != 1 or lr.device != dev:
            raise ValueError("lr must be a one-element tensor on the params' device")
        ctx = self.update_graph(dev, bufs)
        # the named range lets a profile count the host's launch calls in an update
        with torch.cuda.device(dev), torch.profiler.record_function("FusedPPOGrad.update_scan"):
            if ctx.graph is None:
                ctx.capture(self)
            ctx.stage(self, p, m, v, count, lr, bufs)
            ctx.replay()
        return ctx.results()


class _StepContext:
    """K2's context for the step path's grad steps, made once and kept as
    long as the graph that launches from it: the argument struct, the
    launch plan (tensor maps encoded once), the scratch and the repacked
    operands, over the params ``p`` (the caller's static buffer, updated in
    place between the steps) and the minibatch buffers ``bufs``.
    :meth:`stage` copies ``bufs`` into the operands once an update;
    :meth:`grads` is :meth:`FusedPPOGrad.grads` for minibatch ``mb_index``.
    On CPU tensors it runs the plain version on ``p`` and ``bufs``."""

    def __init__(self, fused, p, bufs):
        self.fused, self.p, self.bufs = fused, p, bufs
        if p.device.type == "cpu":
            return
        ops = fused._k2_operands(bufs, p.device)
        ops["fscal"] = ops["fscal"].clone(memory_format=torch.contiguous_format)
        self.ops = ops
        self.args, self.keep = fused._k2_args(p, ops)

    def stage(self):
        """Copy the minibatch buffers into K2's operands (on the current
        stream)."""
        if self.p.device.type != "cpu":
            self.fused._k2_operands(self.bufs, self.p.device, out=self.ops)

    def grads(self, mb_index: int, p=None):
        """``p``: params copied into the context's first (the eager loop,
        whose params are a new tensor each step); default: as they lie."""
        fused = self.fused
        if p is not None and p is not self.p:
            self.p.copy_(p)
        if self.p.device.type == "cpu":
            return fused.grads_plain(self.p, self.bufs, mb_index)
        fused._k2_launch(_lib("k2"), self.args, mb_index, self.p.device)
        return fused._finalize_grads(self.p, self.keep["g"], self.keep["aux"][:3])


class _UpdateGraph:
    """One update of a ``FusedPPOGrad`` on the card, as a CUDA graph over
    buffers it owns: the working p, m, v; K2's operands (repacked obs and
    critic obs, the f32 scalars), scratch, argument struct and launch plan
    (tensor maps encoded once); K3's argument struct, count, LR/metric state,
    partial sums and step record. The graph and the structs bake these
    addresses in, so the context keeps every one of them alive as long as
    the graph. :meth:`stage` copies an update's inputs in; the graph, steps
    x (K2's chain on minibatch s % MB, K3's fused step s), is captured at the
    first :meth:`capture` (no tensor is allocated during the capture but by
    its epilogue) and replayed per update (:meth:`replay`, which adds its
    launches: K2 ``steps``, K3 1). ``state``: the (p, m, v) to update in
    place (a donated state); default the context's own."""

    def __init__(self, fused, dev, bufs, state=None):
        self.dev = dev
        self.steps = fused.num_epochs * fused.num_mini_batches
        n = fused.net.num_params
        if state is None:
            state = (torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3))
        self.p, self.m, self.v = state
        ops = fused._k2_operands(bufs, dev)
        ops["fscal"] = ops["fscal"].clone(memory_format=torch.contiguous_format)
        self.ops = ops
        self.args2, self.keep = fused._k2_args(self.p, ops)
        self.args3 = fused._k3_context(self.p, self.m, self.v, self.keep)
        self.graph = None
        self.capture_ms = self.instantiate_ms = None
        self.nodes = None   # the captured graph's nodes (graphs.node_kinds: K3's steps are the cooperative ones)

    def stage(self, fused, p, m, v, count, lr, bufs):
        """Copy one update's inputs into the context (on the current stream)."""
        self.p.copy_(p)
        self.m.copy_(m)
        self.v.copy_(v)
        self.stage_inputs(fused, count, lr, bufs)

    def stage_inputs(self, fused, count, lr, bufs):
        """Copy one update's count, learning rate and minibatch buffers into
        the context (on the current stream; p, m and v are read where they
        lie)."""
        self.keep["count0"].copy_(count.reshape(1))
        state = self.keep["state"]
        state.zero_()
        state[:1].copy_(lr.reshape(1))
        fused._k2_operands(bufs, self.dev, out=self.ops)

    def capture(self, fused, epilogue=None):
        """Capture the update of ``fused`` into a CUDA graph and
        instantiate it; raises if any launch, the capture or the
        instantiation fails. Nothing runs on the card. ``epilogue``: a
        callable captured after the last step (its kernels must have run
        once before)."""
        lib2, lib3 = _lib("k2"), _lib("k3")
        a2, a3 = ctypes.addressof(self.args2), ctypes.addressof(self.args3)
        mb = fused.num_mini_batches
        # no kernel may be loaded for the first time inside the capture (K3's
        # step was loaded by k3_coresident)
        _check(lib2.k2_load(), "loading K2's kernels")
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _build.gc_held(), torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
            t0 = time.perf_counter()
            stream = torch.cuda.current_stream(self.dev).cuda_stream   # the capture stream
            for s in range(self.steps):
                _check(lib2.k2_step(a2, s % mb, stream), f"K2 launch (capture, step {s})")
                _check(lib3.k3_step(a3, s, stream), f"K3 step (capture, step {s})")
            if epilogue is not None:
                epilogue()
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        self.capture_ms, self.instantiate_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
        from wiki_grx_gym_tpu_torch.learn.graphs import node_kinds   # graphs imports this module

        self.nodes = node_kinds(graph)
        self.graph = graph

    def replay(self):
        """One update: replay the graph (on the current stream) and count
        its launches."""
        self.graph.replay()
        LAUNCHES["k2"] += self.steps
        LAUNCHES["k3"] += 1

    def outputs(self):
        """(lr_final, metric means) of the last replay: a view of the LR
        slot and new tensors of the means."""
        s = self.steps
        out = self.keep["state"][(s & 1) * 8:(s & 1) * 8 + 4]
        return out[0], {"value_loss": out[1] / s, "surrogate_loss": out[2] / s, "kl": out[3] / s}

    def results(self):
        """(p', m', v', lr_final, metric means) of the last replay, as new
        tensors (the next replay overwrites the context)."""
        lr, metrics = self.outputs()
        lr_final = lr.clone()
        return self.p.clone(), self.m.clone(), self.v.clone(), lr_final, dict(metrics, lr=lr_final)
