// K3: the optimizer step of the whole-update PPO kernel, for sm_90a.
//
// Replaces the TPU kernel FusedPPOGrad.update_scan of
// wiki_grx_gym_tpu/learn/fused_update.py (pallas_call :708, body
// _update_kernel :511, its _finalize_step :579-657). Wrapper and plain
// version: wiki_grx_gym_tpu_torch/learn/fused_update.py
// (FusedPPOGrad.update_scan, _k3_step_plain, update_scan_plain).
//
// The TPU kernel keeps params, Adam moments and gradients (~7 MB f32 for
// GR1T1) resident in 16 MB of VMEM across a sequential (steps, tiles) grid.
// On Hopper four such copies fit no SM, so the update is an on-device
// sequence: for each of the epochs x minibatches grad steps, K2's chain
// (csrc/ppo_grads.cu) writes the flat f32 gradient and the row sums, then
// one launch of k3_fused_step finalises the step. The wrapper captures the
// whole sequence (200 x (K2's 11 launches + this one) for GR1T1) once into
// a CUDA graph and replays it per update.
//
// What bounds the step: bytes. It reads g once and p, m, v once and writes
// p, m, v once, 7 x 4 B per parameter: 12.23 MB at GR1T1's 436,885
// parameters, 3.65 us at 3.35 TB/s. The whole working set (p, m, v, g,
// ~7 MB) stays in the 50 MB L2 between steps, so launch latency and the
// dependent chain (sum, barrier, sum, update) set the time, not HBM.
//
// What the design does about it: one launch per step, one read of g.
// k3_fused_step runs K3_BLOCKS blocks of 256 threads, all co-resident
// (2 an SM suffice on 132 SMs; the wrapper checks with
// cudaOccupancyMaxActiveBlocksPerMultiprocessor before its first launch and
// raises otherwise). Each block owns one chunk of the flat vector
// (chunk_of: ~2,023 entries, 8 a thread at GR1T1's size).
//   phase A: each thread loads its entries of g, p, m, v into registers;
//            meanwhile thread 0 of each block finalises the loss (surrogate
//            + value loss - entropy, ok = isfinite(loss)), block 0 records
//            it; the std entries' gradient gains the entropy term, and the
//            block forms its partial sum of (g * ok)^2 and writes
//            part[block].
//   grid barrier: a cooperative launch (cudaLaunchAttributeCooperative,
//            cooperative_groups::this_grid().sync()). The card's toolkit
//            and driver capture a cooperative launch into a CUDA graph and
//            replay it with the barrier intact, so no hand-written barrier
//            is needed.
//   phase B: every block sums part[] in the same fixed order (so all see
//            the same global norm), applies the adaptive-KL learning rate
//            from this step's KL, clip by global norm, K3's bias correction
//            1 - exp(c log b) with the carried count, then Adam and the std
//            floor on its entries from the registers; block 0 writes the
//            LR/metric slot.
// The grads are multiplied by ok, not skipped, as on the TPU: m and v still
// decay and the count still advances. The learning rate and the metric sums
// live in a small device buffer of two 8-float slots: step s reads slot s&1
// and block 0 writes slot (s+1)&1, so no block reads what another writes in
// the same launch. Nothing is read back to the host until the update ends.
//
// PR 2's two-launch step (k3_norm: loss, entropy term and partial sums;
// k3_adam: norm, LR, Adam) stays as the fused step's bit-for-bit reference
// behind k3_step_ref; the main path never calls it. Both paths run the same
// __device__ helpers below (loss, norm terms, block sums, step scalars, one
// entry's Adam update) in the same order, so FMA contraction cannot differ
// between them.
//
// Host interface (ctypes): k3_args_size(), k3_coresident(int*),
// k3_step(const K3Args*, int step, cudaStream_t) (the fused step),
// k3_step_ref(...) (the reference pair), each -> cudaError_t.
// csrc/host/k3_host.cpp compiles the kernels for the CPU (K3_SMEM and the
// grid barrier from csrc/host/).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <new>

struct K3Args {
    long long n, std_off;
    float* p;
    float* m;
    float* v;
    float* g;              // K2's flat gradient (the std entries gain the entropy term here)
    const float* aux;      // K2's row sums: surr, vl, kl
    float* state;          // [2][8]: lr, vl sum, surr sum, kl sum (ping-pong slots)
    const int* count0;     // Adam count at the start of the update
    float* part;           // [nblocks] partial sums of (g * ok)^2
    float* step;           // [4] this step's ok, surr mean, vl mean, kl mean
    int act_dim, fixed_std, adaptive, nblocks;
    float rows_f, value_loss_coef, entropy_coef, ent_const, ent_fixed;
    float kl_hi, kl_lo, lr_min, lr_max;
    float max_grad_norm, b1, b2, omb1, omb2, log_b1, log_b2, eps, std_floor;
};

extern "C" int k3_args_size() { return (int)sizeof(K3Args); }

#define THREADS 256
#define K3_PER 16          // entries a thread of the fused step holds in registers

// one step's loss terms and the scalars of its Adam update
struct K3Loss {
    float ok, surr, vl, kl;
};
struct K3Scalars {
    float gscale, lr, bc1, bc2;
};

// a block's shared memory (the host build gives each block its own)
struct K3Smem {
    float red[THREADS];
    K3Loss loss;
    K3Scalars sc;
};
#ifndef K3_SMEM
#define K3_SMEM(name) __shared__ K3Smem name
#endif

__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ void chunk_of(const K3Args& a, long long& beg, long long& end) {
    const long long c = (a.n + gridDim.x - 1) / gridDim.x;
    beg = (long long)blockIdx.x * c;
    end = beg + c < a.n ? beg + c : a.n;
}

__device__ __forceinline__ bool is_std(const K3Args& a, long long i) {
    return i >= a.std_off && i < a.std_off + a.act_dim;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
    red[threadIdx.x] = x;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    const float r = red[0];
    __syncthreads();
    return r;
}

// the loss finalisation (_finalize_step :580-592), from K2's row sums and the std
__device__ __forceinline__ K3Loss finalize_loss(const K3Args& a) {
    K3Loss L;
    L.surr = a.aux[0] / a.rows_f;
    L.vl = a.aux[1] / a.rows_f;
    L.kl = a.aux[2] / a.rows_f;
    float ent;
    if (a.fixed_std) {
        ent = a.ent_fixed;
    } else {
        ent = 0.f;
        for (int j = 0; j < a.act_dim; ++j) ent += a.ent_const + logf(a.p[a.std_off + j]);
    }
    const float loss = L.surr + a.value_loss_coef * L.vl - a.entropy_coef * ent;
    L.ok = isfinite(loss) ? 1.f : 0.f;
    return L;
}

__device__ __forceinline__ void record_loss(const K3Args& a, const K3Loss& L) {
    a.step[0] = L.ok;
    a.step[1] = L.surr;
    a.step[2] = L.vl;
    a.step[3] = L.kl;
}

// a std entry's gradient gains the entropy term: d_std += -ce / std (:588)
__device__ __forceinline__ float std_grad(const K3Args& a, float gi, float pi) {
    return gi + (-a.entropy_coef) / pi;
}

__device__ __forceinline__ float norm_term(float acc, float gi, float ok) {
    const float x = gi * ok;
    return acc + x * x;
}

// the global sum of (g * ok)^2 from the blocks' partials, in the same fixed
// order in every block
__device__ __forceinline__ float global_sq(const K3Args& a, float* red) {
    float acc = 0.f;
    for (int b = threadIdx.x; b < a.nblocks; b += THREADS) acc += a.part[b];
    return block_sum(acc, red);
}

// the adaptive-KL learning rate applied to this step (rsl_rl ppo.py:207-213),
// clip by global norm, K3's bias correction; block 0 writes slot (s+1)&1
__device__ __forceinline__ K3Scalars step_scalars(const K3Args& a, const K3Loss& L, float gsq, int s) {
    const float* in = a.state + (s & 1) * 8;
    float lr = in[0];
    if (a.adaptive) {
        const float lr_dn = jmax(a.lr_min, lr / 1.5f);
        const float lr_up = jmin(a.lr_max, lr * 1.5f);
        lr = L.kl > a.kl_hi ? lr_dn : ((L.kl < a.kl_lo && L.kl > 0.f) ? lr_up : lr);
    }
    const float gnorm = sqrtf(gsq);
    const bool trigger = gnorm < a.max_grad_norm;
    const float c = (float)(a.count0[0] + s + 1);
    K3Scalars sc;
    sc.gscale = L.ok * (trigger ? 1.f : a.max_grad_norm / gnorm);
    sc.lr = lr;
    sc.bc1 = 1.f - expf(c * a.log_b1);
    sc.bc2 = 1.f - expf(c * a.log_b2);
    if (blockIdx.x == 0) {
        float* out = a.state + ((s + 1) & 1) * 8;
        out[0] = lr;
        out[1] = in[1] + L.vl;
        out[2] = in[2] + L.surr;
        out[3] = in[3] + L.kl;
    }
    return sc;
}

// one entry's Adam update and the std floor
__device__ __forceinline__ void adam_entry(const K3Args& a, const K3Scalars& sc, long long i, float gi,
                                           float& pi, float& mi, float& vi) {
    const float gs = gi * sc.gscale;
    mi = a.b1 * mi + a.omb1 * gs;
    vi = a.b2 * vi + a.omb2 * (gs * gs);
    pi = pi - sc.lr * (mi / sc.bc1) / (sqrtf(vi / sc.bc2) + a.eps);
    if (a.std_floor > 0.f && is_std(a, i)) pi = jmax(pi, a.std_floor);
}

// ---------------------------------------------------------------------------
// the main path: one launch a step behind a grid barrier
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2) k3_fused_step(const K3Args a, int s) {
    K3_SMEM(sm);
    long long beg, end;
    chunk_of(a, beg, end);
    // the block's loads are in flight while thread 0 finalises the loss
    float g[K3_PER], p[K3_PER], m[K3_PER], v[K3_PER];
#pragma unroll
    for (int k = 0; k < K3_PER; ++k) {
        const long long i = beg + threadIdx.x + (long long)k * THREADS;
        if (i < end) {
            g[k] = a.g[i];
            p[k] = a.p[i];
            m[k] = a.m[i];
            v[k] = a.v[i];
        }
    }
    if (threadIdx.x == 0) {
        sm.loss = finalize_loss(a);
        if (blockIdx.x == 0) record_loss(a, sm.loss);
    }
    __syncthreads();
    const K3Loss L = sm.loss;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K3_PER; ++k) {
        const long long i = beg + threadIdx.x + (long long)k * THREADS;
        if (i < end) {
            if (!a.fixed_std && is_std(a, i)) {
                g[k] = std_grad(a, g[k], p[k]);
                a.g[i] = g[k];
            }
            acc = norm_term(acc, g[k], L.ok);
        }
    }
    const float part = block_sum(acc, sm.red);
    if (threadIdx.x == 0) a.part[blockIdx.x] = part;

    cooperative_groups::this_grid().sync();

    const float gsq = global_sq(a, sm.red);
    if (threadIdx.x == 0) sm.sc = step_scalars(a, L, gsq, s);
    __syncthreads();
    const K3Scalars sc = sm.sc;
#pragma unroll
    for (int k = 0; k < K3_PER; ++k) {
        const long long i = beg + threadIdx.x + (long long)k * THREADS;
        if (i < end) {
            adam_entry(a, sc, i, g[k], p[k], m[k], v[k]);
            a.m[i] = m[k];
            a.v[i] = v[k];
            a.p[i] = p[k];
        }
    }
}

// ---------------------------------------------------------------------------
// the reference: PR 2's two launches a step (the same helpers, the same order)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) k3_norm(const K3Args a) {
    K3_SMEM(sm);
    if (threadIdx.x == 0) {
        // every block computes the loss from the same inputs, block 0 records it for k3_adam
        sm.loss = finalize_loss(a);
        if (blockIdx.x == 0) record_loss(a, sm.loss);
    }
    __syncthreads();
    const float ok = sm.loss.ok;
    long long beg, end;
    chunk_of(a, beg, end);
    float acc = 0.f;
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        float gi = a.g[i];
        if (!a.fixed_std && is_std(a, i)) {
            gi = std_grad(a, gi, a.p[i]);
            a.g[i] = gi;
        }
        acc = norm_term(acc, gi, ok);
    }
    const float part = block_sum(acc, sm.red);
    if (threadIdx.x == 0) a.part[blockIdx.x] = part;
}

__global__ void __launch_bounds__(THREADS) k3_adam(const K3Args a, int s) {
    K3_SMEM(sm);
    const float gsq = global_sq(a, sm.red);
    if (threadIdx.x == 0) {
        K3Loss L;
        L.ok = a.step[0];
        L.surr = a.step[1];
        L.vl = a.step[2];
        L.kl = a.step[3];
        sm.sc = step_scalars(a, L, gsq, s);
    }
    __syncthreads();
    const K3Scalars sc = sm.sc;
    long long beg, end;
    chunk_of(a, beg, end);
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        float pi = a.p[i], mi = a.m[i], vi = a.v[i];
        adam_entry(a, sc, i, a.g[i], pi, mi, vi);
        a.m[i] = mi;
        a.v[i] = vi;
        a.p[i] = pi;
    }
}

// ---------------------------------------------------------------------------
// host entries
// ---------------------------------------------------------------------------

// the fused step holds a block's chunk in K3_PER entries a thread
static inline bool fits(const K3Args* a) {
    return a->n > 0 && a->nblocks > 0 && (a->n + a->nblocks - 1) / a->nblocks <= (long long)K3_PER * THREADS;
}

#ifndef K3_KERNELS_ONLY

// blocks of k3_fused_step that can be resident at once on the current device
// (0 if it refuses cooperative launches); also loads the step's kernel, so
// that it is not loaded for the first time while a stream is captured
extern "C" int k3_coresident(int* blocks) {
    int dev, coop, sms, per_sm;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, k3_fused_step);
    if (!e) e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_fused_step, THREADS, 0);
    if (e) return (int)e;
    *blocks = coop ? per_sm * sms : 0;
    return 0;
}

extern "C" int k3_step(const K3Args* a, int s, cudaStream_t st) {
    if (!fits(a)) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a->nblocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, k3_fused_step, *a, s);
    if (e) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" int k3_step_ref(const K3Args* a, int s, cudaStream_t st) {
    if (a->nblocks <= 0) return (int)cudaErrorInvalidValue;
    k3_norm<<<a->nblocks, THREADS, 0, st>>>(*a);
    k3_adam<<<a->nblocks, THREADS, 0, st>>>(*a, s);
    return (int)cudaGetLastError();
}

#endif  // K3_KERNELS_ONLY
