// K2: one PPO minibatch's clipped-PPO loss and its gradient, for sm_90a.
//
// Replaces the TPU kernel FusedPPOGrad.grads of
// wiki_grx_gym_tpu/learn/fused_update.py (pallas_call :462, body
// _grads_kernel :348 over _tile_body :200). Wrapper and plain version:
// wiki_grx_gym_tpu_torch/learn/fused_update.py (FusedPPOGrad.grads,
// grads_plain).
//
// What it computes, for minibatch `mb` of the update's shuffle buffers:
// both MLP forwards (actor -> mean, critic -> value; ELU hidden layers), the
// clipped surrogate, the (clipped) value loss and the KL, and the
// hand-derived backward with JAX's tie conventions (0.5 at max/clip ties).
// Outputs: the flat f32 gradient `g` (W (out, in) then b per layer, actor
// then critic, then std; the std entry WITHOUT the entropy term, which the
// caller adds, as the TPU kernel leaves it to its caller) and the row sums
// aux = (surr, value loss, kl).
//
// Rounding points are the TPU kernel's: obs/critic obs and weights in the
// operand type T (bf16, or float for the exact check), hidden activations
// stored in T after ELU, each backward gradient cast to T before its
// products, all sums in f32. elu(z) = exp(z) - 1 for z <= 0 (not expm1).
//
// Design. On the TPU one core streams 512-row tiles with the weights
// (~0.87 MB bf16) and the gradient accumulators resident in VMEM. On Hopper
// neither fits one SM's 227 KB and blocks cannot carry sums between grid
// steps, so a grad step is a short chain of kernels (k2_step):
//   cast params to T (bf16 only) -> per layer a tiled GEMM with fused bias
//   and ELU epilogue (activations stored in T) -> one row kernel for the
//   loss and the backward seeds, with per-block partials -> one block that
//   sums the partials -> per layer, from the top: a weight-gradient GEMM that
//   reduces over the rows in fixed row chunks (blockIdx.z) into per-chunk
//   partials, a pass that sums the chunks in order, and a dgrad GEMM whose
//   epilogue multiplies by elu'(h) = h + 1 (h <= 0) and casts to T.
// Every reduction runs in a fixed order (no atomics): two runs agree bit for
// bit. The products are SIMT FP32 FMAs on operands converted to f32, which
// computes what bf16 operands with f32 accumulation compute. The work is
// ~25 GFLOP per grad step at GR1T1's shapes (10480 rows, 435,072 weights):
// bound by operations (67 TFLOP/s FP32 outside the tensor cores for this
// design; 989 TFLOP/s on the bf16 tensor cores for a later wgmma one).
//
// Host interface (ctypes): k2_args_size() and
// k2_step(const K2Args*, int mb, cudaStream_t) -> cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXL 8      // layers per MLP
#define MAXA 32     // action dims

struct K2Args {
    int rows, act_dim, n_actor, n_critic;
    int actor_dims[MAXL + 1];
    int critic_dims[MAXL + 1];
    int op_bf16, fixed_std, clipped_vl, wgrad_splits;
    int wgrad_rows, loss_blocks;
    float clip_param, init_noise_std, coef_scale, gval_scale, logp_const, lo, hi, pad0;
    long long obs_ld, obs_mb_stride, cobs_ld, cobs_mb_stride, fs_ld, fs_mb_stride;
    long long w_off[2 * MAXL], b_off[2 * MAXL];   // actor layers, then critic layers
    long long std_off, n_params;
    const void* obs;
    const void* cobs;
    const float* fscal;
    const float* p;      // flat f32 params
    void* p_op;          // flat params in T (bf16 copy; == p for float)
    float* g;            // flat f32 gradient (written)
    float* aux;          // [3] row sums: surr, vl, kl
    void* h[2 * MAXL];   // hidden activations (rows, width) in T: actor [0..), critic [MAXL..)
    float* mean;         // (rows, A) f32
    float* value;        // (rows) f32
    void* gbuf[4];       // backward gradients in T: actor ping/pong, critic ping/pong
    float* part;         // weight-gradient partials (splits, out, in + 1)
    float* loss_part;    // loss partials (loss_blocks, A + 3)
};

extern "C" int k2_args_size() { return (int)sizeof(K2Args); }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// jnp.maximum / jnp.clip: NaN-propagating
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
// d max(a, b)/da and d clip(x, lo, hi)/dx with JAX's 0.5 at ties (fused_update.py:68-80)
__device__ __forceinline__ float max_grad(float a, float b) {
    return a > b ? 1.f : (a < b ? 0.f : 0.5f);
}
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
    return (x > lo && x < hi) ? 1.f : ((x == lo || x == hi) ? 0.5f : 0.f);
}

// ---------------------------------------------------------------------------
// tiled GEMM: C[m][n] = sum_k A(m, k) B(k, n), A(m, k) = a[m*a_sm + k*a_sk],
// B(k, n) = b[k*b_sk + n*b_sn]; 64x64 tile, 16 deep, 256 threads of 4x4
// ---------------------------------------------------------------------------

enum { EPI_HIDDEN = 0, EPI_OUT = 1, EPI_DGRAD = 2, EPI_PARTIAL = 3 };

struct Gemm {
    const void* a; long long a_sm, a_sk;
    const void* b; long long b_sk, b_sn;
    int M, N, K, k_chunk;
    int ones_col;                  // B column read as 1.0 (a wgrad's bias column), or -1
    const float* bias;             // EPI_HIDDEN, EPI_OUT
    const void* h; long long h_ld; // EPI_DGRAD: the layer's input activation
    void* c; long long c_ld;
};

#define BM 64
#define BN 64
#define BK 16

template <typename T, int EPI>
__global__ void __launch_bounds__(256) gemm_kernel(const Gemm g) {
    __shared__ float As[BK][BM + 4];
    __shared__ float Bs[BK][BN + 4];
    const T* A = (const T*)g.a;
    const T* B = (const T*)g.b;
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * g.k_chunk;
    const int kend = min(g.K, kbeg + g.k_chunk);
    const bool a_kc = (g.a_sk == 1);   // k contiguous in A: consecutive threads along k
    const bool b_nc = (g.b_sn == 1);   // n contiguous in B: consecutive threads along n
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int e = tid + i * 256;
            int mm, kk;
            if (a_kc) { mm = e / BK; kk = e % BK; } else { mm = e % BM; kk = e / BM; }
            int m = m0 + mm, k = k0 + kk;
            float av = 0.f;
            if (m < g.M && k < kend) av = to_f<T>(A[(long long)m * g.a_sm + (long long)k * g.a_sk]);
            As[kk][mm] = av;
            int nn;
            if (b_nc) { nn = e % BN; kk = e / BN; } else { kk = e % BK; nn = e / BK; }
            int n = n0 + nn;
            k = k0 + kk;
            float bv = 0.f;
            if (n < g.N && k < kend)
                bv = (n == g.ones_col) ? 1.f : to_f<T>(B[(long long)k * g.b_sk + (long long)n * g.b_sn]);
            Bs[kk][nn] = bv;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= g.N) continue;
            const float s = acc[i][j];
            if (EPI == EPI_HIDDEN) {
                const float z = s + g.bias[n];
                const float hv = z > 0.f ? z : expf(z) - 1.f;
                ((T*)g.c)[(long long)m * g.c_ld + n] = from_f<T>(hv);
            } else if (EPI == EPI_OUT) {
                ((float*)g.c)[(long long)m * g.c_ld + n] = s + g.bias[n];
            } else if (EPI == EPI_DGRAD) {
                const float hv = to_f<T>(((const T*)g.h)[(long long)m * g.h_ld + n]);
                const float d = hv > 0.f ? 1.f : hv + 1.f;
                ((T*)g.c)[(long long)m * g.c_ld + n] = from_f<T>(s * d);
            } else {
                ((float*)g.c)[(long long)blockIdx.z * g.M * g.N + (long long)m * g.N + n] = s;
            }
        }
    }
}

template <typename T, int EPI>
static void gemm(const Gemm& g, int splits, cudaStream_t st) {
    dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, splits);
    gemm_kernel<T, EPI><<<grid, 256, 0, st>>>(g);
}

// sum the weight-gradient chunk partials in order; column `in` is the bias
__global__ void wgrad_reduce(const float* part, int splits, int M, int N, float* gw, float* gb) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= M * N) return;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(long long)z * M * N + idx];
    const int o = idx / N, i = idx % N;
    if (i < N - 1) gw[(long long)o * (N - 1) + i] = s;
    else gb[o] = s;
}

__global__ void cast_params(const float* p, __nv_bfloat16* q, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) q[i] = __float2bfloat16_rn(p[i]);
}

// ---------------------------------------------------------------------------
// the loss and the backward seeds, one thread per row (_tile_body :257-304)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) loss_rows(const K2Args a, const float* fs) {
    extern __shared__ float red[];
    const int A = a.act_dim, W = A + 3;
    const int tid = threadIdx.x;
    const int r = blockIdx.x * blockDim.x + tid;
    float vals[MAXA + 3];
    for (int w = 0; w < W; ++w) vals[w] = 0.f;
    if (r < a.rows) {
        const float* f = fs + (long long)r * a.fs_ld;
        const float* mean = a.mean + (long long)r * A;
        const float* stdp = a.p + a.std_off;
        float slog = 0.f, sq = 0.f;
        for (int j = 0; j < A; ++j) {
            const float sd = a.fixed_std ? a.init_noise_std : stdp[j];
            slog += logf(sd);
            const float diff = f[j] - mean[j];
            sq += diff * diff / (sd * sd);
        }
        const float logp = -0.5f * sq - (a.logp_const + slog);
        const float old_logp = f[A];
        const float ratio = expf(logp - old_logp);
        const float ratio_c = jclip(ratio, a.lo, a.hi);
        const float adv = f[3 * A + 3];
        const float surr1 = -adv * ratio;
        const float surr2 = -adv * ratio_c;
        const float surr = jmax(surr1, surr2);
        float kl = 0.f;
        for (int j = 0; j < A; ++j) {
            const float sd = a.fixed_std ? a.init_noise_std : stdp[j];
            const float var = sd * sd;
            const float om = f[A + 1 + j], os = f[2 * A + 1 + j];
            const float dm = om - mean[j];
            kl += logf(sd / os + 1e-5f) + (os * os + dm * dm) / (2.f * var) - 0.5f;
        }
        const float value = a.value[r];
        const float old_v = f[3 * A + 1], ret = f[3 * A + 2];
        const float e = value - ret;
        float vl, gv_raw;
        if (a.clipped_vl) {
            const float vdelta = value - old_v;
            const float ec = old_v + jclip(vdelta, -a.clip_param, a.clip_param) - ret;
            const float e2 = e * e, ec2 = ec * ec;
            vl = jmax(e2, ec2);
            const float gm = max_grad(e2, ec2);
            gv_raw = gm * (2.f * e) + (1.f - gm) * (2.f * ec * clip_grad(vdelta, -a.clip_param, a.clip_param));
        } else {
            vl = e * e;
            gv_raw = 2.f * e;
        }
        const float gm_s = max_grad(surr1, surr2);
        const float d_ratio = gm_s * (-adv) + (1.f - gm_s) * (-adv * clip_grad(ratio, a.lo, a.hi));
        const float coef = d_ratio * ratio * a.coef_scale;
        T* gmean = (T*)a.gbuf[0] + (long long)r * A;
        for (int j = 0; j < A; ++j) {
            const float sd = a.fixed_std ? a.init_noise_std : stdp[j];
            const float var = sd * sd;
            const float diff = f[j] - mean[j];
            gmean[j] = from_f<T>(coef * (diff / var));
            vals[j] = coef * (diff * diff / var - 1.f) / sd;
        }
        ((T*)a.gbuf[2])[r] = from_f<T>(gv_raw * a.gval_scale);
        vals[A] = surr;
        vals[A + 1] = vl;
        vals[A + 2] = kl;
    }
    for (int w = 0; w < W; ++w) red[tid * W + w] = vals[w];
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (tid < s)
            for (int w = 0; w < W; ++w) red[tid * W + w] += red[(tid + s) * W + w];
        __syncthreads();
    }
    if (tid < W) a.loss_part[(long long)blockIdx.x * W + tid] = red[tid];
}

// the loss partials summed in block order: d_std (raw) and the row sums
__global__ void loss_reduce(const K2Args a) {
    const int W = a.act_dim + 3, w = threadIdx.x;
    if (w >= W) return;
    float s = 0.f;
    for (int b = 0; b < a.loss_blocks; ++b) s += a.loss_part[(long long)b * W + w];
    if (w < a.act_dim) a.g[a.std_off + w] = a.fixed_std ? 0.f : s;
    else a.aux[w - a.act_dim] = s;
}

// ---------------------------------------------------------------------------
// the chain
// ---------------------------------------------------------------------------

template <typename T>
static void forward(const K2Args& a, const T* p_op, const T* x, long long x_ld, const int* dims,
                    int nl, int off0, int hslot, float* out, int out_ld, cudaStream_t st) {
    const T* in = x;
    long long in_ld = x_ld;
    for (int l = 0; l < nl; ++l) {
        Gemm g = {};
        g.a = in; g.a_sm = in_ld; g.a_sk = 1;
        g.b = p_op + a.w_off[off0 + l]; g.b_sk = 1; g.b_sn = dims[l];   // B(k=i, n=o) = W[o][i]
        g.M = a.rows; g.N = dims[l + 1]; g.K = dims[l]; g.k_chunk = dims[l];
        g.ones_col = -1;
        g.bias = a.p + a.b_off[off0 + l];
        if (l < nl - 1) {
            g.c = a.h[hslot + l]; g.c_ld = dims[l + 1];
            gemm<T, EPI_HIDDEN>(g, 1, st);
            in = (const T*)a.h[hslot + l];
            in_ld = dims[l + 1];
        } else {
            g.c = out; g.c_ld = out_ld;
            gemm<T, EPI_OUT>(g, 1, st);
        }
    }
}

template <typename T>
static void backward(const K2Args& a, const T* p_op, const T* x, long long x_ld, const int* dims,
                     int nl, int off0, int hslot, int gslot, cudaStream_t st) {
    int cur = gslot;   // gbuf[gslot] holds the top gradient (rows, dims[nl]) in T
    for (int l = nl - 1; l >= 0; --l) {
        const int in = dims[l], out = dims[l + 1];
        const T* hin = l == 0 ? x : (const T*)a.h[hslot + l - 1];
        const long long hin_ld = l == 0 ? x_ld : in;
        const T* gcur = (const T*)a.gbuf[cur];
        // weight + bias gradient: C[o][i] = sum_r g[r][o] hin[r][i], column `in` = sum_r g[r][o]
        Gemm w = {};
        w.a = gcur; w.a_sm = 1; w.a_sk = out;
        w.b = hin; w.b_sk = hin_ld; w.b_sn = 1;
        w.M = out; w.N = in + 1; w.K = a.rows; w.k_chunk = a.wgrad_rows;
        w.ones_col = in;
        w.c = a.part;
        gemm<T, EPI_PARTIAL>(w, a.wgrad_splits, st);
        const int n = out * (in + 1);
        wgrad_reduce<<<(n + 255) / 256, 256, 0, st>>>(a.part, a.wgrad_splits, out, in + 1,
                                                      a.g + a.w_off[off0 + l], a.g + a.b_off[off0 + l]);
        if (l > 0) {
            // input gradient: C[r][i] = sum_o g[r][o] W[o][i], times elu'(h), cast to T
            const int nxt = gslot + ((cur - gslot) ^ 1);
            Gemm d = {};
            d.a = gcur; d.a_sm = out; d.a_sk = 1;
            d.b = p_op + a.w_off[off0 + l]; d.b_sk = in; d.b_sn = 1;
            d.M = a.rows; d.N = in; d.K = out; d.k_chunk = out;
            d.ones_col = -1;
            d.h = hin; d.h_ld = in;
            d.c = a.gbuf[nxt]; d.c_ld = in;
            gemm<T, EPI_DGRAD>(d, 1, st);
            cur = nxt;
        }
    }
}

template <typename T>
static int run(const K2Args& a, int mb, cudaStream_t st) {
    const T* p_op = (const T*)a.p;
    if (a.op_bf16) {
        // weights cast to the operand type once per call (fused_update.py:396-416)
        cast_params<<<(unsigned)((a.n_params + 255) / 256), 256, 0, st>>>(
            a.p, (__nv_bfloat16*)a.p_op, a.n_params);
        p_op = (const T*)a.p_op;
    }
    const T* obs = (const T*)a.obs + (long long)mb * a.obs_mb_stride;
    const T* cobs = (const T*)a.cobs + (long long)mb * a.cobs_mb_stride;
    const float* fs = a.fscal + (long long)mb * a.fs_mb_stride;
    forward<T>(a, p_op, obs, a.obs_ld, a.actor_dims, a.n_actor, 0, 0, a.mean, a.act_dim, st);
    forward<T>(a, p_op, cobs, a.cobs_ld, a.critic_dims, a.n_critic, a.n_actor, MAXL, a.value, 1, st);
    const int W = a.act_dim + 3;
    loss_rows<T><<<a.loss_blocks, 256, 256 * W * sizeof(float), st>>>(a, fs);
    loss_reduce<<<1, 64, 0, st>>>(a);
    backward<T>(a, p_op, obs, a.obs_ld, a.actor_dims, a.n_actor, 0, 0, 0, st);
    backward<T>(a, p_op, cobs, a.cobs_ld, a.critic_dims, a.n_critic, a.n_actor, MAXL, 2, st);
    return (int)cudaGetLastError();
}

extern "C" int k2_step(const K2Args* a, int mb, cudaStream_t st) {
    if (a->act_dim > MAXA || a->act_dim + 3 > 64 || a->n_actor > MAXL || a->n_critic > MAXL)
        return (int)cudaErrorInvalidValue;
    return a->op_bf16 ? run<__nv_bfloat16>(*a, mb, st) : run<float>(*a, mb, st);
}
