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
// The work is ~25 GFLOP per grad step at GR1T1's shapes (10480 rows,
// 435,072 weights): bound by operations, 0.025 ms at the 989 TFLOP/s of the
// bf16 tensor cores. On the TPU one core streams 512-row tiles with the
// weights and the gradient accumulators resident in VMEM; on Hopper neither
// fits one SM and blocks cannot carry sums between grid steps, so a grad
// step is a short chain of kernels. Two chains:
//
// bf16 operands (the main path), on the tensor cores (run_tc, 11 launches
// for two 4-layer MLPs):
//   pack_params: the f32 params -> a packed bf16 copy, each W (out, in) at a
//     128-B aligned offset with its row padded to a multiple of 16 with
//     zeros (the obs buffers come repacked the same way by the wrapper);
//   wg_gemm, one grouped launch per layer depth (actor and critic problems
//     together): forward with the bias + ELU epilogue (activations stored
//     in bf16), the heads with a bias epilogue in f32;
//   loss_rows: the loss and the backward seeds per row, per-block partials
//     of d_std, the row sums and the heads' bias gradients;
//   wg_gemm, one grouped launch per depth from the top: the input gradient
//     with the elu'(h) = h + 1 epilogue, cast to bf16, and the column sums
//     of that bf16 gradient per 64-row tile (the bias gradient of the layer
//     below);
//   wg_gemm, one grouped launch for every layer's weight gradient: a fixed
//     split over row chunks of WGRAD_ROWS into per-chunk f32 partials;
//   k2_reduce: one launch sums every partial in order (weight chunks, bias
//     tiles, loss blocks) into g and aux.
// wg_gemm is one warpgroup per 64 x 128 output tile: TMA brings 64 x 64
// bf16 boxes (128-B swizzle) into a ring of WG_STAGES stages, each completed on
// an mbarrier; wgmma m64n128k16 reads both operands from shared memory and
// keeps the f32 sums in registers. The forward is A (rows, K) x W^T with
// both operands K-major; the input gradient G (rows, out) x W reads W
// N-major (wgmma's transpose bit for B); the weight gradient G^T x H reduces
// over rows, so both operands are M/N-major (transpose bits for A and B).
// Ragged edges (rows, K = 39 or 168, heads of 10 and 1 columns) come in as
// zeros from TMA's out-of-bounds fill and the epilogues mask their stores.
// Hidden layers of any width: their activations and input gradients are
// stored with the row stride rounded up to 8 (act_ld). The heads run on the same kernel (their ~90 MFLOP pad to the tile).
//
// float32 operands (the exact check; wgmma takes no f32 operands and TF32
// would round them): the SIMT chain of run_f32: per layer a 64x64-tile
// FP32 GEMM with the same epilogues, the weight gradient with a ones column
// for the bias, chunk sums per layer, loss_rows and loss_reduce.
//
// Every reduction runs in a fixed order (no atomics): two runs agree bit for
// bit.
//
// Host interface (ctypes): k2_args_size(), k2_prepare(K2Args*) (the bf16
// chain's tensor maps and launch plan, once per set of buffers),
// k2_release(K2Args*), k2_step(const K2Args*, int mb, cudaStream_t),
// k2_load() (every kernel loaded, before a graph capture) and
// k2_gemm_check(kind, a, lda, b, ldb, c, M, N, K, stream) (one tensor-core
// product, f32 out, no epilogue), each returning a cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <new>

#define MAXL 8      // layers per MLP
#define MAXA 32     // action dims
#define LOSS_THREADS 64

typedef __nv_bfloat16 bf16;

struct K2Args {
    int rows, act_dim, n_actor, n_critic;
    int actor_dims[MAXL + 1];
    int critic_dims[MAXL + 1];
    int op_bf16, fixed_std, clipped_vl, wgrad_splits;
    int wgrad_rows, loss_blocks;
    float clip_param, init_noise_std, coef_scale, gval_scale, logp_const, lo, hi, pad0;
    long long obs_ld, obs_mb_stride, cobs_ld, cobs_mb_stride, fs_ld, fs_mb_stride;
    long long w_off[2 * MAXL], b_off[2 * MAXL];   // actor layers, then critic layers
    long long std_off;
    const void* obs;
    const void* cobs;
    const float* fscal;
    const float* p;      // flat f32 params
    float* g;            // flat f32 gradient (written)
    float* aux;          // [3] row sums: surr, vl, kl
    // hidden activations (rows, width) in T: actor [0..), critic [MAXL..);
    // on the bf16 chain with row stride act_ld(width)
    void* h[2 * MAXL];
    float* mean;         // (rows, A) f32
    float* value;        // (rows) f32
    void* gbuf[4];       // f32 chain: backward gradients, actor ping/pong, critic ping/pong
    float* part;         // weight-gradient partials
    float* loss_part;    // loss partials (loss_blocks, loss_w)
    // the top gradients (d loss / d mean, d loss / d value) in T, row strides gtop_ld
    void* gtop[2];
    int gtop_ld[2];
    int loss_w, mb_count;
    // bf16 chain: packed operands, scratch and the launch plan
    long long q_off[2 * MAXL];      // packed bf16 weights: offset of each layer's W
    long long part_off[2 * MAXL];   // weight-gradient partials of each layer
    long long bsum_off[2 * MAXL];   // bias-gradient partials of each non-head layer
    int q_ld[2 * MAXL];             // row stride of each packed W (in, padded to 16)
    long long q_total;
    void* q;                        // packed bf16 weights
    void* gin[2 * MAXL];            // gradient at the input of each layer >= 1, (rows, act_ld(width)) bf16
    float* bsum;
    void* plan;                     // set by k2_prepare
};

extern "C" int k2_args_size() { return (int)sizeof(K2Args); }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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

enum { EPI_HIDDEN = 0, EPI_OUT = 1, EPI_DGRAD = 2, EPI_PARTIAL = 3 };

// ---------------------------------------------------------------------------
// f32 chain: SIMT tiled GEMM, C[m][n] = sum_k A(m, k) B(k, n),
// A(m, k) = a[m*a_sm + k*a_sk], B(k, n) = b[k*b_sk + n*b_sn];
// 64x64 tile, 16 deep, 256 threads of 4x4
// ---------------------------------------------------------------------------

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

#undef BM
#undef BN
#undef BK

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

// ---------------------------------------------------------------------------
// the loss and the backward seeds, one thread per row (_tile_body :257-304).
// Per-block partials, loss_w wide: d_std (A), surr, vl, kl, and on the bf16
// chain the heads' bias gradients (A + 1: the column sums of the T-rounded
// top gradients)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(LOSS_THREADS) loss_rows(const K2Args a, const float* fs) {
    extern __shared__ float red[];
    const int A = a.act_dim, W = a.loss_w;
    const int tid = threadIdx.x;
    const int r = blockIdx.x * blockDim.x + tid;
    float vals[2 * MAXA + 4];
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
        T* gmean = (T*)a.gtop[0] + (long long)r * a.gtop_ld[0];
        for (int j = 0; j < A; ++j) {
            const float sd = a.fixed_std ? a.init_noise_std : stdp[j];
            const float var = sd * sd;
            const float diff = f[j] - mean[j];
            const T gj = from_f<T>(coef * (diff / var));
            gmean[j] = gj;
            vals[j] = coef * (diff * diff / var - 1.f) / sd;
            if (W > A + 3) vals[A + 3 + j] = to_f<T>(gj);
        }
        const T gv = from_f<T>(gv_raw * a.gval_scale);
        ((T*)a.gtop[1])[(long long)r * a.gtop_ld[1]] = gv;
        vals[A] = surr;
        vals[A + 1] = vl;
        vals[A + 2] = kl;
        if (W > A + 3) vals[2 * A + 3] = to_f<T>(gv);
    }
    for (int w = 0; w < W; ++w) red[tid * W + w] = vals[w];
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (tid < s)
            for (int w = 0; w < W; ++w) red[tid * W + w] += red[(tid + s) * W + w];
        __syncthreads();
    }
    for (int w = tid; w < W; w += blockDim.x) a.loss_part[(long long)blockIdx.x * W + w] = red[w];
}

// f32 chain: the loss partials summed in block order: d_std (raw) and the row sums
__global__ void loss_reduce(const K2Args a) {
    const int W = a.act_dim + 3, w = threadIdx.x;
    if (w >= W) return;
    float s = 0.f;
    for (int b = 0; b < a.loss_blocks; ++b) s += a.loss_part[(long long)b * a.loss_w + w];
    if (w < a.act_dim) a.g[a.std_off + w] = a.fixed_std ? 0.f : s;
    else a.aux[w - a.act_dim] = s;
}

// ---------------------------------------------------------------------------
// the f32 chain
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

static int run_f32(const K2Args& a, int mb, cudaStream_t st) {
    const float* obs = (const float*)a.obs + (long long)mb * a.obs_mb_stride;
    const float* cobs = (const float*)a.cobs + (long long)mb * a.cobs_mb_stride;
    const float* fs = a.fscal + (long long)mb * a.fs_mb_stride;
    forward<float>(a, a.p, obs, a.obs_ld, a.actor_dims, a.n_actor, 0, 0, a.mean, a.act_dim, st);
    forward<float>(a, a.p, cobs, a.cobs_ld, a.critic_dims, a.n_critic, a.n_actor, MAXL, a.value, 1, st);
    loss_rows<float><<<a.loss_blocks, LOSS_THREADS, LOSS_THREADS * a.loss_w * sizeof(float), st>>>(a, fs);
    loss_reduce<<<1, 64, 0, st>>>(a);
    backward<float>(a, a.p, obs, a.obs_ld, a.actor_dims, a.n_actor, 0, 0, 0, st);
    backward<float>(a, a.p, cobs, a.cobs_ld, a.critic_dims, a.n_critic, a.n_actor, MAXL, 2, st);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 chain: TMA + wgmma GEMM (one warpgroup per 64 x 128 output tile)
// ---------------------------------------------------------------------------

#define WG_BM 64                 // output rows of a tile (wgmma m64)
#define WG_BN 128                // output columns (wgmma n128)
#define WG_BK 64                 // K per stage: one 128-B swizzle row of bf16
#define WG_STAGES 3
#define WG_BOX_BYTES 8192        // one 64 x 64 bf16 TMA box
#define WG_STAGE_BYTES (3 * WG_BOX_BYTES)   // A's box, then B's two
#define WG_SMEM (WG_STAGES * WG_STAGE_BYTES + 1024)   // + slack for 1024-B alignment
#define WG_MAXP 8                // problems per grouped launch
#define WG_CS_LD (WG_BN + 8)     // row stride of the epilogue's bf16 tile (272 B: 16-B rows, fewer conflicts)
#define WG_CF_LD (WG_BN + 4)     // row stride of the epilogue's f32 tile

struct WgProblem {
    CUtensorMap ta, tb;          // 3-D (width, rows, depth) bf16 maps, box 64 x 64 x 1, 128-B swizzle
    int M, N, K, k_chunk;        // C (M, N) = A (M, K) B (K, N); K split in k_chunk pieces
    int m_tiles, n_tiles, splits, block0;
    int epi, az, bz, bsum_ld;    // epilogue; depth coordinate of A's and B's maps
    int a_mb, b_mb, pad0, pad1;  // host: set az / bz to the minibatch at launch
    const float* bias;           // EPI_HIDDEN, EPI_OUT
    const bf16* h; long long h_ld;   // EPI_DGRAD: the activation whose elu' scales the gradient
    void* c; long long c_ld, c_split;
    float* bsum;                 // EPI_DGRAD: (m_tiles, bsum_ld) column sums of the bf16 output
};

struct WgLaunch {
    WgProblem pr[WG_MAXP];
    int np, blocks;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase with this parity to complete; a transfer that never
// lands (a bad tensor map) traps after ~2^34 cycles instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && clock64() - t0 > (1ll << 34)) asm volatile("trap;");
    } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory descriptor, 128-B swizzle: start address, leading and
// stride byte offsets (16-B units), layout type 1 (B128) in bits 62-63
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo_bytes) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 128, f32 in registers) += A (64 x 16) B (16 x 128), bf16 from
// shared memory; TA / TB: the operand is M- / N-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %66, %67;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// A_MN / B_MN: A is read M-major (the weight gradient's G^T), B N-major (the
// input gradient's W and the weight gradient's H); else both K-major.
// One warpgroup; thread 0 keeps up to WG_STAGES TMA stages in flight.
template <int A_MN, int B_MN>
__global__ void __launch_bounds__(128, 1) wg_gemm(const __grid_constant__ WgLaunch L) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[WG_STAGES];
    uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
    const int tid = threadIdx.x;

    int pi = 0;
    while (pi + 1 < L.np && (int)blockIdx.x >= L.pr[pi + 1].block0) ++pi;
    const WgProblem& P = L.pr[pi];
    int local = (int)blockIdx.x - P.block0;
    const int nt = local % P.n_tiles;
    local /= P.n_tiles;
    const int mt = local % P.m_tiles;
    const int z = local / P.m_tiles;
    const int m0 = mt * WG_BM, n0 = nt * WG_BN;
    const int kbeg = z * P.k_chunk;
    const int kend = min(P.K, kbeg + P.k_chunk);
    const int nk = (kend - kbeg + WG_BK - 1) / WG_BK;

    if (tid == 0) {
        for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto issue = [&](int kt) {
        uint8_t* st = smem + (kt % WG_STAGES) * WG_STAGE_BYTES;
        const uint32_t bar = smem_u32(&full[kt % WG_STAGES]);
        const int k = kbeg + kt * WG_BK;
        mbar_expect_tx(bar, WG_STAGE_BYTES);
        if (A_MN) tma_load(st, &P.ta, m0, k, P.az, bar);
        else      tma_load(st, &P.ta, k, m0, P.az, bar);
        if (B_MN) {
            tma_load(st + WG_BOX_BYTES, &P.tb, n0, k, P.bz, bar);
            tma_load(st + 2 * WG_BOX_BYTES, &P.tb, n0 + 64, k, P.bz, bar);
        } else {
            tma_load(st + WG_BOX_BYTES, &P.tb, k, n0, P.bz, bar);
            tma_load(st + 2 * WG_BOX_BYTES, &P.tb, k, n0 + 64, P.bz, bar);
        }
    };

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wg_fence_acc(acc);
    if (tid == 0)
        for (int kt = 0; kt < nk && kt < WG_STAGES; ++kt) issue(kt);

    // k-tile kt's products run while thread 0 refills the stage of k-tile
    // kt - 1, which wgmma.wait_group 1 has released
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(smem_u32(&full[s]), (uint32_t)((kt / WG_STAGES) & 1));
        const uint32_t sa = smem_u32(smem + s * WG_STAGE_BYTES);
        const uint32_t sb = sa + WG_BOX_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
            // K-major: the 16-deep slice is 32 B into each 128-B row; M/N-major:
            // 16 rows of 128 B further, the two 64-wide N boxes WG_BOX_BYTES apart
            const uint64_t da = A_MN ? wg_desc(sa + kk * 2048, WG_BOX_BYTES) : wg_desc(sa + kk * 32, 16);
            const uint64_t db = B_MN ? wg_desc(sb + kk * 2048, WG_BOX_BYTES) : wg_desc(sb + kk * 32, 16);
            wgmma_m64n128k16<A_MN, B_MN>(acc, da, db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        __syncthreads();   // every warp is done with k-tile kt - 1's stage
        if (tid == 0 && kt >= 1 && kt - 1 + WG_STAGES < nk) issue(kt - 1 + WG_STAGES);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(acc);
    __syncthreads();   // the stages are drained: the epilogue stages its tile there

    // epilogue: accumulator i of thread (warp, lane) is tile row 16 warp +
    // lane/4 + 8 ((i % 4) / 2), column 8 (i / 4) + 2 (lane % 4) + i % 2. The
    // tile goes through shared memory so that global memory sees whole rows
    // of 16-B stores (and, for the input gradient, 16-B loads of h)
    const int warp = tid >> 5, lane = tid & 31;
    const int rl = warp * 16 + (lane >> 2);
    const int cl = 2 * (lane & 3);
    if (P.epi == EPI_PARTIAL) {
        float* cf = (float*)smem;   // [WG_BM][WG_CF_LD]
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                *(float2*)(cf + (rl + 8 * hf) * WG_CF_LD + 8 * j + cl) =
                    make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        __syncthreads();
        float* out = (float*)P.c + (long long)z * P.c_split;
        for (int i = tid; i < WG_BM * (WG_BN / 4); i += 128) {
            const int r = i / (WG_BN / 4), c = (i % (WG_BN / 4)) * 4;
            const int gr = m0 + r, gc = n0 + c;
            if (gr >= P.M || gc >= P.N) continue;
            float* dst = out + (long long)gr * P.c_ld + gc;
            const float* src = cf + r * WG_CF_LD + c;
            if (gc + 4 <= P.N && ((uintptr_t)dst & 15) == 0) *(float4*)dst = *(const float4*)src;
            else for (int e = 0; e < 4 && gc + e < P.N; ++e) dst[e] = src[e];
        }
        return;
    }
    if (P.epi == EPI_OUT) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int r = m0 + rl + 8 * hf, c = n0 + 8 * j + cl + e;
                    if (r < P.M && c < P.N)
                        ((float*)P.c)[(long long)r * P.c_ld + c] = acc[4 * j + 2 * hf + e] + P.bias[c];
                }
        return;
    }
    bf16* cs = (bf16*)smem;   // [WG_BM][WG_CS_LD]
    if (P.epi == EPI_HIDDEN) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = n0 + 8 * j + cl;
            const float b0 = c < P.N ? P.bias[c] : 0.f, b1 = c + 1 < P.N ? P.bias[c + 1] : 0.f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const float z0 = acc[4 * j + 2 * hf] + b0, z1 = acc[4 * j + 2 * hf + 1] + b1;
                *(__nv_bfloat162*)(cs + (rl + 8 * hf) * WG_CS_LD + 8 * j + cl) = __halves2bfloat162(
                    __float2bfloat16_rn(z0 > 0.f ? z0 : expf(z0) - 1.f),
                    __float2bfloat16_rn(z1 > 0.f ? z1 : expf(z1) - 1.f));
            }
        }
    } else {   // EPI_DGRAD: h's tile in, g = bf16(acc * elu'(h)) over it in place
        for (int i = tid; i < WG_BM * (WG_BN / 8); i += 128) {
            const int r = i / (WG_BN / 8), c = (i % (WG_BN / 8)) * 8;
            const int gr = m0 + r, gc = n0 + c;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (gr < P.M && gc < P.N) {
                const bf16* src = P.h + (long long)gr * P.h_ld + gc;
                if (gc + 8 <= P.N && ((uintptr_t)src & 15) == 0) {
                    v = *(const uint4*)src;
                } else {
                    bf16* t = (bf16*)&v;
                    for (int e = 0; e < 8 && gc + e < P.N; ++e) t[e] = src[e];
                }
            }
            *(uint4*)(cs + r * WG_CS_LD + c) = v;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                __nv_bfloat162* hp = (__nv_bfloat162*)(cs + (rl + 8 * hf) * WG_CS_LD + 8 * j + cl);
                const float2 h2 = __bfloat1622float2(*hp);
                const float d0 = h2.x > 0.f ? 1.f : h2.x + 1.f, d1 = h2.y > 0.f ? 1.f : h2.y + 1.f;
                *hp = __halves2bfloat162(__float2bfloat16_rn(acc[4 * j + 2 * hf] * d0),
                                         __float2bfloat16_rn(acc[4 * j + 2 * hf + 1] * d1));
            }
        __syncthreads();
        // the bias gradient of the layer below: this tile's column sums of the
        // bf16 gradient, rows in order (rows past M hold zeros)
        const int c = n0 + tid;
        if (c < P.N) {
            float sum = 0.f;
            for (int r = 0; r < WG_BM; ++r) sum += __bfloat162float(cs[r * WG_CS_LD + tid]);
            P.bsum[(long long)mt * P.bsum_ld + c] = sum;
        }
    }
    __syncthreads();
    for (int i = tid; i < WG_BM * (WG_BN / 8); i += 128) {
        const int r = i / (WG_BN / 8), c = (i % (WG_BN / 8)) * 8;
        const int gr = m0 + r, gc = n0 + c;
        if (gr >= P.M || gc >= P.N) continue;
        bf16* dst = (bf16*)P.c + (long long)gr * P.c_ld + gc;
        const bf16* src = cs + r * WG_CS_LD + c;
        if (gc + 8 <= P.N && ((uintptr_t)dst & 15) == 0) *(uint4*)dst = *(const uint4*)src;
        else for (int e = 0; e < 8 && gc + e < P.N; ++e) dst[e] = src[e];
    }
}

// f32 params -> packed bf16 weights: layer slot l's W (out, in) at q_off[l]
// with row stride q_ld[l]; the row padding and the gaps are zero
__global__ void pack_params(const K2Args a) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.q_total) return;
    float v = 0.f;
    const int nl = a.n_actor + a.n_critic;
    for (int l = 0; l < nl; ++l) {
        const int* dims = l < a.n_actor ? a.actor_dims : a.critic_dims;
        const int j = l < a.n_actor ? l : l - a.n_actor;
        const long long rel = i - a.q_off[l];
        if (rel >= 0 && rel < (long long)dims[j + 1] * a.q_ld[l]) {
            const int o = (int)(rel / a.q_ld[l]), c = (int)(rel % a.q_ld[l]);
            if (c < dims[j]) v = a.p[a.w_off[l] + (long long)o * dims[j] + c];
            break;
        }
    }
    ((bf16*)a.q)[i] = __float2bfloat16_rn(v);
}

// the in-order sums of every partial: dst[i] = sum_z src[z * stride + i]
#define RED_MAXSEG (4 * MAXL + 2)

struct RedSeg {
    const float* src;
    float* dst;
    long long stride;
    int n, nz, block0, groups;
};

struct RedLaunch {
    RedSeg seg[RED_MAXSEG];
    int ns, blocks;
};

// a block of RED_THREADS sums RED_THREADS / groups columns of one segment:
// thread group g takes the partials z = g, g + groups, ... in order, then the
// groups are added in order (a fixed order for every z count); long
// segments (the bias tiles) take RED_GROUPS groups, short ones one
#define RED_THREADS 256
#define RED_GROUPS 8

__global__ void __launch_bounds__(RED_THREADS) k2_reduce(const __grid_constant__ RedLaunch R) {
    __shared__ float red[RED_THREADS];
    int si = 0;
    while (si + 1 < R.ns && (int)blockIdx.x >= R.seg[si + 1].block0) ++si;
    const RedSeg& S = R.seg[si];
    const int cols = RED_THREADS / S.groups;
    const int c = threadIdx.x % cols, grp = threadIdx.x / cols;
    const int i = ((int)blockIdx.x - S.block0) * cols + c;
    float s = 0.f;
    if (i < S.n)
        for (int z = grp; z < S.nz; z += S.groups) s += S.src[(long long)z * S.stride + i];
    if (S.groups == 1) {
        if (i < S.n) S.dst[i] = s;
        return;
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (grp == 0 && i < S.n) {
        float t = red[c];
        for (int q = 1; q < S.groups; ++q) t += red[q * cols + c];
        S.dst[i] = t;
    }
}

// ---------------------------------------------------------------------------
// host side of the bf16 chain: tensor maps and the launch plan
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q) !=
                cudaSuccess || q != cudaDriverEntryPointSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) != cudaSuccess ||
            q != cudaDriverEntryPointSuccess)
            return nullptr;
#endif
        fn = (EncodeTiled)f;
    }
    return fn;
}

// row stride of the bf16 chain's activations and input gradients: the width
// rounded up to 8 (16-B rows, as TMA needs; the pad columns are never read)
static inline long long act_ld(int width) { return (width + 7) & ~7; }

// a (depth, rows, ld) bf16 buffer whose first `width` columns hold data;
// the rest of each 64 x 64 box reads as zeros
static bool encode(CUtensorMap* m, const void* base, long long width, long long rows, long long depth,
                   long long ld) {
    EncodeTiled enc = encoder();
    if (!enc || !base || width < 1 || rows < 1 || ld % 8 || ((uintptr_t)base & 15)) return false;
    cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)depth};
    cuuint64_t strides[2] = {(cuuint64_t)(ld * 2), (cuuint64_t)(rows * ld * 2)};
    cuuint32_t box[3] = {64, 64, 1};
    cuuint32_t es[3] = {1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)base, dims, strides, box, es,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int wg_attributes() {
    static int done = 0;
    if (!done) {
        cudaError_t e = cudaFuncSetAttribute(wg_gemm<0, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
        if (!e) e = cudaFuncSetAttribute(wg_gemm<0, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
        if (!e) e = cudaFuncSetAttribute(wg_gemm<1, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
        if (e) return (int)e;
        done = 1;
    }
    return 0;
}

static void finish(WgProblem& P, int& blocks) {
    P.m_tiles = (P.M + WG_BM - 1) / WG_BM;
    P.n_tiles = (P.N + WG_BN - 1) / WG_BN;
    P.splits = (P.K + P.k_chunk - 1) / P.k_chunk;
    P.block0 = blocks;
    blocks += P.m_tiles * P.n_tiles * P.splits;
}

struct Plan {
    WgLaunch fwd[MAXL];            // per layer depth
    WgLaunch dgrad[MAXL];          // per step down from the heads
    WgLaunch wgrad[2];             // every layer's weight gradient
    RedLaunch red;
    int n_fwd, n_dgrad, n_wgrad;
};

// one MLP of the args: k = 0 actor, 1 critic
struct Mlp {
    const K2Args* a;
    int k;
    int nl() const { return k ? a->n_critic : a->n_actor; }
    const int* dims() const { return k ? a->critic_dims : a->actor_dims; }
    int slot(int l) const { return k ? a->n_actor + l : l; }
    // layer l's input activation (the obs buffer, minibatch as depth, for l = 0)
    bool input_map(int l, CUtensorMap* m) const {
        if (l == 0)
            return k ? encode(m, a->cobs, dims()[0], a->rows, a->mb_count, a->cobs_ld)
                     : encode(m, a->obs, dims()[0], a->rows, a->mb_count, a->obs_ld);
        return encode(m, a->h[k * MAXL + l - 1], dims()[l], a->rows, 1, act_ld(dims()[l]));
    }
    // the gradient at layer l's output
    bool outgrad_map(int l, CUtensorMap* m) const {
        if (l == nl() - 1) return encode(m, a->gtop[k], dims()[l + 1], a->rows, 1, a->gtop_ld[k]);
        return encode(m, a->gin[k * MAXL + l + 1], dims()[l + 1], a->rows, 1, act_ld(dims()[l + 1]));
    }
    bool weight_map(int l, CUtensorMap* m) const {
        return encode(m, (const bf16*)a->q + a->q_off[slot(l)], dims()[l], dims()[l + 1], 1, a->q_ld[slot(l)]);
    }
};

static int build_plan(const K2Args& a, Plan* pl) {
    const Mlp mlp[2] = {{&a, 0}, {&a, 1}};
    const int R = a.rows;
    const int depth = a.n_actor > a.n_critic ? a.n_actor : a.n_critic;
    // forward, one launch per layer depth
    pl->n_fwd = depth;
    for (int l = 0; l < depth; ++l) {
        WgLaunch& L = pl->fwd[l];
        L.np = 0;
        L.blocks = 0;
        for (int k = 0; k < 2; ++k) {
            const Mlp& f = mlp[k];
            if (l >= f.nl()) continue;
            WgProblem& P = L.pr[L.np++];
            if (!f.input_map(l, &P.ta) || !f.weight_map(l, &P.tb)) return cudaErrorInvalidValue;
            P.M = R; P.N = f.dims()[l + 1]; P.K = f.dims()[l]; P.k_chunk = P.K;
            P.a_mb = l == 0;
            P.bias = a.p + a.b_off[f.slot(l)];
            if (l < f.nl() - 1) {
                P.epi = EPI_HIDDEN; P.c = a.h[k * MAXL + l]; P.c_ld = act_ld(P.N);
            } else {
                P.epi = EPI_OUT; P.c = k ? a.value : a.mean; P.c_ld = k ? 1 : a.act_dim;
            }
            finish(P, L.blocks);
        }
    }
    // input gradients, one launch per step down from the heads
    pl->n_dgrad = depth - 1;
    for (int t = 0; t < depth - 1; ++t) {
        WgLaunch& L = pl->dgrad[t];
        L.np = 0;
        L.blocks = 0;
        for (int k = 0; k < 2; ++k) {
            const Mlp& f = mlp[k];
            const int l = f.nl() - 1 - t;
            if (l < 1) continue;
            WgProblem& P = L.pr[L.np++];
            if (!f.outgrad_map(l, &P.ta) || !f.weight_map(l, &P.tb)) return cudaErrorInvalidValue;
            P.M = R; P.N = f.dims()[l]; P.K = f.dims()[l + 1]; P.k_chunk = P.K;
            P.epi = EPI_DGRAD;
            P.h = (const bf16*)a.h[k * MAXL + l - 1]; P.h_ld = act_ld(P.N);
            P.c = a.gin[k * MAXL + l]; P.c_ld = act_ld(P.N);
            P.bsum = a.bsum + a.bsum_off[f.slot(l - 1)]; P.bsum_ld = P.N;
            finish(P, L.blocks);
        }
    }
    // weight gradients: every layer, in launches of at most WG_MAXP problems
    pl->n_wgrad = 0;
    for (int k = 0; k < 2; ++k) {
        const Mlp& f = mlp[k];
        for (int l = 0; l < f.nl(); ++l) {
            if (pl->n_wgrad == 0 || pl->wgrad[pl->n_wgrad - 1].np == WG_MAXP) {
                pl->wgrad[pl->n_wgrad].np = 0;
                pl->wgrad[pl->n_wgrad].blocks = 0;
                ++pl->n_wgrad;
            }
            WgLaunch& L = pl->wgrad[pl->n_wgrad - 1];
            WgProblem& P = L.pr[L.np++];
            if (!f.outgrad_map(l, &P.ta) || !f.input_map(l, &P.tb)) return cudaErrorInvalidValue;
            P.M = f.dims()[l + 1]; P.N = f.dims()[l]; P.K = R; P.k_chunk = a.wgrad_rows;
            P.b_mb = l == 0;
            P.epi = EPI_PARTIAL;
            P.c = a.part + a.part_off[f.slot(l)]; P.c_ld = P.N; P.c_split = (long long)P.M * P.N;
            finish(P, L.blocks);
        }
    }
    // the reduction: weight chunks, bias tiles, the heads' bias and the loss sums
    RedLaunch& Rd = pl->red;
    Rd.ns = 0;
    Rd.blocks = 0;
    auto seg = [&](const float* src, float* dst, long long stride, int n, int nz) {
        RedSeg& S = Rd.seg[Rd.ns++];
        S.src = src; S.dst = dst; S.stride = stride; S.n = n; S.nz = nz; S.block0 = Rd.blocks;
        S.groups = nz > 4 * RED_GROUPS ? RED_GROUPS : 1;
        const int cols = RED_THREADS / S.groups;
        Rd.blocks += (n + cols - 1) / cols;
    };
    const int A = a.act_dim, W = a.loss_w;
    const int row_tiles = (R + WG_BM - 1) / WG_BM;
    for (int k = 0; k < 2; ++k) {
        const Mlp& f = mlp[k];
        for (int l = 0; l < f.nl(); ++l) {
            const int s = f.slot(l), in = f.dims()[l], out = f.dims()[l + 1];
            const long long n = (long long)in * out;
            seg(a.part + a.part_off[s], a.g + a.w_off[s], n, (int)n, a.wgrad_splits);
            if (l < f.nl() - 1) seg(a.bsum + a.bsum_off[s], a.g + a.b_off[s], out, out, row_tiles);
            else seg(a.loss_part + (k ? 2 * A + 3 : A + 3), a.g + a.b_off[s], W, k ? 1 : A, a.loss_blocks);
        }
    }
    seg(a.loss_part, a.g + a.std_off, W, A, a.fixed_std ? 0 : a.loss_blocks);   // d_std (raw)
    seg(a.loss_part + A, a.aux, W, 3, a.loss_blocks);                            // surr, vl, kl
    return 0;
}

extern "C" int k2_release(K2Args* a) {
    delete (Plan*)a->plan;
    a->plan = nullptr;
    return 0;
}

extern "C" int k2_prepare(K2Args* a) {
    k2_release(a);
    if (!a->op_bf16) return 0;
    if (a->act_dim > MAXA || a->n_actor > MAXL || a->n_critic > MAXL || a->loss_w > 2 * MAXA + 4)
        return (int)cudaErrorInvalidValue;
    if (int e = wg_attributes()) return e;
    Plan* pl = new (std::nothrow) Plan();
    if (!pl) return (int)cudaErrorMemoryAllocation;
    if (int e = build_plan(*a, pl)) {
        delete pl;
        return e;
    }
    a->plan = pl;
    return 0;
}

#define LAUNCH_CHECK()                                         \
    do {                                                       \
        const cudaError_t e_ = cudaGetLastError();             \
        if (e_ != cudaSuccess) return (int)e_;                 \
    } while (0)

static WgLaunch at_minibatch(const WgLaunch& L, int mb) {
    WgLaunch out = L;
    for (int i = 0; i < out.np; ++i) {
        if (out.pr[i].a_mb) out.pr[i].az = mb;
        if (out.pr[i].b_mb) out.pr[i].bz = mb;
    }
    return out;
}

static int run_tc(const K2Args& a, int mb, cudaStream_t st) {
    const Plan* pl = (const Plan*)a.plan;
    if (!pl) return (int)cudaErrorInvalidValue;
    pack_params<<<(unsigned)((a.q_total + 255) / 256), 256, 0, st>>>(a);
    LAUNCH_CHECK();
    for (int l = 0; l < pl->n_fwd; ++l) {
        const WgLaunch L = at_minibatch(pl->fwd[l], mb);
        wg_gemm<0, 0><<<L.blocks, 128, WG_SMEM, st>>>(L);
        LAUNCH_CHECK();
    }
    const float* fs = a.fscal + (long long)mb * a.fs_mb_stride;
    loss_rows<bf16><<<a.loss_blocks, LOSS_THREADS, LOSS_THREADS * a.loss_w * sizeof(float), st>>>(a, fs);
    LAUNCH_CHECK();
    for (int t = 0; t < pl->n_dgrad; ++t) {
        wg_gemm<0, 1><<<pl->dgrad[t].blocks, 128, WG_SMEM, st>>>(pl->dgrad[t]);
        LAUNCH_CHECK();
    }
    for (int i = 0; i < pl->n_wgrad; ++i) {
        const WgLaunch L = at_minibatch(pl->wgrad[i], mb);
        wg_gemm<1, 1><<<L.blocks, 128, WG_SMEM, st>>>(L);
        LAUNCH_CHECK();
    }
    k2_reduce<<<pl->red.blocks, RED_THREADS, 0, st>>>(pl->red);
    LAUNCH_CHECK();
    return 0;
}

// Loads every kernel of both chains (cudaFuncGetAttributes loads a function
// that the lazy module loader has not loaded yet), so that none is loaded
// for the first time while a stream is captured into a CUDA graph.
extern "C" int k2_load() {
    const void* fns[] = {
        (const void*)gemm_kernel<float, EPI_HIDDEN>, (const void*)gemm_kernel<float, EPI_OUT>,
        (const void*)gemm_kernel<float, EPI_DGRAD>, (const void*)gemm_kernel<float, EPI_PARTIAL>,
        (const void*)wgrad_reduce, (const void*)loss_rows<float>, (const void*)loss_reduce,
        (const void*)pack_params, (const void*)wg_gemm<0, 0>, (const void*)wg_gemm<0, 1>,
        (const void*)wg_gemm<1, 1>, (const void*)loss_rows<bf16>, (const void*)k2_reduce,
    };
    for (const void* f : fns) {
        cudaFuncAttributes attr;
        if (const cudaError_t e = cudaFuncGetAttributes(&attr, f)) return (int)e;
    }
    return 0;
}

extern "C" int k2_step(const K2Args* a, int mb, cudaStream_t st) {
    if (a->act_dim > MAXA || a->act_dim + 3 > 64 || a->n_actor > MAXL || a->n_critic > MAXL ||
        a->loss_w > 2 * MAXA + 4)
        return (int)cudaErrorInvalidValue;
    return a->op_bf16 ? run_tc(*a, mb, st) : run_f32(*a, mb, st);
}

// One tensor-core product with an f32 output and no epilogue, through the
// main path's wg_gemm instantiations:
//   kind 0 (forward):        C (M, N) = A (M, K) B (N, K)^T, both K-major
//   kind 1 (input gradient): C (M, N) = A (M, K) B (K, N),   B N-major
//   kind 2 (weight gradient):C (M, N) = A (K, M)^T B (K, N), both M/N-major
// a and b are bf16 with row strides lda, ldb (multiples of 8); c is (M, N).
extern "C" int k2_gemm_check(int kind, const void* a, long long lda, const void* b, long long ldb, float* c,
                             int M, int N, int K, cudaStream_t st) {
    if (int e = wg_attributes()) return e;
    WgLaunch L = {};
    WgProblem& P = L.pr[0];
    bool ok;
    if (kind == 0) ok = encode(&P.ta, a, K, M, 1, lda) && encode(&P.tb, b, K, N, 1, ldb);
    else if (kind == 1) ok = encode(&P.ta, a, K, M, 1, lda) && encode(&P.tb, b, N, K, 1, ldb);
    else if (kind == 2) ok = encode(&P.ta, a, M, K, 1, lda) && encode(&P.tb, b, N, K, 1, ldb);
    else ok = false;
    if (!ok || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
    P.M = M; P.N = N; P.K = K; P.k_chunk = K;
    P.epi = EPI_PARTIAL;
    P.c = c; P.c_ld = N; P.c_split = 0;
    L.np = 1;
    finish(P, L.blocks);
    if (kind == 0) wg_gemm<0, 0><<<L.blocks, 128, WG_SMEM, st>>>(L);
    else if (kind == 1) wg_gemm<0, 1><<<L.blocks, 128, WG_SMEM, st>>>(L);
    else wg_gemm<1, 1><<<L.blocks, 128, WG_SMEM, st>>>(L);
    return (int)cudaGetLastError();
}
