// K3: the optimizer step of the whole-update PPO kernel, for sm_90a.
//
// Replaces the TPU kernel FusedPPOGrad.update_scan of
// wiki_grx_gym_tpu/learn/fused_update.py (pallas_call :708, body
// _update_kernel :511, its _finalize_step :579-657). Wrapper and plain
// version: wiki_grx_gym_tpu_torch/learn/fused_update.py
// (FusedPPOGrad.update_scan, update_scan_plain).
//
// The TPU kernel keeps params, Adam moments and gradients (~7 MB f32 for
// GR1T1) resident in 16 MB of VMEM across a sequential (steps, tiles) grid.
// On Hopper four such copies fit no SM, so the update is an on-device
// sequence driven by the wrapper: for each of the epochs x minibatches grad
// steps, K2's chain (csrc/ppo_grads.cu) writes the flat f32 gradient and the
// row sums, then k3_step runs the finalisation on the card:
//   k3_norm:  the loss (surrogate + value loss - entropy), ok = isfinite(loss),
//             the std gradient's entropy term, and per-block partial sums of
//             (g * ok)^2 over the ~437k gradient entries;
//   k3_adam:  every block sums the partials in the same fixed order (so all
//             blocks see the same global norm), the adaptive-KL learning rate
//             from this step's KL applied to this step, clip by global norm,
//             Adam with the carried count and K3's bias correction
//             1 - exp(c log b), the std floor, and the metric sums.
// The grads are multiplied by ok, not skipped, as on the TPU: m and v still
// decay and the count still advances. The learning rate and the metric sums
// live in a small device buffer of two 8-float slots: step s reads slot s&1
// and block 0 writes slot (s+1)&1, so no block reads what another writes in
// the same launch. Nothing is read back to the host until the update ends.
// The step moves 7 x 4 B per parameter (p, m, v read and written, g read):
// bound by bytes, ~12.2 MB a step at GR1T1's size.
//
// Host interface (ctypes): k3_args_size() and
// k3_step(const K3Args*, int step, cudaStream_t) -> cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ void chunk_of(const K3Args& a, long long& beg, long long& end) {
    const long long c = (a.n + gridDim.x - 1) / gridDim.x;
    beg = (long long)blockIdx.x * c;
    end = beg + c < a.n ? beg + c : a.n;
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

__global__ void __launch_bounds__(THREADS) k3_norm(const K3Args a) {
    __shared__ float red[THREADS];
    __shared__ float s_ok;
    if (threadIdx.x == 0) {
        // loss finalisation (_finalize_step :580-592); every block computes it
        // from the same inputs, block 0 records it for k3_adam
        const float surr = a.aux[0] / a.rows_f, vl = a.aux[1] / a.rows_f, kl = a.aux[2] / a.rows_f;
        float ent;
        if (a.fixed_std) {
            ent = a.ent_fixed;
        } else {
            ent = 0.f;
            for (int j = 0; j < a.act_dim; ++j) ent += a.ent_const + logf(a.p[a.std_off + j]);
        }
        const float loss = surr + a.value_loss_coef * vl - a.entropy_coef * ent;
        const float ok = isfinite(loss) ? 1.f : 0.f;
        s_ok = ok;
        if (blockIdx.x == 0) {
            a.step[0] = ok;
            a.step[1] = surr;
            a.step[2] = vl;
            a.step[3] = kl;
        }
    }
    __syncthreads();
    const float ok = s_ok;
    long long beg, end;
    chunk_of(a, beg, end);
    float acc = 0.f;
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        float gi = a.g[i];
        if (!a.fixed_std && i >= a.std_off && i < a.std_off + a.act_dim) {
            gi = gi + (-a.entropy_coef) / a.p[i];   // d_std += -ce / std (:588)
            a.g[i] = gi;
        }
        const float x = gi * ok;
        acc += x * x;
    }
    const float s = block_sum(acc, red);
    if (threadIdx.x == 0) a.part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) k3_adam(const K3Args a, int s) {
    __shared__ float red[THREADS];
    __shared__ float sc[4];   // gscale, lr, bc1, bc2
    float acc = 0.f;
    for (int b = threadIdx.x; b < a.nblocks; b += THREADS) acc += a.part[b];
    const float gsq = block_sum(acc, red);   // the same fixed order in every block
    if (threadIdx.x == 0) {
        const float ok = a.step[0], surr = a.step[1], vl = a.step[2], kl = a.step[3];
        const float* in = a.state + (s & 1) * 8;
        float* out = a.state + ((s + 1) & 1) * 8;
        float lr = in[0];
        if (a.adaptive) {   // rsl_rl ppo.py:207-213, applied to this step
            const float lr_dn = jmax(a.lr_min, lr / 1.5f);
            const float lr_up = jmin(a.lr_max, lr * 1.5f);
            lr = kl > a.kl_hi ? lr_dn : ((kl < a.kl_lo && kl > 0.f) ? lr_up : lr);
        }
        const float gnorm = sqrtf(gsq);
        const bool trigger = gnorm < a.max_grad_norm;
        const float gscale = ok * (trigger ? 1.f : a.max_grad_norm / gnorm);
        const float c = (float)(a.count0[0] + s + 1);
        sc[0] = gscale;
        sc[1] = lr;
        sc[2] = 1.f - expf(c * a.log_b1);
        sc[3] = 1.f - expf(c * a.log_b2);
        if (blockIdx.x == 0) {
            out[0] = lr;
            out[1] = in[1] + vl;
            out[2] = in[2] + surr;
            out[3] = in[3] + kl;
        }
    }
    __syncthreads();
    const float gscale = sc[0], lr = sc[1], bc1 = sc[2], bc2 = sc[3];
    long long beg, end;
    chunk_of(a, beg, end);
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        const float gi = a.g[i] * gscale;
        const float mi = a.b1 * a.m[i] + a.omb1 * gi;
        const float vi = a.b2 * a.v[i] + a.omb2 * (gi * gi);
        a.m[i] = mi;
        a.v[i] = vi;
        float pi = a.p[i] - lr * (mi / bc1) / (sqrtf(vi / bc2) + a.eps);
        if (a.std_floor > 0.f && i >= a.std_off && i < a.std_off + a.act_dim)
            pi = jmax(pi, a.std_floor);
        a.p[i] = pi;
    }
}

extern "C" int k3_step(const K3Args* a, int s, cudaStream_t st) {
    k3_norm<<<a->nblocks, THREADS, 0, st>>>(*a);
    k3_adam<<<a->nblocks, THREADS, 0, st>>>(*a, s);
    return (int)cudaGetLastError();
}
