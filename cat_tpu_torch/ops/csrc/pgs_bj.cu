// Block-Jacobi projected Gauss-Seidel contact solve, one thread block per env.
//
// Replaces the TPU kernel _pgs_kernel_bj (cat_tpu/ops/pgs_pallas.py:419,
// launched by pgs_solve_lanes_bj). Per env it computes
//   A = E W                     (E: 3nc x nv contact rows, W = M^-1 E^T)
//   w = A (lam0 * active)       (warm start)
// then `iterations` sweeps over the contact blocks: inside a block every
// contact projects against the same w (Jacobi), blocks run in order
// (Gauss-Seidel); each contact does the relaxed normal clamp, the tangent
// correction for normal coupling and the friction-disc projection, and the
// block's impulse change is added back as w += A[:, block] dlam.
//
// Layout: envs leading, contiguous: E (N, 3nc, nv), W (N, nv, 3nc),
// b/lam0/out (N, 3nc) interleaved (t1, t2, n) per contact, bias/active
// (N, nc), mu (N,). cperm (nc,) maps permuted position -> contact id;
// blocks (nblocks, 2) = (first permuted position, size).
//
// What bounds it on an H100: per env it reads ~17 KB and does ~0.4-0.6
// MFLOP (the dense assembly is 2 * 3nc * 3nc * nv), so at N = 4096 both the
// bytes (~21 us at 3.35 TB/s) and the f32 operations (~23-36 us at
// 67 TFLOP/s) are small; what really bounds this simple design is the
// latency of the sweep: 2 * iterations * nblocks barriers with only g
// threads busy in each projection step. The design keeps all of A (47 KB
// at nc = 36), E, W and the running w and lam in shared memory, so device
// memory is touched once per operand, and lets several envs share an SM
// (64.8 KB of shared memory a block at nc = 36: three blocks an SM) to
// hide the barrier latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__host__ __device__ inline size_t smem_floats(int nc, int nv) {
  const int n3 = 3 * nc;
  return (size_t)n3 * (n3 + 1)   // A, padded row stride
         + 2 * (size_t)n3 * nv   // E, W
         + 3 * (size_t)n3        // w, lam, b
         + 2 * (size_t)nc        // bias, active
         + 3 * (size_t)nc        // block deltas
         + (size_t)nc;           // block contact ids (int)
}

__global__ void __launch_bounds__(kThreads)
pgs_bj_kernel(const float* __restrict__ E, const float* __restrict__ W,
              const float* __restrict__ b, const float* __restrict__ bias,
              const float* __restrict__ active, const float* __restrict__ mu,
              const float* __restrict__ lam0, const int* __restrict__ cperm,
              const int* __restrict__ blocks, float* __restrict__ lam_out,
              int nc, int nv, int nblocks, int iterations, float cfm,
              float omega) {
  extern __shared__ float smem[];
  const int n3 = 3 * nc;
  const int lda = n3 + 1;
  float* A = smem;
  float* Es = A + (size_t)n3 * lda;
  float* Ws = Es + n3 * nv;
  float* w = Ws + nv * n3;
  float* lam = w + n3;
  float* bs = lam + n3;
  float* bias_s = bs + n3;
  float* act_s = bias_s + nc;
  float* dl = act_s + nc;            // dl[t * nc + j], t = (t1, t2, n)
  int* cols = reinterpret_cast<int*>(dl + 3 * nc);

  const int env = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Eg = E + (size_t)env * n3 * nv;
  const float* Wg = W + (size_t)env * nv * n3;
  for (int i = tid; i < n3 * nv; i += kThreads) {
    Es[i] = Eg[i];
    Ws[i] = Wg[i];
  }
  for (int c = tid; c < nc; c += kThreads) {
    bias_s[c] = bias[(size_t)env * nc + c];
    act_s[c] = active[(size_t)env * nc + c];
  }
  __syncthreads();
  for (int r = tid; r < n3; r += kThreads) {
    bs[r] = b[(size_t)env * n3 + r];
    lam[r] = lam0[(size_t)env * n3 + r] * act_s[r / 3];
  }

  // A[r][c] = sum_k E[r][k] W[k][c]; a warp walks one row, so E is a
  // broadcast read and W a conflict-free one
  for (int idx = tid; idx < n3 * n3; idx += kThreads) {
    const int r = idx / n3;
    const int c = idx - r * n3;
    float acc = 0.f;
    for (int k = 0; k < nv; ++k) acc += Es[r * nv + k] * Ws[k * n3 + c];
    A[r * lda + c] = acc;
  }
  __syncthreads();

  // warm start w[i] = sum_r A[r][i] lam[r], four partial sums by r mod 4
  for (int i = tid; i < n3; i += kThreads) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int r = 0;
    for (; r + 3 < n3; r += 4) {
      a0 += A[r * lda + i] * lam[r];
      a1 += A[(r + 1) * lda + i] * lam[r + 1];
      a2 += A[(r + 2) * lda + i] * lam[r + 2];
      a3 += A[(r + 3) * lda + i] * lam[r + 3];
    }
    if (r < n3) a0 += A[r * lda + i] * lam[r];
    if (r + 1 < n3) a1 += A[(r + 1) * lda + i] * lam[r + 1];
    if (r + 2 < n3) a2 += A[(r + 2) * lda + i] * lam[r + 2];
    w[i] = (a0 + a1) + (a2 + a3);
  }
  __syncthreads();

  const float mu_e = mu[env];
  for (int it = 0; it < iterations; ++it) {
    for (int blk = 0; blk < nblocks; ++blk) {
      const int i0 = blocks[2 * blk];
      const int g = blocks[2 * blk + 1];
      for (int j = tid; j < g; j += kThreads) {
        const int c = cperm[i0 + j];
        const int k = 3 * c;
        const float act = act_s[c];
        const float inv_dt1 = 1.f / (A[k * lda + k] + cfm);
        const float inv_dt2 = 1.f / (A[(k + 1) * lda + k + 1] + cfm);
        const float inv_dn = 1.f / (A[(k + 2) * lda + k + 2] + cfm);
        const float lt1_b = lam[k], lt2_b = lam[k + 1], ln_b = lam[k + 2];
        const float vn = w[k + 2] + bs[k + 2] + bias_s[c];
        const float ln_new = fmaxf(ln_b - omega * vn * inv_dn, 0.f) * act;
        const float dn = ln_new - ln_b;
        const float vt1 = w[k] + bs[k] + A[k * lda + k + 2] * dn;
        const float vt2 = w[k + 1] + bs[k + 1] + A[(k + 1) * lda + k + 2] * dn;
        const float lt1_c = lt1_b - omega * vt1 * inv_dt1;
        const float lt2_c = lt2_b - omega * vt2 * inv_dt2;
        const float tn = sqrtf(lt1_c * lt1_c + lt2_c * lt2_c + 1e-12f);
        const float scale = fminf(1.f, mu_e * ln_new / tn) * act;
        const float n1 = lt1_c * scale, n2 = lt2_c * scale;
        dl[j] = n1 - lt1_b;
        dl[nc + j] = n2 - lt2_b;
        dl[2 * nc + j] = dn;
        cols[j] = k;
        lam[k] = n1;
        lam[k + 1] = n2;
        lam[k + 2] = ln_new;
      }
      __syncthreads();
      // w += A[:, block cols] dlam; A is symmetric, so row k of A serves as
      // column k and the reads stay contiguous across the threads
      for (int i = tid; i < n3; i += kThreads) {
        float p0 = 0.f, p1 = 0.f, p2 = 0.f;
        for (int j = 0; j < g; ++j) {
          const int k = cols[j];
          p0 += A[k * lda + i] * dl[j];
          p1 += A[(k + 1) * lda + i] * dl[nc + j];
          p2 += A[(k + 2) * lda + i] * dl[2 * nc + j];
        }
        w[i] = ((w[i] + p0) + p1) + p2;
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < n3; r += kThreads) lam_out[(size_t)env * n3 + r] = lam[r];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t pgs_bj_smem_bytes(int nc, int nv) { return smem_floats(nc, nv) * 4; }

const char* pgs_bj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` (a cudaStream_t) of `device`; returns the cudaError_t
// of the launch. Does not synchronise and allocates nothing.
int pgs_bj_launch(const float* E, const float* W, const float* b,
                  const float* bias, const float* active, const float* mu,
                  const float* lam0, const int* cperm, const int* blocks,
                  float* lam_out, int n_env, int nc, int nv, int nblocks,
                  int iterations, float cfm, float omega, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = pgs_bj_smem_bytes(nc, nv);
  err = cudaFuncSetAttribute(pgs_bj_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_env == 0) return 0;
  pgs_bj_kernel<<<n_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      E, W, b, bias, active, mu, lam0, cperm, blocks, lam_out, nc, nv,
      nblocks, iterations, cfm, omega);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
