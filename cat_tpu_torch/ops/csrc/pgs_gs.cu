// Projected Gauss-Seidel contact solve with the serial sweep, one thread
// block per env.
//
// Replaces the TPU kernel _pgs_kernel (cat_tpu/ops/pgs_pallas.py:103,
// launched by pgs_solve_lanes). Per env it computes
//   A = E W                     (E: 3nc x nv contact rows, W = M^-1 E^T)
//   w = A (lam0 * active)       (warm start)
// then `iterations` sweeps over the contacts one at a time (omega = 1):
// the normal clamp, the tangent correction for normal coupling, the
// friction-disc projection, and w += A[:, 3c:3c+3] dlam before the next
// contact reads w.
//
// Layout: envs leading, contiguous: E (N, 3nc, nv), W (N, nv, 3nc),
// b/lam0/out (N, 3nc) interleaved (t1, t2, n) per contact, bias/active
// (N, nc), mu (N,). dofs (3nc, nv) and counts (3nc,) list the dofs with a
// nonzero E entry in each row; the assembly sums over those only (a
// Solo12 contact row touches the base and one or two legs: 9-12 of 18).
//
// What bounds it on an H100: per env it reads ~17 KB and does ~0.2-0.4
// MFLOP, so at N = 4096 the bytes (~21 us at 3.35 TB/s) and the f32
// operations (a few us at 67 TFLOP/s) are both small. What bounds this
// design is the latency of the serial chain: iterations x nc contact
// updates, each waiting on the one before. The design runs the chain in
// one warp with no block barrier: lane l owns rows l, l + 32, ... of w and
// lam in registers, reads a contact's three rows from their owners with
// __shfl_sync, computes the projection redundantly in every lane and
// updates its own rows of w from A in shared memory. An inactive contact
// (active = 0) keeps lam = 0 and moves w by exact zeros, so the warp skips
// it (warp-uniform). The other three warps help with the assembly and the
// warm start; A (47 KB at nc = 36), E and W sit in shared memory, three
// blocks an SM, so three chains run on each SM at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxContacts = 64;
constexpr int kRowsPerLane = (3 * kMaxContacts + kWarp - 1) / kWarp;  // 6
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline size_t smem_words(int nc, int nv) {
  const int n3 = 3 * nc;
  return (size_t)n3 * (n3 + 1)   // A, padded row stride
         + 2 * (size_t)n3 * nv   // E, W
         + 4 * (size_t)n3        // w, lam, b, 1 / (diag + cfm)
         + 2 * (size_t)nc        // bias, active
         + (size_t)n3 * nv       // nonzero dofs of each row (int)
         + (size_t)n3;           // their counts (int)
}

// Row `row` of a vector spread over the warp (lane row % 32, slot row / 32):
// the owner's register, broadcast to every lane. `row` is warp-uniform.
__device__ inline float warp_get(const float (&v)[kRowsPerLane], int row) {
  const int slot = row / kWarp;
  float x = v[0];
#pragma unroll
  for (int j = 1; j < kRowsPerLane; ++j)
    if (slot == j) x = v[j];
  return __shfl_sync(kFullMask, x, row % kWarp);
}

__device__ inline void warp_set(float (&v)[kRowsPerLane], int row, float x,
                                int lane) {
  const int slot = row / kWarp;
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j)
    if (slot == j && lane == row % kWarp) v[j] = x;
}

__global__ void __launch_bounds__(kThreads)
pgs_gs_kernel(const float* __restrict__ E, const float* __restrict__ W,
              const float* __restrict__ b, const float* __restrict__ bias,
              const float* __restrict__ active, const float* __restrict__ mu,
              const float* __restrict__ lam0, const int* __restrict__ dofs,
              const int* __restrict__ counts, float* __restrict__ lam_out,
              int nc, int nv, int iterations, float cfm) {
  extern __shared__ float smem[];
  const int n3 = 3 * nc;
  const int lda = n3 + 1;
  float* A = smem;
  float* Es = A + (size_t)n3 * lda;
  float* Ws = Es + n3 * nv;
  float* w = Ws + nv * n3;
  float* lam = w + n3;
  float* bs = lam + n3;
  float* inv_d = bs + n3;
  float* bias_s = inv_d + n3;
  float* act_s = bias_s + nc;
  int* dof_s = reinterpret_cast<int*>(act_s + nc);
  int* cnt_s = dof_s + n3 * nv;

  const int env = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Eg = E + (size_t)env * n3 * nv;
  const float* Wg = W + (size_t)env * nv * n3;
  for (int i = tid; i < n3 * nv; i += kThreads) {
    Es[i] = Eg[i];
    Ws[i] = Wg[i];
    dof_s[i] = dofs[i];
  }
  for (int c = tid; c < nc; c += kThreads) {
    bias_s[c] = bias[(size_t)env * nc + c];
    act_s[c] = active[(size_t)env * nc + c];
  }
  for (int r = tid; r < n3; r += kThreads) cnt_s[r] = counts[r];
  __syncthreads();
  for (int r = tid; r < n3; r += kThreads) {
    bs[r] = b[(size_t)env * n3 + r];
    lam[r] = lam0[(size_t)env * n3 + r] * act_s[r / 3];
  }

  // A[r][c] = sum over the nonzero dofs k of row r of E[r][k] W[k][c]; a
  // warp walks one row, so E is a broadcast read and W a conflict-free one
  for (int idx = tid; idx < n3 * n3; idx += kThreads) {
    const int r = idx / n3;
    const int c = idx - r * n3;
    const int* ks = dof_s + r * nv;
    float acc = 0.f;
    for (int q = 0; q < cnt_s[r]; ++q) {
      const int k = ks[q];
      acc += Es[r * nv + k] * Ws[k * n3 + c];
    }
    A[r * lda + c] = acc;
  }
  __syncthreads();

  // warm start w[i] = sum_r A[r][i] lam[r], summed in row order as the
  // reference does
  for (int i = tid; i < n3; i += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < n3; ++r) acc += A[r * lda + i] * lam[r];
    w[i] = acc;
    inv_d[i] = 1.f / (A[i * lda + i] + cfm);
  }
  __syncthreads();
  if (tid >= kWarp) return;  // the sweep is one warp's; no barrier follows

  const int lane = tid;
  float wr[kRowsPerLane], lr[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int i = lane + kWarp * j;
    wr[j] = i < n3 ? w[i] : 0.f;
    lr[j] = i < n3 ? lam[i] : 0.f;
  }
  const float mu_e = mu[env];
  for (int it = 0; it < iterations; ++it) {
    for (int c = 0; c < nc; ++c) {
      const float act = act_s[c];
      if (act == 0.f) continue;
      const int k = 3 * c;
      const float v0 = warp_get(wr, k) + bs[k];
      const float v1 = warp_get(wr, k + 1) + bs[k + 1];
      const float v2 = warp_get(wr, k + 2) + bs[k + 2];
      const float l0 = warp_get(lr, k);
      const float l1 = warp_get(lr, k + 1);
      const float l2 = warp_get(lr, k + 2);
      const float ln_new = fmaxf(l2 - (v2 + bias_s[c]) * inv_d[k + 2], 0.f) * act;
      const float dn = ln_new - l2;
      const float vt1 = v0 + A[k * lda + k + 2] * dn;
      const float vt2 = v1 + A[(k + 1) * lda + k + 2] * dn;
      const float lt1 = l0 - vt1 * inv_d[k];
      const float lt2 = l1 - vt2 * inv_d[k + 1];
      const float tn = sqrtf(lt1 * lt1 + lt2 * lt2 + 1e-12f);
      const float scale = fminf(1.f, mu_e * ln_new / tn) * act;
      const float n0 = lt1 * scale, n1 = lt2 * scale;
      const float d0 = n0 - l0, d1 = n1 - l1;
      // w += A[:, k:k+3] dlam on this lane's rows; A is symmetric, so rows
      // k..k+2 serve as columns and the reads are contiguous across lanes
      const float* a0 = A + k * lda;
      const float* a1 = a0 + lda;
      const float* a2 = a1 + lda;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int i = lane + kWarp * j;
        if (i < n3) wr[j] = ((wr[j] + a0[i] * d0) + a1[i] * d1) + a2[i] * dn;
      }
      warp_set(lr, k, n0, lane);
      warp_set(lr, k + 1, n1, lane);
      warp_set(lr, k + 2, ln_new, lane);
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int i = lane + kWarp * j;
    if (i < n3) lam_out[(size_t)env * n3 + i] = lr[j];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t pgs_gs_smem_bytes(int nc, int nv) { return smem_words(nc, nv) * 4; }

const char* pgs_gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` (a cudaStream_t) of `device`; returns the cudaError_t
// of the launch. Does not synchronise and allocates nothing.
int pgs_gs_launch(const float* E, const float* W, const float* b,
                  const float* bias, const float* active, const float* mu,
                  const float* lam0, const int* dofs, const int* counts,
                  float* lam_out, int n_env, int nc, int nv, int iterations,
                  float cfm, int device, void* stream) {
  if (nc < 1 || nc > kMaxContacts) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = pgs_gs_smem_bytes(nc, nv);
  err = cudaFuncSetAttribute(pgs_gs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_env == 0) return 0;
  pgs_gs_kernel<<<n_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      E, W, b, bias, active, mu, lam0, dofs, counts, lam_out, nc, nv,
      iterations, cfm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
