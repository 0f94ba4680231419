// Block-Jacobi projected Gauss-Seidel contact solve, one warp per env, in
// the space of the dofs (pgs_vspace.cuh).
//
// Replaces the TPU kernel _pgs_kernel_bj (cat_tpu/ops/pgs_pallas.py:419,
// launched by pgs_solve_lanes_bj). Per env: the warm start
// u = E^T (lam0 * active), then `iterations` sweeps over the contact blocks:
// inside a block every active contact projects against the same
// w = W^T u (Jacobi) with under-relaxation omega, blocks run in order
// (Gauss-Seidel), and the block's impulse change moves u by E[block]^T dlam.
// cperm (nc,) maps sweep position -> contact id; blocks (nblocks, 2) =
// (first position, size). A block without an active contact is skipped.
//
// What bounds it on an H100: the work is small. Per env and sweep, each
// active contact costs three rows of W^T u, its projection and three rows of
// E^T dlam (12 nv + ~32 operations); the bytes it must move are E's rows
// and W's columns of the active contacts and the small operands (about
// 3.4 KB an env with 4 active contacts of 36). Both take a few us at
// N = 4096, so what bounds it is the latency of the chain of blocks. The
// design runs that chain in one warp with no block barrier and skips the
// blocks without an active contact, and never forms the 108 x 108 A (47 KB
// of shared memory in the design it replaces), so a warp's slice of shared
// memory is E, W and 3.4 KB of scratch and many envs run on an SM at once.

#include "pgs_vspace.cuh"

namespace {

__global__ void __launch_bounds__(vspace::kMaxThreads)
pgs_bj_kernel(const vspace::Operands op, const int* __restrict__ cperm,
              const int* __restrict__ blocks, int nblocks, float omega) {
  vspace::solve_envs(
      op, [&](int p) { return cperm[p]; },
      [&](vspace::Warp& w) {
        // each block's first slot in the active list and its active count
        for (int k = w.lane; k < nblocks; k += vspace::kWarp) {
          const int i0 = blocks[2 * k], g = blocks[2 * k + 1];
          const uint64_t below = i0 ? (~0ull >> (64 - i0)) : 0ull;
          const uint64_t span = g >= 64 ? ~0ull : ((1ull << g) - 1ull);
          w.blk_s0[k] = __popcll(w.amask & below);
          w.blk_m[k] = __popcll((w.amask >> i0) & span);
        }
        __syncwarp();
        for (int it = 0; it < op.iterations; ++it)
          for (int k = 0; k < nblocks; ++k) {
            const int m = w.blk_m[k];
            if (m) w.group(w.blk_s0[k], m, omega);
          }
      });
}

}  // namespace

extern "C" {

size_t pgs_bj_warp_bytes(int nc, int nv) {
  return vspace::warp_bytes(nc, nv);
}

const char* pgs_bj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pgs_bj_setup(int device, int* num_sms) {
  return vspace::setup_device(pgs_bj_kernel, device, num_sms);
}

int pgs_bj_occupancy(int device, int warps, size_t smem, int* blocks) {
  return vspace::occupancy(pgs_bj_kernel, device, warps, smem, blocks);
}

// Launch `grid` blocks of `warps` warps on `stream` (a cudaStream_t of the
// current device); returns the cudaError_t of the launch.
int pgs_bj_launch(const float* E, const float* W, const float* b,
                  const float* bias, const float* active, const float* mu,
                  const float* lam0, const int* cperm, const int* blocks,
                  float* lam_out, int n_env, int nc, int nv, int nblocks,
                  int iterations, float cfm, float omega, int grid, int warps,
                  int bulk, void* stream) {
  if (!vspace::shape_ok(nc, nv, warps) || nblocks < 1 || nblocks > nc)
    return static_cast<int>(cudaErrorInvalidValue);
  const vspace::Operands op{E, W, b, bias, active, mu, lam0, nullptr, lam_out,
                            n_env, nc, nv, iterations, cfm, bulk};
  return vspace::launch(pgs_bj_kernel, grid, warps, op, stream, cperm, blocks,
                        nblocks, omega);
}

}  // extern "C"
