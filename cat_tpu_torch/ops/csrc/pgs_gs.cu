// Projected Gauss-Seidel contact solve with the serial sweep, one warp per
// env, in the space of the dofs (pgs_vspace.cuh).
//
// Replaces the TPU kernel _pgs_kernel (cat_tpu/ops/pgs_pallas.py:103,
// launched by pgs_solve_lanes and pgs_solve_batched). Per env: the warm
// start u = E^T (lam0 * active), then `iterations` sweeps over the active
// contacts one at a time (omega = 1): each reads its three rows of
// w = W^T u, projects (normal clamp, tangent correction for normal
// coupling, friction disc) and moves u by E[3c:3c+3]^T dlam before the next
// contact reads it. masks (3nc,), when given, holds the nonzero dofs of
// each row of E as bits (contact_row_dofs); the kernel leaves the others
// out of its sums, as the TPU kernel's assembly does.
//
// What bounds it on an H100: the work is small. Per env and sweep, each
// active contact costs three rows of W^T u, its projection and three rows of
// E^T dlam (12 nv + ~32 operations); the bytes it must move are E's rows
// and W's columns of the active contacts and the small operands (about
// 3.4 KB an env with 4 active contacts of 36). Both take a few us at
// N = 4096, so what bounds it is the latency of the serial chain,
// iterations x active contacts updates, each waiting on the one before.
// The design runs the chain in one warp: a contact's three row products
// use 8 lanes each, joined by three butterfly shuffles; the projection runs
// in one lane; each lane owns one dof of u. It never forms the 108 x 108 A
// whose assembly took 70% of the design it replaces, and needs no block
// barrier, so many envs' chains run on an SM at once.

#include "pgs_vspace.cuh"

namespace {

__global__ void __launch_bounds__(vspace::kMaxThreads)
pgs_gs_kernel(const vspace::Operands op) {
  vspace::solve_envs(
      op, [](int p) { return p; },
      [&](vspace::Warp& w) {
        for (int it = 0; it < op.iterations; ++it)
          for (int j = 0; j < w.n_act; ++j) w.group(j, 1, 1.f);
      });
}

}  // namespace

extern "C" {

size_t pgs_gs_warp_bytes(int nc, int nv) {
  return vspace::warp_bytes(nc, nv);
}

const char* pgs_gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pgs_gs_setup(int device, int* num_sms) {
  return vspace::setup_device(pgs_gs_kernel, device, num_sms);
}

int pgs_gs_occupancy(int device, int warps, size_t smem, int* blocks) {
  return vspace::occupancy(pgs_gs_kernel, device, warps, smem, blocks);
}

// Launch `grid` blocks of `warps` warps on `stream` (a cudaStream_t of the
// current device); returns the cudaError_t of the launch. masks may be null:
// every dof of every row.
int pgs_gs_launch(const float* E, const float* W, const float* b,
                  const float* bias, const float* active, const float* mu,
                  const float* lam0, const unsigned* masks, float* lam_out,
                  int n_env, int nc, int nv, int iterations, float cfm,
                  int grid, int warps, int bulk, void* stream) {
  if (!vspace::shape_ok(nc, nv, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const vspace::Operands op{E, W, b, bias, active, mu, lam0, masks, lam_out,
                            n_env, nc, nv, iterations, cfm, bulk};
  return vspace::launch(pgs_gs_kernel, grid, warps, op, stream);
}

}  // extern "C"
