// The env step's observation: the 45-wide proprioceptive part (the base's
// angular velocity, the command, the projected gravity, the joints'
// positions and velocities in task order, the action) and, on a
// heightfield with the scan, the 187-point height scan: the grid turned by
// the base's yaw around the base, the corner lookup and bilinear blend
// (env_model.cuh cell_of, blend), the offset and the clip. Each noisy
// part's noise comes as its raw U(0, 1) draw u (a null draw: no noise) and
// the part's lo and span = hi - lo: the kernel adds lo + span * u, one
// rounding an operation, as the plain version adds it; then each part is
// scaled by the env's scale. It writes the (N, 45 or 232) observation in
// the plain version's column order, with int32 cell indices.
//
// Replaces no Pallas kernel: with env_terms.cu and env_update.cu it is the
// counterpart of what XLA fuses of the JAX package's CatEnv.step (its
// _observations, cat_tpu/envs/env.py:719-759, the height scan :746). Its
// plain version is envs/env.py CatEnv.obs_stage; the reset observation
// (CatEnv.observe) runs it too.
//
// Bound: the bytes (measure.env_counts: each input row and the output
// once, the terrain cells the scan reads once; 2.08 MB flat, ~8.5 MB rough
// at 4096 envs). The design (ops/env_step.py env_geometry sizes it): a
// block owns `envs` consecutive envs, so that 4096 envs run in one wave,
// and
//   staging: the block's rows of qpos, qvel, the command, the action and
//     the four proprioceptive draws, the scan grid and t2m, all copied into
//     shared memory at once (env_model.cuh stage_all: cp.async, a warp a
//     slab);
//   per env, beside the proprioceptive part: a thread an env (the first
//     warps) computes what its env's entries read, once: the projected
//     gravity (its three entries, which that thread writes) and, with the
//     scan, the yaw's cos and sin, the base's x, y and height above the
//     offset, the same functions in the same order as the plain version
//     (so every entry keeps its bits); meanwhile the other warps build the
//     rest of the proprioceptive part part by part, each part's (env,
//     entry) pairs a fixed expression: no branch an entry;
//   scan: a warp an (env, 32 points) item, a lane a point (an env's
//     values read once a warp; the lanes' draws, grid points and results
//     consecutive words), 3 items a warp at a time, so that 3 loads of the
//     corner table (in L2) and 3 of the scan's draws (the block's
//     contiguous rows, read straight in whole lines) are in flight
//     together; no branch in the loop, a specialization for each of the
//     heightfield and the draw present or not;
//   write-back: the block's rows of the observation are one contiguous
//     slab, built in shared memory and written in 16-byte stores.
//
// Layout: envs leading and contiguous; qpos (N, nq), qvel (N, nv), command
// (N, 3), action (N, nj) in task order, t2m (nj), the scan grid (points,
// 2), the draws (N, 3), (N, 3), (N, nj), (N, nj), (N, points); out
// (N, n_obs). On the plane (a null corner table) every height is 0.

#include "env_model.cuh"

namespace {

using namespace envk;

// the phases of the phase-clock build (ops/env_step.py EnvObsKernel.phases)
enum Phase { kStaging, kPerEnv, kScan, kWriteBack };

// the noisy parts, in the columns' order: the angular velocity, the
// projected gravity, the joints' positions and velocities, the scan
constexpr int kParts = 5;
constexpr int kScanPart = 4;
// what an env's scan points read, once an env, 16-byte aligned: cos and sin
// of the yaw, the base's x and y, then its height less the scan's offset
constexpr int kEnvVals = 8;
constexpr int kBaseZ = 4;
constexpr int kLookups = 3;   // scan items a warp has in flight

struct ObsArgs {
  const float *qpos, *qvel, *command, *action;
  const int* t2m;
  const float* grid;
  const float4* hfield;
  // each noisy part's raw U(0, 1) draw (N, width), or null: no noise
  const float* draw[kParts];
  float* obs;
  int n, envs, threads, smem_bytes, nq, nv, nj, n_obs, n_scan;
  Hfield hf;
  // the parts' scales (CatEnv's): the angular velocity, the command's
  // three, the projected gravity, the joints' velocities
  float ang_vel_scale, cmd_scale[3], gravity_scale, joint_vel_scale;
  float offset_z, clip;
  // each part's noise lo + span * u: lo and span = hi - lo in float32
  float lo[kParts], span[kParts];
  Slabs<12> in;   // what a block stages (the launch function lists it)
};

// the block's shared memory, region by region (word offsets; ops/env_step.py
// obs_smem counts the same)
struct ObsLayout {
  int grid, t2m, qpos, qvel, cmd, act, draw[kScanPart], env, out, words;
  __host__ __device__ explicit ObsLayout(const ObsArgs& a) {
    Layout l;
    const int E = a.envs;
    grid = l.take(2 * a.n_scan);
    t2m = l.take(a.nj);
    qpos = l.take(E * a.nq);
    qvel = l.take(E * a.nv);
    cmd = l.take(E * 3);
    act = l.take(E * a.nj);
    draw[0] = l.take(E * 3);
    draw[1] = l.take(E * 3);
    draw[2] = l.take(E * a.nj);
    draw[3] = l.take(E * a.nj);
    env = l.take(E * kEnvVals);
    out = l.take(E * a.n_obs);
    words = l.words;
  }
};

// The scan of the block's ne envs (from env r0 on) into its observation
// slab `out`: a warp an (env, 32 points) item, a lane a point; kLookups
// items a warp at a time, their loads issued together. Item i is env
// i % ne's points 32 (i / ne) on, so that with a warp an env each warp
// keeps to its env. A lane past the last point or item computes a point
// it does not store (no branch in the loop). kCells: a heightfield (else
// every height is 0); kNoise: the scan's draw.
template <bool kCells, bool kNoise>
__device__ __forceinline__ void scan(const ObsArgs& a, const ObsLayout& L,
                                     const float* S, float* out, size_t r0,
                                     int ne) {
  const int ns = a.n_scan, n_obs = a.n_obs, first = 9 + 3 * a.nj;
  const float* row0 = kNoise ? a.draw[kScanPart] + r0 * ns : nullptr;
  const float lo = a.lo[kScanPart], span = a.span[kScanPart];
  const float clip = a.clip;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, items = ne * ((ns + 31) >> 5);
  // the warp's next item (env e, points 32 c on) and its step, nw items
  const float rne = 1.f / static_cast<float>(ne);
  const int dc = small_div(nw, ne, rne), de = nw - dc * ne;
  int c = small_div(warp, ne, rne), e = warp - c * ne;
  for (int i0 = warp; i0 < items; i0 += kLookups * nw) {
    bool ok[kLookups];
    int es[kLookups], ps[kLookups];
    Cell cs[kLookups];
    float4 cv[kLookups];
    float us[kLookups];
#pragma unroll
    for (int b = 0; b < kLookups; ++b) {
      const int p = 32 * c + lane;
      ok[b] = i0 + b * nw < items && p < ns;
      es[b] = e;
      ps[b] = min(p, ns - 1);
      const float4 v =
          *reinterpret_cast<const float4*>(S + L.env + e * kEnvVals);
      const float2 gp = reinterpret_cast<const float2*>(S + L.grid)[ps[b]];
      const float px = (v.z + v.x * gp.x) - v.y * gp.y;
      const float py = (v.w + v.y * gp.x) + v.x * gp.y;
      if (kCells) cs[b] = cell_of(a.hf, px, py);
      e += de;
      c += dc;
      if (e >= ne) {
        e -= ne;
        ++c;
      }
    }
#pragma unroll
    for (int b = 0; b < kLookups; ++b) {
      if (kCells) cv[b] = __ldg(a.hf.cells + cs[b].index);
      if (kNoise)
        us[b] = __ldg(row0 + static_cast<unsigned>(es[b] * ns + ps[b]));
    }
#pragma unroll
    for (int b = 0; b < kLookups; ++b) {
      const float h = kCells ? blend(cv[b], cs[b].fu, cs[b].fv) : 0.f;
      float x = clampf(S[L.env + es[b] * kEnvVals + kBaseZ] - h, -clip, clip);
      if (kNoise) x = x + (lo + span * us[b]);
      if (ok[b]) out[es[b] * n_obs + first + ps[b]] = x;
    }
  }
}

__global__ void __launch_bounds__(kObsThreads)
    env_obs_kernel(const ObsArgs a) {
  extern __shared__ __align__(16) float obs_smem[];
  const ObsLayout L(a);
  float* S = obs_smem;
  const int* Si = reinterpret_cast<const int*>(obs_smem);
  PhaseClock clk;
  const int tid = threadIdx.x, nt = blockDim.x, E = a.envs;
  const int nq = a.nq, nv = a.nv, nj = a.nj;
  const int n_obs = a.n_obs, ns = a.n_scan, np = 9 + 3 * nj;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, a.n - e0);
  const size_t r0 = static_cast<size_t>(e0);

  // staging: the block's rows and the tables, all in flight at once
  stage_all(S, a.in, r0, ne);
  copy_wait();
  __syncthreads();
  clk.lap(kStaging);

  // x plus part k's noise of entry j of env e (its staged draw row of
  // `width`), as the plain version adds it
  auto noisy = [&](int k, float x, int e, int width, int j) {
    return a.draw[k] == nullptr
               ? x
               : x + (a.lo[k] + a.span[k] * S[L.draw[k] + e * width + j]);
  };
  float* out = S + L.out;
  // the warps after the per-env threads build the proprioceptive part
  // (all threads, where the block has no such warp)
  const int split = min(E + 31, nt - 32) & ~31;
  if (tid < ne) {
    // per env: the gravity and its entries; the scan's values
    const float* qp = S + L.qpos + tid * nq;
    const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
    const V3 g = quat_rotate_inv(q, {0.f, 0.f, -1.f});
    const float gk[3] = {g.x, g.y, g.z};
    for (int k = 0; k < 3; ++k)
      out[tid * n_obs + 6 + k] =
          noisy(1, gk[k], tid, 3, k) * a.gravity_scale;
    if (ns > 0) {
      const float yaw = quat_yaw(q);
      float* v = S + L.env + tid * kEnvVals;
      v[0] = cosf(yaw);
      v[1] = sinf(yaw);
      v[2] = qp[0];
      v[3] = qp[1];
      v[kBaseZ] = qp[2] - a.offset_z;
    }
  }
  if (tid >= split || split == 0) {
    const int t = tid - split, n_t = nt - split;
    // the angular velocity and the command
    for_tile(ne, 3, t, n_t, [&](int e, int k) {
      float* o = out + e * n_obs;
      o[k] = noisy(0, S[L.qvel + e * nv + 3 + k], e, 3, k) * a.ang_vel_scale;
      o[3 + k] = S[L.cmd + e * 3 + k] * a.cmd_scale[k];
    });
    // the joint parts, in task order: positions, velocities, the action
    for_tile(ne, nj, t, n_t, [&](int e, int j) {
      const int m = Si[L.t2m + j];
      float* o = out + e * n_obs + 9;
      o[j] = noisy(2, S[L.qpos + e * nq + 7 + m], e, nj, j);
      o[nj + j] = noisy(3, S[L.qvel + e * nv + 6 + m], e, nj, j) *
                  a.joint_vel_scale;
      o[2 * nj + j] = S[L.act + e * nj + j];
    });
  }
  __syncthreads();
  clk.lap(kPerEnv);

  if (ns > 0) {
    const bool cells = a.hf.cells != nullptr;
    const bool noise = a.draw[kScanPart] != nullptr;
    if (cells && noise)
      scan<true, true>(a, L, S, out, r0, ne);
    else if (cells)
      scan<true, false>(a, L, S, out, r0, ne);
    else if (noise)
      scan<false, true>(a, L, S, out, r0, ne);
    else
      scan<false, false>(a, L, S, out, r0, ne);
    __syncthreads();
  }
  clk.lap(kScan);

  unstage_block(a.obs + r0 * n_obs, out, ne * n_obs);
  clk.lap(kWriteBack);
}

// the dynamic shared memory `bytes` above 48 KB allowed, once a device
int allow_smem(int bytes) {
  static int allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return 0;
  err = cudaFuncSetAttribute(env_obs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* env_obs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef ENV_PHASE_CLOCKS
int env_obs_set_phase_cycles(void* buf) { return set_phase_cycles(buf); }
#endif

// Blocks of the kernel an SM holds at `threads` threads and `smem` bytes
// of shared memory a block (the occupancy calculator), or -1.
int env_obs_blocks_per_sm(int threads, int smem) {
  if (allow_smem(smem) != 0) return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, env_obs_kernel, threads, smem) == cudaSuccess
             ? n
             : -1;
}

// Launch over the arguments of ObsArgs, in its order (the heightfield's
// ints after n_scan, its floats first), on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a wrong count,
// shape or geometry).
int env_obs_launch(void* const* p, const int* iv, const float* fv, int np,
                   int ni, int nf, void* stream) {
  ArgReader r{p, iv, fv, np, ni, nf};
  ObsArgs a;
  a.qpos = r.ptr<const float>();
  a.qvel = r.ptr<const float>();
  a.command = r.ptr<const float>();
  a.action = r.ptr<const float>();
  a.t2m = r.ptr<const int>();
  a.grid = r.ptr<const float>();
  a.hfield = r.ptr<const float4>();
  for (int k = 0; k < kParts; ++k) a.draw[k] = r.ptr<const float>();
  a.obs = r.ptr<float>();
  a.n = r.in();
  a.envs = r.in();
  a.threads = r.in();
  a.smem_bytes = r.in();
  a.nq = r.in();
  a.nv = r.in();
  a.nj = r.in();
  a.n_obs = r.in();
  a.n_scan = r.in();
  a.hf.cells = a.hfield;
  a.hf.rows = r.in();
  a.hf.cols = r.in();
  a.hf.inv_cell = r.fl();
  a.hf.half_rows = r.fl();
  a.hf.half_cols = r.fl();
  a.hf.max_u = r.fl();
  a.hf.max_v = r.fl();
  a.ang_vel_scale = r.fl();
  for (int k = 0; k < 3; ++k) a.cmd_scale[k] = r.fl();
  a.gravity_scale = r.fl();
  a.joint_vel_scale = r.fl();
  a.offset_z = r.fl();
  a.clip = r.fl();
  for (int k = 0; k < kParts; ++k) a.lo[k] = r.fl();
  for (int k = 0; k < kParts; ++k) a.span[k] = r.fl();
  const ObsLayout L(a);
  const int nj = a.nj;
  a.in.add(a.grid, L.grid, 2 * a.n_scan, kSlabTable);
  a.in.add(a.t2m, L.t2m, nj, kSlabTable);
  a.in.add(a.qpos, L.qpos, a.nq);
  a.in.add(a.qvel, L.qvel, a.nv);
  a.in.add(a.command, L.cmd, 3);
  a.in.add(a.action, L.act, nj);
  const int widths[kScanPart] = {3, 3, nj, nj};
  for (int k = 0; k < kScanPart; ++k)
    a.in.add(a.draw[k], L.draw[k], widths[k]);
  if (a.in.full || !r.exact() || a.n < 0 || a.envs < 1 || a.threads < 32 ||
      a.threads < a.envs || a.threads > kObsThreads || a.threads % 32 != 0 ||
      a.nj < 0 || a.nj > kMaxDofs || a.nq != 7 + a.nj || a.nv != 6 + a.nj ||
      a.n_scan < 0 || a.n_obs != 9 + 3 * a.nj + a.n_scan ||
      (a.n_scan > 0 && a.grid == nullptr) || a.smem_bytes != 4 * L.words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int err = allow_smem(a.smem_bytes);
  if (err != 0) return err;
  const int grid = (a.n + a.envs - 1) / a.envs;
  env_obs_kernel<<<grid, a.threads, a.smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
