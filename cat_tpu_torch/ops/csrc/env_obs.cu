// The env step's observation, one thread an output entry: the 45-wide
// proprioceptive part (the base's angular velocity, the command, the
// projected gravity, the joints' positions and velocities in task order,
// the action) and, on a heightfield with the scan, the 187-point height
// scan: the grid turned by the base's yaw around the base, the corner
// lookup and bilinear blend (env_model.cuh height_at), the offset and the
// clip. Each part's noise is pre-drawn (a null draw: no noise) and added
// as the plain version adds it, then each part is scaled by the env's
// scale. It writes straight into the (N, 45 or 232) observation in the
// plain version's column order, with int32 cell indices.
//
// Replaces no Pallas kernel: with env_terms.cu and env_update.cu it is the
// counterpart of what XLA fuses of the JAX package's CatEnv.step (its
// _observations, cat_tpu/envs/env.py:719-759, the height scan :746). Its
// plain version is envs/env.py CatEnv.obs_stage; the reset observation
// (CatEnv.observe) runs it too.
//
// Layout: envs leading and contiguous; qpos (N, nq), qvel (N, nv), command
// (N, 3), action (N, nj) in task order, t2m (nj), the scan grid (points,
// 2), the noise (N, 3), (N, 3), (N, nj), (N, nj), (N, points); out
// (N, n_obs). On the plane (a null corner table) every height is 0.

#include "env_model.cuh"

namespace {

using namespace envk;

struct ObsArgs {
  const float *qpos, *qvel, *command, *action;
  const int* t2m;
  const float* grid;
  const float4* hfield;
  // the noise of each part, (N, width) U(-mag, mag) added to it, or null
  const float *ang_vel, *gravity, *joint_pos, *joint_vel, *scan;
  float* obs;
  int n, nq, nv, nj, n_obs, n_scan;
  Hfield hf;
  // the parts' scales (CatEnv's): the angular velocity, the command's
  // three, the projected gravity, the joints' velocities
  float ang_vel_scale, cmd_scale[3], gravity_scale, joint_vel_scale;
  float offset_z, clip;
};

__device__ __forceinline__ float noisy(const float* z, float x, int e,
                                       int width, int k) {
  return z == nullptr ? x : x + z[static_cast<size_t>(e) * width + k];
}

__global__ void __launch_bounds__(kThreads) env_obs_kernel(const ObsArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(a.n) * a.n_obs) return;
  const int e = static_cast<int>(t / a.n_obs);
  const int c = static_cast<int>(t % a.n_obs);
  const int nj = a.nj;
  const float* qp = a.qpos + static_cast<size_t>(e) * a.nq;
  const float* qv = a.qvel + static_cast<size_t>(e) * a.nv;
  const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
  float v;
  if (c < 3) {
    v = noisy(a.ang_vel, qv[3 + c], e, 3, c) * a.ang_vel_scale;
  } else if (c < 6) {
    v = a.command[static_cast<size_t>(e) * 3 + c - 3] * a.cmd_scale[c - 3];
  } else if (c < 9) {
    const V3 g = quat_rotate_inv(q, {0.f, 0.f, -1.f});
    const float gk = c == 6 ? g.x : (c == 7 ? g.y : g.z);
    v = noisy(a.gravity, gk, e, 3, c - 6) * a.gravity_scale;
  } else if (c < 9 + nj) {
    const int j = c - 9;
    v = noisy(a.joint_pos, qp[7 + a.t2m[j]], e, nj, j);
  } else if (c < 9 + 2 * nj) {
    const int j = c - 9 - nj;
    v = noisy(a.joint_vel, qv[6 + a.t2m[j]], e, nj, j) * a.joint_vel_scale;
  } else if (c < 9 + 3 * nj) {
    v = a.action[static_cast<size_t>(e) * nj + c - 9 - 2 * nj];
  } else {
    // a scan point: the grid turned by the base's yaw, around the base
    const int p = c - 9 - 3 * nj;
    const float yaw = quat_yaw(q);
    const float cy = cosf(yaw), sy = sinf(yaw);
    const float gx = a.grid[2 * p], gy = a.grid[2 * p + 1];
    const float px = (qp[0] + cy * gx) - sy * gy;
    const float py = (qp[1] + sy * gx) + cy * gy;
    const float h = height_at(a.hf, px, py);
    v = noisy(a.scan, clampf((qp[2] - a.offset_z) - h, -a.clip, a.clip), e,
              a.n_scan, p);
  }
  a.obs[t] = v;
}

}  // namespace

extern "C" {

const char* env_obs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch over the arguments of ObsArgs, in its order (the heightfield's
// fields after n_scan), on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a wrong count or shape).
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
  a.ang_vel = r.ptr<const float>();
  a.gravity = r.ptr<const float>();
  a.joint_pos = r.ptr<const float>();
  a.joint_vel = r.ptr<const float>();
  a.scan = r.ptr<const float>();
  a.obs = r.ptr<float>();
  a.n = r.in();
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
  if (!r.exact() || a.n < 0 || a.nq != 7 + a.nj || a.nv != 6 + a.nj ||
      a.n_obs != 9 + 3 * a.nj + a.n_scan ||
      (a.n_scan > 0 && a.grid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(a.n) * a.n_obs;
  if (total == 0) return 0;
  const int grid = static_cast<int>((total + kThreads - 1) / kThreads);
  env_obs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
