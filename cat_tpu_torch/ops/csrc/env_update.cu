// The env step's second stage, one thread an env, from env_terms.cu's
// outputs and the step's pre-drawn uniforms:
//   part "reset": the CaT transform (the running max, tau 0.95, -1 for a
//     column not yet seeded; each column's probability, each term's
//     maximum, cstr_prob; the curriculum's max_p from the step counter),
//     the reward clamp(r (1 - p), min 0) and dones = where(reset, 1,
//     cstr_prob), the episode sums, each env's share of the
//     finished-episode accumulators, the terrain curriculum's row and
//     origin, and the masked reset of every SimState field (the reset
//     template's row, a fresh pose from the draws, the spawn height a
//     heightfield lookup) and of the episode fields;
//   part "commands": the reset envs' commands, the command schedule,
//     deadzone, stochastic resample and yaw flip, and the push.
// A launch runs either part or both (a task's reset event terms run
// between the two parts, in PyTorch).
//
// Replaces no Pallas kernel: with env_terms.cu and env_obs.cu it is the
// counterpart of what XLA fuses of the JAX package's CatEnv.step
// (cat_tpu/envs/env.py:492-683; this kernel :538-646 with _reset_sim :437,
// _patch_origins :418 and _update_commands :684, and envs/cat.py
// ConstraintSet.compute's transform :103 and curriculum_max_p :150). Its
// plain version is envs/env.py CatEnv.update_stage.
//
// One thread an env runs the stage's logic; the SimState fields a reset
// takes whole from the template's row (lam through touchdown) are copied
// element by element by every thread of the launch, which has enough
// threads for kCopyWords words each (reset_copy), so the copy is coalesced
// and spread over the card.
//
// The cross-env sums are not made here: each env writes its share of the
// accumulators, a row of `shares` (N, 2 n_terms + 6: the violation
// shares, the probability shares, reward, length, count, and the three
// termination causes), which the caller sums with one torch.sum. No float
// atomics: a launch is the same bit for bit on every run, and so are the
// sums.
//
// Layout: envs leading and contiguous; the SimState fields in their order
// (qpos, qvel, lam, applied_torque, joint_acc, forces, force_hist, the
// four air fields, touchdown as bytes), each (N, width); the reset
// template the same; the running max and col_max (columns), init_max_p
// and is_cur (n_terms); the episode sums (N, n_terms) and (N); command
// (N, 3), the time left and the origin (N) and (N, 2), the terrain row
// and column (N) int32; the draws (N, 3 + nj), (N, 4) x 3, (N) x 3 and
// the push velocity (N, 2); the model's default joints and limits (nj, model order); the
// heightfield's packed corners or null.

#include <algorithm>

#include "env_model.cuh"

namespace {

using namespace envk;

constexpr int kFields = 12;       // SimState's fields
constexpr int kPartReset = 1, kPartCommands = 2;
constexpr int kCopyWords = 4;     // words of the reset's copy a thread

struct UpdateArgs {
  // env_terms.cu's outputs
  const float *raw, *col_max;
  const int *episode_len, *common_step;
  const unsigned char *time_out, *illegal, *upside;
  // the constraint set and the env state
  const float *running_max, *init_max_p;
  const unsigned char* is_cur;
  const int* term_ints;
  const float *episode_viol, *episode_prob, *episode_rew, *command,
      *time_left, *origin;
  const int *terrain_row, *terrain_col;
  const float *action, *prev_action;
  const void* sim[kFields];
  const void* tmpl[kFields];
  const float *qj_default, *qj_lower, *qj_upper;
  const float4* hfield;
  // the draws
  const float *u_reset, *u_reset_cmd, *u_expired_cmd, *u_resample,
      *u_resample_cmd, *u_flip, *u_push, *push_vel;
  // outputs
  float *running_max_out, *max_p_out, *reward, *dones, *episode_viol_out,
      *episode_prob_out, *episode_rew_out, *shares;
  int* episode_len_out;
  float *action_out, *prev_action_out, *command_out, *time_left_out,
      *origin_out;
  int* terrain_row_out;
  void* out[kFields];
  int n, part, n_terms, n_cols, nj, curriculum, terrain_rows, push;
  int width[kFields];
  Hfield hf;
  float inv_num_steps, tau, one_minus_tau, lin_weight, ang_weight, inv_std2,
      step_dt, episode_length_s, deadzone, patch_m, half_h, half_w, pose_xy,
      reset_yaw, scale_lo, scale_span, base_z, rel_standing,
      resampling_time, p_idle, p_move, p_flip, p_push;
  float cmd_lo[3], cmd_span[3];
};

// ConstraintSet.curriculum_max_p of term t at step counter cs
__device__ __forceinline__ float max_p_of(const UpdateArgs& a, int t,
                                          int cs) {
  const float init = a.init_max_p[t];
  if (!a.is_cur[t]) return init;
  const float progress =
      clamp_max(static_cast<float>(cs) * a.inv_num_steps, 1.f);
  const float t_end = 1.f / clamp_min(init, 1e-6f);
  return 1.f / (progress * (t_end - 20.f) + 20.f);
}

// the running max of column c after this step
__device__ __forceinline__ float new_rmax(const UpdateArgs& a, int c) {
  const float rm = a.running_max[c], cm = a.col_max[c];
  return rm < 0.f ? cm : rm * a.tau + cm * a.one_minus_tau;
}

// CatEnv._commands_from: a uniform command, zero for a standing env
__device__ __forceinline__ void sample_command(const UpdateArgs& a,
                                               const float* u, float c[3]) {
  const bool standing = u[3] < a.rel_standing;
  for (int k = 0; k < 3; ++k)
    c[k] = standing ? 0.f : a.cmd_span[k] * u[k] + a.cmd_lo[k];
}

// the masked reset of the fields a reset takes whole from the template
// (lam .. touchdown), element by element over every thread of the launch:
// consecutive threads copy consecutive words, whatever env they are in
__device__ __forceinline__ void reset_copy(const UpdateArgs& a) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t begin =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int f = 2; f < kFields; ++f) {
    const int w = a.width[f];
    const size_t total = static_cast<size_t>(a.n) * w;
    const bool bytes = f == kFields - 1;     // touchdown
    for (size_t i = begin; i < total; i += stride) {
      const size_t e = i / w;
      const bool reset = a.time_out[e] || a.illegal[e] || a.upside[e];
      const void* src = reset ? a.tmpl[f] : a.sim[f];
      if (bytes)
        static_cast<unsigned char*>(a.out[f])[i] =
            static_cast<const unsigned char*>(src)[i];
      else
        static_cast<float*>(a.out[f])[i] = static_cast<const float*>(src)[i];
    }
  }
}

// part "reset"; qv gets the env's qvel after the masked reset
__device__ void reset_part(const UpdateArgs& a, int e, bool reset,
                           float* qv) {
  const int nq = a.width[0], nv = a.width[1], nj = a.nj;
  const int nt = a.n_terms;
  const bool ill = a.illegal[e], up = a.upside[e], to = a.time_out[e];
  const bool terminated = ill || up;
  const int ep = a.episode_len[e];
  const int cs = *a.common_step;
  const float rf = as_float(reset);
  const float ep_len_f = clamp_min(static_cast<float>(ep), 1.f);

  // the running max and max_p, each written by one thread
  for (int c = e; c < a.n_cols; c += a.n) a.running_max_out[c] = new_rmax(a, c);
  for (int t = e; t < nt; t += a.n) a.max_p_out[t] = max_p_of(a, t, cs);

  // 5. the CaT transform, term by term
  const float* raw = a.raw + static_cast<size_t>(e) * a.n_cols;
  const float* ev = a.episode_viol + static_cast<size_t>(e) * nt;
  const float* epr = a.episode_prob + static_cast<size_t>(e) * nt;
  float* ev_out = a.episode_viol_out + static_cast<size_t>(e) * nt;
  float* ep_out = a.episode_prob_out + static_cast<size_t>(e) * nt;
  float* sh = a.shares + static_cast<size_t>(e) * (2 * nt + 6);
  float cstr = -INFINITY;
  for (int t = 0; t < nt; ++t) {
    const int* ti = a.term_ints + t * kTermInts;
    const int c0 = ti[1], nc = ti[2];
    const float mp = max_p_of(a, t, cs);
    float tm = -INFINITY;
    for (int c = c0; c < c0 + nc; ++c) {
      const float r = raw[c];
      const float p =
          r > 0.f ? 0.f + clampf(r / new_rmax(a, c), 0.f, 1.f) * (mp - 0.f)
                  : 0.f;
      tm = nanmax(tm, p);
    }
    cstr = nanmax(cstr, tm);
    const float v = ev[t] + as_float(tm > 0.f);
    const float pr = epr[t] + tm;
    sh[t] = rf * v / ep_len_f * 100.f;
    sh[nt + t] = rf * pr / ep_len_f;
    ev_out[t] = reset ? 0.f : v;
    ep_out[t] = reset ? 0.f : pr;
  }

  // the reward from the step's velocities (before the reset)
  const float* qp = static_cast<const float*>(a.sim[0]) +
                    static_cast<size_t>(e) * nq;
  const float* qv_in = static_cast<const float*>(a.sim[1]) +
                       static_cast<size_t>(e) * nv;
  const float* cmd = a.command + static_cast<size_t>(e) * 3;
  const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
  const V3 vb = quat_rotate_inv(q, {qv_in[0], qv_in[1], qv_in[2]});
  const float d0 = cmd[0] - vb.x, d1 = cmd[1] - vb.y, d2 = cmd[2] - qv_in[5];
  const float lin_err = d0 * d0 + d1 * d1;
  const float ang_err = d2 * d2;
  const float base = (expf(-lin_err * a.inv_std2) * a.lin_weight +
                      expf(-ang_err * a.inv_std2) * a.ang_weight) *
                     a.step_dt;
  const float reward = clamp_min(base * (1.f - cstr), 0.f);
  a.reward[e] = reward;
  a.dones[e] = reset ? 1.f : cstr;
  const float er = a.episode_rew[e] + reward;
  a.episode_rew_out[e] = reset ? 0.f : er;

  // 6. each env's share of the finished-episode accumulators
  sh[2 * nt] = rf * er;
  sh[2 * nt + 1] = rf * static_cast<float>(ep);
  sh[2 * nt + 2] = rf;
  sh[2 * nt + 3] = as_float(ill);
  sh[2 * nt + 4] = as_float(up && !ill);
  sh[2 * nt + 5] = as_float(to && !terminated);

  // the terrain curriculum
  const float* org = a.origin + static_cast<size_t>(e) * 2;
  int trow = a.terrain_row[e];
  float ox = org[0], oy = org[1];
  if (a.curriculum) {
    const float dist = norm2(qp[0] - ox, qp[1] - oy);
    const float speed = norm2(cmd[0], cmd[1]);
    const float required = speed * a.episode_length_s;
    const bool moving = speed > a.deadzone;
    const bool move_up = to && dist > required * 0.5f && moving;
    const bool move_down = dist < required * 0.25f;
    int row = trow + static_cast<int>(move_up) - static_cast<int>(move_down);
    row = row < 0 ? 0 : (row > a.terrain_rows - 1 ? a.terrain_rows - 1 : row);
    if (reset) {
      trow = row;
      ox = (static_cast<float>(trow) + 0.5f) * a.patch_m - a.half_h;
      oy = (static_cast<float>(a.terrain_col[e]) + 0.5f) * a.patch_m -
           a.half_w;
    }
  }
  a.terrain_row_out[e] = trow;
  a.origin_out[2 * e] = ox;
  a.origin_out[2 * e + 1] = oy;

  // the masked reset: a fresh pose (CatEnv._reset_sim_from) where the env
  // resets, every other field the template's row
  float* qp_out = static_cast<float*>(a.out[0]) + static_cast<size_t>(e) * nq;
  if (reset) {
    const float* u = a.u_reset + static_cast<size_t>(e) * (3 + nj);
    const float x = ox + (u[0] * 2.f - 1.f) * a.pose_xy;
    const float y = oy + (u[1] * 2.f - 1.f) * a.pose_xy;
    const float yaw = (u[2] * 2.f - 1.f) * a.reset_yaw;
    float quat[4];
    quat_from_euler_zyx(0.f, 0.f, yaw, quat);
    qp_out[0] = x;
    qp_out[1] = y;
    qp_out[2] = height_at(a.hf, x, y) + a.base_z;
    for (int k = 0; k < 4; ++k) qp_out[3 + k] = quat[k];
    for (int j = 0; j < nj; ++j)
      qp_out[7 + j] = clampf(
          a.qj_default[j] * (u[3 + j] * a.scale_span + a.scale_lo),
          a.qj_lower[j], a.qj_upper[j]);
  } else {
    for (int k = 0; k < nq; ++k) qp_out[k] = qp[k];
  }
  const float* qv_src = reset ? static_cast<const float*>(a.tmpl[1]) +
                                    static_cast<size_t>(e) * nv
                              : qv_in;
  for (int k = 0; k < nv; ++k) qv[k] = qv_src[k];

  a.episode_len_out[e] = reset ? 0 : ep;
  const float* act = a.action + static_cast<size_t>(e) * nj;
  const float* pact = a.prev_action + static_cast<size_t>(e) * nj;
  for (int j = 0; j < nj; ++j) {
    a.action_out[static_cast<size_t>(e) * nj + j] = reset ? 0.f : act[j];
    a.prev_action_out[static_cast<size_t>(e) * nj + j] = reset ? 0.f : pact[j];
  }
}

// part "commands" (7-8): qv is the env's qvel, pushed here
__device__ void commands_part(const UpdateArgs& a, int e, bool reset,
                              float* qv) {
  float c[3];
  float tl;
  if (reset) {
    sample_command(a, a.u_reset_cmd + static_cast<size_t>(e) * 4, c);
    tl = a.resampling_time;
  } else {
    for (int k = 0; k < 3; ++k) c[k] = a.command[static_cast<size_t>(e) * 3 + k];
    tl = a.time_left[e];
  }
  // 7. the schedule, the deadzone, the stochastic resample, the yaw flip
  tl = tl - a.step_dt;
  if (tl <= 0.f) {
    sample_command(a, a.u_expired_cmd + static_cast<size_t>(e) * 4, c);
    tl = a.resampling_time;
  }
  const float keep = as_float(fabsf(c[0]) > a.deadzone ||
                              fabsf(c[1]) > a.deadzone ||
                              fabsf(c[2]) > a.deadzone);
  for (int k = 0; k < 3; ++k) c[k] = c[k] * keep;
  const float no_cmd = as_float(norm3(c[0], c[1], c[2]) < a.deadzone);
  const float p_res = no_cmd * a.p_idle + (1.f - no_cmd) * a.p_move;
  if (a.u_resample[e] < p_res) {
    sample_command(a, a.u_resample_cmd + static_cast<size_t>(e) * 4, c);
    tl = a.resampling_time;
  }
  const bool flip = a.u_flip[e] < a.p_flip;
  c[2] = c[2] * (1.f - as_float(flip) * 2.f);
  for (int k = 0; k < 3; ++k) a.command_out[static_cast<size_t>(e) * 3 + k] = c[k];
  a.time_left_out[e] = tl;

  // 8. the push: the whole root velocity
  if (a.push && a.u_push[e] < a.p_push) {
    qv[0] = a.push_vel[static_cast<size_t>(e) * 2];
    qv[1] = a.push_vel[static_cast<size_t>(e) * 2 + 1];
    for (int k = 2; k < 6; ++k) qv[k] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    env_update_kernel(const UpdateArgs a) {
  if (a.part & kPartReset) reset_copy(a);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.n) return;
  const bool reset = a.time_out[e] || a.illegal[e] || a.upside[e];
  const int nv = a.width[1];
  float qv[kMaxDofs];
  if (a.part & kPartReset) {
    reset_part(a, e, reset, qv);
  } else {
    const float* src = static_cast<const float*>(a.sim[1]) +
                       static_cast<size_t>(e) * nv;
    for (int k = 0; k < nv; ++k) qv[k] = src[k];
  }
  if (a.part & kPartCommands) commands_part(a, e, reset, qv);
  float* dst = static_cast<float*>(a.out[1]) + static_cast<size_t>(e) * nv;
  for (int k = 0; k < nv; ++k) dst[k] = qv[k];
}

}  // namespace

extern "C" {

const char* env_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch over the arguments of UpdateArgs, in its order (the arrays sim,
// tmpl, out and width field by field, the heightfield's fields after
// width), on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a wrong count or shape).
int env_update_launch(void* const* p, const int* iv, const float* fv, int np,
                      int ni, int nf, void* stream) {
  ArgReader r{p, iv, fv, np, ni, nf};
  UpdateArgs a;
  a.raw = r.ptr<const float>();
  a.col_max = r.ptr<const float>();
  a.episode_len = r.ptr<const int>();
  a.common_step = r.ptr<const int>();
  a.time_out = r.ptr<const unsigned char>();
  a.illegal = r.ptr<const unsigned char>();
  a.upside = r.ptr<const unsigned char>();
  a.running_max = r.ptr<const float>();
  a.init_max_p = r.ptr<const float>();
  a.is_cur = r.ptr<const unsigned char>();
  a.term_ints = r.ptr<const int>();
  a.episode_viol = r.ptr<const float>();
  a.episode_prob = r.ptr<const float>();
  a.episode_rew = r.ptr<const float>();
  a.command = r.ptr<const float>();
  a.time_left = r.ptr<const float>();
  a.origin = r.ptr<const float>();
  a.terrain_row = r.ptr<const int>();
  a.terrain_col = r.ptr<const int>();
  a.action = r.ptr<const float>();
  a.prev_action = r.ptr<const float>();
  for (int f = 0; f < kFields; ++f) a.sim[f] = r.ptr<const void>();
  for (int f = 0; f < kFields; ++f) a.tmpl[f] = r.ptr<const void>();
  a.qj_default = r.ptr<const float>();
  a.qj_lower = r.ptr<const float>();
  a.qj_upper = r.ptr<const float>();
  a.hfield = r.ptr<const float4>();
  a.u_reset = r.ptr<const float>();
  a.u_reset_cmd = r.ptr<const float>();
  a.u_expired_cmd = r.ptr<const float>();
  a.u_resample = r.ptr<const float>();
  a.u_resample_cmd = r.ptr<const float>();
  a.u_flip = r.ptr<const float>();
  a.u_push = r.ptr<const float>();
  a.push_vel = r.ptr<const float>();
  a.running_max_out = r.ptr<float>();
  a.max_p_out = r.ptr<float>();
  a.reward = r.ptr<float>();
  a.dones = r.ptr<float>();
  a.episode_viol_out = r.ptr<float>();
  a.episode_prob_out = r.ptr<float>();
  a.episode_rew_out = r.ptr<float>();
  a.shares = r.ptr<float>();
  a.episode_len_out = r.ptr<int>();
  a.action_out = r.ptr<float>();
  a.prev_action_out = r.ptr<float>();
  a.command_out = r.ptr<float>();
  a.time_left_out = r.ptr<float>();
  a.origin_out = r.ptr<float>();
  a.terrain_row_out = r.ptr<int>();
  for (int f = 0; f < kFields; ++f) a.out[f] = r.ptr<void>();
  a.n = r.in();
  a.part = r.in();
  a.n_terms = r.in();
  a.n_cols = r.in();
  a.nj = r.in();
  a.curriculum = r.in();
  a.terrain_rows = r.in();
  a.push = r.in();
  for (int f = 0; f < kFields; ++f) a.width[f] = r.in();
  a.hf.cells = a.hfield;
  a.hf.rows = r.in();
  a.hf.cols = r.in();
  a.hf.inv_cell = r.fl();
  a.hf.half_rows = r.fl();
  a.hf.half_cols = r.fl();
  a.hf.max_u = r.fl();
  a.hf.max_v = r.fl();
  a.inv_num_steps = r.fl();
  a.tau = r.fl();
  a.one_minus_tau = r.fl();
  a.lin_weight = r.fl();
  a.ang_weight = r.fl();
  a.inv_std2 = r.fl();
  a.step_dt = r.fl();
  a.episode_length_s = r.fl();
  a.deadzone = r.fl();
  a.patch_m = r.fl();
  a.half_h = r.fl();
  a.half_w = r.fl();
  a.pose_xy = r.fl();
  a.reset_yaw = r.fl();
  a.scale_lo = r.fl();
  a.scale_span = r.fl();
  a.base_z = r.fl();
  a.rel_standing = r.fl();
  a.resampling_time = r.fl();
  a.p_idle = r.fl();
  a.p_move = r.fl();
  a.p_flip = r.fl();
  a.p_push = r.fl();
  for (int k = 0; k < 3; ++k) a.cmd_lo[k] = r.fl();
  for (int k = 0; k < 3; ++k) a.cmd_span[k] = r.fl();
  if (!r.exact() || a.n < 0 || a.part < 1 || a.part > 3 || a.n_terms < 0 ||
      a.width[0] != 7 + a.nj || a.width[1] < 6 || a.width[1] > kMaxDofs ||
      (a.hfield != nullptr && (a.hf.rows < 2 || a.hf.cols < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  // a thread an env, and enough threads that each copies ~kCopyWords of
  // the masked reset's whole rows
  size_t words = 0;
  for (int f = 2; f < kFields; ++f) words += static_cast<size_t>(a.n) * a.width[f];
  const size_t per_block = static_cast<size_t>(kThreads) * kCopyWords;
  const int grid = static_cast<int>(
      std::max<size_t>((a.n + kThreads - 1) / kThreads,
                       (words + per_block - 1) / per_block));
  env_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
