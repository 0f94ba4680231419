// The env step's second stage, from env_terms.cu's outputs and the step's
// pre-drawn uniforms:
//   part "reset": the CaT transform (the running max, tau 0.95, -1 for a
//     column not yet seeded; each column's probability, each term's
//     maximum, cstr_prob; the curriculum's max_p from the step counter),
//     the reward clamp(r (1 - p), min 0) and dones = where(reset, 1,
//     cstr_prob), the episode sums, the finished-episode accumulators, the
//     terrain curriculum's row and origin, and the masked reset of every
//     SimState field (the reset template's row, a fresh pose from the
//     draws, the spawn height a heightfield lookup) and of the episode
//     fields;
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
// Bound: bytes (measure.env_counts; 15.5 MB at Solo12's 4096 envs, 4.6 us
// at 3.35 TB/s), most of them the masked reset's copy of each env's lam ..
// touchdown rows. The design (ops/env_step.py env_geometry sizes it): a
// block owns `envs` consecutive envs, so that 4096 envs fill the card in
// one wave, and
//   staging: every input the part reads is one contiguous slab of the
//     block's rows (raw, the episode rows, the SimState fields, the
//     command, the draws, ...), all copied into shared memory at once
//     (env_model.cuh stage_all over the slabs the launch function lists:
//     cp.async, 16 bytes a copy; a call a slab would put one copy of the
//     copy code in the kernel for each, and this kernel's first version
//     had 11,640 instructions);
//   copy: once a block, each column's new running max and each term's
//     max_p; then the template's rows of the envs that reset are fetched
//     over theirs in the staged lam .. touchdown (cp.async, a warp a row)
//     while the columns are computed, so the region leaves at the end as
//     the masked reset's rows: the source is chosen per row, with no
//     division per word;
//   columns: a thread a column (env_model.cuh ColumnDeal) turns each raw
//     value of its group of envs into its probability in place; a thread
//     an (env, term) takes the term's
//     maximum in column order, the episode sums and their shares;
//   per-env logic, in three warps at once, a thread an env in each: the
//     reward, dones and the accumulators' last six shares; the terrain
//     curriculum, the fresh pose and the episode fields' reset; qvel (the
//     step's or the template's), the commands and the push;
//   fold: the accumulators without float atomics. A thread a share sums
//     the block's envs in env order into one partial row; the last block
//     to finish (an atomic ticket after a __threadfence) stages the
//     partial rows into shared memory, sums them in block order, adds
//     them to the incoming accumulators, writes
//     the six accumulator outputs and sets the ticket back to 0, so a
//     launch (and a CUDA graph's replay) is the same bit for bit on every
//     run; ops/env_step.py fold_shares adds in this order in float32;
//   write-back: every output leaves shared memory as one slab of the
//     block's rows, lam .. touchdown too. Its stores come after the fold's
//     __threadfence, so the fence waits on the few stores before it.
//
// Layout: envs leading and contiguous; the SimState fields in their order
// (qpos, qvel, lam, applied_torque, joint_acc, forces, force_hist, the
// four air fields, touchdown as bytes), each (N, width); the reset
// template the same; the running max and col_max (columns), init_max_p
// and is_cur (n_terms), the term table (n_terms, 5) and each column's term
// (columns); the episode sums (N, n_terms) and (N); command (N, 3), the
// time left and the origin (N) and (N, 2), the terrain row and column (N)
// int32; the draws (N, 3 + nj), (N, 4) x 3, (N) x 3 and the push velocity
// (N, 2); the model's default joints and limits (nj, model order); the
// heightfield's packed corners or null; the accumulators (n_terms) x 2, ()
// x 3, (3), in and out; the block partials (blocks, 2 n_terms + 6), the
// ticket () int32, and, where given, every env's shares (N, 2 n_terms + 6).

#include "env_model.cuh"

namespace {

using namespace envk;

constexpr int kFields = 12;       // SimState's fields
constexpr int kTouchdown = kFields - 1;
constexpr int kPartReset = 1, kPartCommands = 2;
// the phases of the phase-clock build (ops/env_step.py
// EnvUpdateKernel.phases)
enum Phase { kStaging, kColumns, kPerEnv, kFold, kCopy, kWriteBack };

struct UpdateArgs {
  // env_terms.cu's outputs
  const float *raw, *col_max;
  const int *episode_len, *common_step;
  const unsigned char *time_out, *illegal, *upside;
  // the constraint set and the env state
  const float *running_max, *init_max_p;
  const unsigned char* is_cur;
  const int *term_ints, *col_term;
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
  // the incoming accumulators
  const float *acc_viol, *acc_prob, *acc_rew, *acc_len, *acc_count,
      *acc_term;
  // outputs
  float *running_max_out, *max_p_out, *reward, *dones, *episode_viol_out,
      *episode_prob_out, *episode_rew_out;
  int* episode_len_out;
  float *action_out, *prev_action_out, *command_out, *time_left_out,
      *origin_out;
  int* terrain_row_out;
  void* out[kFields];
  float *acc_viol_out, *acc_prob_out, *acc_rew_out, *acc_len_out,
      *acc_count_out, *acc_term_out;
  float* partials;
  int* ticket;
  float* shares;
  int n, envs, threads, smem_bytes, part, n_terms, n_cols, nj, curriculum,
      terrain_rows, push;
  int width[kFields];
  Hfield hf;
  float inv_num_steps, tau, one_minus_tau, lin_weight, ang_weight, inv_std2,
      step_dt, episode_length_s, deadzone, patch_m, half_h, half_w, pose_xy,
      reset_yaw, scale_lo, scale_span, base_z, rel_standing,
      resampling_time, p_idle, p_move, p_flip, p_push;
  float cmd_lo[3], cmd_span[3];
  // what a block stages, writes back in the copy phase (lam .. touchdown
  // as the step left them) and at the end (the launch function lists them)
  Slabs<56> in;
  Slabs<10> copy_out;
  Slabs<16> out_rows;

  __host__ __device__ int shares_width() const { return 2 * n_terms + 6; }
};

// the block's shared memory, region by region (word offsets; ops/env_step.py
// env_geometry counts the same)
struct UpdateLayout {
  int rm_in, cm, rmax, init_p, is_cur, max_p, tints, col_term, qj_default,
      qj_lower, qj_upper, cs, last, acc;
  int raw, ep, to, il, up, ev, epr, erew, cmd, tl, org, trow, tcol, act,
      pact, qpos, qvel, field[kFields];
  int u_reset, u_rcmd, u_ecmd, u_res, u_rescmd, u_flip, u_push, push_vel;
  int tm, sh, rew, don, ep_out, qpos_out, qvel_out, cmd_out, tl_out, tqv;
  int words;
  __host__ __device__ explicit UpdateLayout(const UpdateArgs& a) {
    Layout l;
    const int E = a.envs, K = a.n_cols, nt = a.n_terms, nj = a.nj;
    const int nq = a.width[0], nv = a.width[1];
    rm_in = l.take(K);
    cm = l.take(K);
    rmax = l.take(K);
    init_p = l.take(nt);
    is_cur = l.take_bytes(nt);
    max_p = l.take(nt);
    tints = l.take(kTermInts * nt);
    col_term = l.take(K);
    qj_default = l.take(nj);
    qj_lower = l.take(nj);
    qj_upper = l.take(nj);
    cs = l.take(1);
    last = l.take(1);
    acc = l.take(a.shares_width());
    raw = l.take(E * K);
    ep = l.take(E);
    to = l.take_bytes(E);
    il = l.take_bytes(E);
    up = l.take_bytes(E);
    ev = l.take(E * nt);
    epr = l.take(E * nt);
    erew = l.take(E);
    cmd = l.take(E * 3);
    tl = l.take(E);
    org = l.take(E * 2);
    trow = l.take(E);
    tcol = l.take(E);
    act = l.take(E * nj);
    pact = l.take(E * nj);
    qpos = field[0] = l.take(E * nq);
    qvel = field[1] = l.take(E * nv);
    for (int f = 2; f < kTouchdown; ++f) field[f] = l.take(E * a.width[f]);
    field[kTouchdown] = l.take_bytes(E * a.width[kTouchdown]);
    u_reset = l.take(E * (3 + nj));
    u_rcmd = l.take(E * 4);
    u_ecmd = l.take(E * 4);
    u_res = l.take(E);
    u_rescmd = l.take(E * 4);
    u_flip = l.take(E);
    u_push = l.take(E);
    push_vel = l.take(E * 2);
    tm = l.take(E * nt);
    sh = l.take(E * a.shares_width());
    rew = l.take(E);
    don = l.take(E);
    ep_out = l.take(E);
    qpos_out = l.take(E * nq);
    qvel_out = l.take(E * nv);
    cmd_out = l.take(E * 3);
    tl_out = l.take(E);
    tqv = l.take(E * nv);
    words = l.words;
  }
};

// ConstraintSet.curriculum_max_p of term t at step counter cs
__device__ __forceinline__ float max_p_of(float init, bool is_cur, int cs,
                                          float inv_num_steps) {
  if (!is_cur) return init;
  const float progress =
      clamp_max(static_cast<float>(cs) * inv_num_steps, 1.f);
  const float t_end = 1.f / clamp_min(init, 1e-6f);
  return 1.f / (progress * (t_end - 20.f) + 20.f);
}

// CatEnv._commands_from: a uniform command, zero for a standing env
__device__ __forceinline__ void sample_command(const UpdateArgs& a,
                                               const float* u, float c[3]) {
  const bool standing = u[3] < a.rel_standing;
  for (int k = 0; k < 3; ++k)
    c[k] = standing ? 0.f : a.cmd_span[k] * u[k] + a.cmd_lo[k];
}

struct Block {
  const UpdateArgs& a;
  const UpdateLayout& L;
  float* S;
  int* Si;
  unsigned char* Sb;
  int e0, ne;

  __device__ bool reset(int e) const {
    return Sb[4 * L.to + e] || Sb[4 * L.il + e] || Sb[4 * L.up + e];
  }

  // role 0: cstr_prob, the reward and dones, the episode reward, the
  // accumulators' last six shares (5-6)
  __device__ void reward(int e) const {
    const int nt = a.n_terms, nq = a.width[0], nv = a.width[1];
    const bool rs = reset(e), ill = Sb[4 * L.il + e], up = Sb[4 * L.up + e],
               to = Sb[4 * L.to + e];
    const float rf = as_float(rs);
    float cstr = -INFINITY;
    for (int t = 0; t < nt; ++t) cstr = nanmax(cstr, S[L.tm + e * nt + t]);
    // the reward from the step's velocities (before the reset)
    const float* qp = S + L.qpos + e * nq;
    const float* qv = S + L.qvel + e * nv;
    const float* cmd = S + L.cmd + e * 3;
    const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
    const V3 vb = quat_rotate_inv(q, {qv[0], qv[1], qv[2]});
    const float d0 = cmd[0] - vb.x, d1 = cmd[1] - vb.y, d2 = cmd[2] - qv[5];
    const float lin_err = d0 * d0 + d1 * d1;
    const float ang_err = d2 * d2;
    const float base = (expf(-lin_err * a.inv_std2) * a.lin_weight +
                        expf(-ang_err * a.inv_std2) * a.ang_weight) *
                       a.step_dt;
    const float reward = clamp_min(base * (1.f - cstr), 0.f);
    S[L.rew + e] = reward;
    S[L.don + e] = rs ? 1.f : cstr;
    const float er = S[L.erew + e] + reward;
    S[L.erew + e] = rs ? 0.f : er;
    float* sh = S + L.sh + e * a.shares_width();
    sh[2 * nt] = rf * er;
    sh[2 * nt + 1] = rf * static_cast<float>(Si[L.ep + e]);
    sh[2 * nt + 2] = rf;
    sh[2 * nt + 3] = as_float(ill);
    sh[2 * nt + 4] = as_float(up && !ill);
    sh[2 * nt + 5] = as_float(to && !(ill || up));
  }

  // role 1: the terrain curriculum and the masked reset of qpos (a fresh
  // pose, CatEnv._reset_sim_from) and of the episode fields
  __device__ void reset_pose(int e) const {
    const int nq = a.width[0], nj = a.nj;
    const bool rs = reset(e);
    const float* qp = S + L.qpos + e * nq;
    const float* cmd = S + L.cmd + e * 3;
    int trow = Si[L.trow + e];
    float ox = S[L.org + 2 * e], oy = S[L.org + 2 * e + 1];
    if (a.curriculum) {
      const float dist = norm2(qp[0] - ox, qp[1] - oy);
      const float speed = norm2(cmd[0], cmd[1]);
      const float required = speed * a.episode_length_s;
      const bool moving = speed > a.deadzone;
      const bool move_up =
          Sb[4 * L.to + e] && dist > required * 0.5f && moving;
      const bool move_down = dist < required * 0.25f;
      int row = trow + static_cast<int>(move_up) - static_cast<int>(move_down);
      row = row < 0 ? 0 : (row > a.terrain_rows - 1 ? a.terrain_rows - 1 : row);
      if (rs) {
        trow = row;
        ox = (static_cast<float>(trow) + 0.5f) * a.patch_m - a.half_h;
        oy = (static_cast<float>(Si[L.tcol + e]) + 0.5f) * a.patch_m -
             a.half_w;
      }
    }
    Si[L.trow + e] = trow;
    S[L.org + 2 * e] = ox;
    S[L.org + 2 * e + 1] = oy;
    float* qo = S + L.qpos_out + e * nq;
    if (rs) {
      const float* u = S + L.u_reset + e * (3 + nj);
      const float x = ox + (u[0] * 2.f - 1.f) * a.pose_xy;
      const float y = oy + (u[1] * 2.f - 1.f) * a.pose_xy;
      const float yaw = (u[2] * 2.f - 1.f) * a.reset_yaw;
      float quat[4];
      quat_from_euler_zyx(0.f, 0.f, yaw, quat);
      qo[0] = x;
      qo[1] = y;
      qo[2] = height_at(a.hf, x, y) + a.base_z;
      for (int k = 0; k < 4; ++k) qo[3 + k] = quat[k];
      for (int j = 0; j < nj; ++j)
        qo[7 + j] = clampf(
            S[L.qj_default + j] * (u[3 + j] * a.scale_span + a.scale_lo),
            S[L.qj_lower + j], S[L.qj_upper + j]);
      for (int j = 0; j < nj; ++j) {
        S[L.act + e * nj + j] = 0.f;
        S[L.pact + e * nj + j] = 0.f;
      }
    } else {
      for (int k = 0; k < nq; ++k) qo[k] = qp[k];
    }
    Si[L.ep_out + e] = rs ? 0 : Si[L.ep + e];
  }

  // role 2: qvel after the masked reset, then the commands (7) and the
  // push (8) of part "commands"
  __device__ void commands(int e) const {
    const int nv = a.width[1];
    const bool rs = reset(e);
    const float* src = (a.part & kPartReset) && rs ? S + L.tqv + e * nv
                                                    : S + L.qvel + e * nv;
    float* qv = S + L.qvel_out + e * nv;
    for (int k = 0; k < nv; ++k) qv[k] = src[k];
    if (!(a.part & kPartCommands)) return;
    float c[3];
    float tl;
    if (rs) {
      sample_command(a, S + L.u_rcmd + e * 4, c);
      tl = a.resampling_time;
    } else {
      for (int k = 0; k < 3; ++k) c[k] = S[L.cmd + e * 3 + k];
      tl = S[L.tl + e];
    }
    // 7. the schedule, the deadzone, the stochastic resample, the yaw flip
    tl = tl - a.step_dt;
    if (tl <= 0.f) {
      sample_command(a, S + L.u_ecmd + e * 4, c);
      tl = a.resampling_time;
    }
    const float keep = as_float(fabsf(c[0]) > a.deadzone ||
                                fabsf(c[1]) > a.deadzone ||
                                fabsf(c[2]) > a.deadzone);
    for (int k = 0; k < 3; ++k) c[k] = c[k] * keep;
    const float no_cmd = as_float(norm3(c[0], c[1], c[2]) < a.deadzone);
    const float p_res = no_cmd * a.p_idle + (1.f - no_cmd) * a.p_move;
    if (S[L.u_res + e] < p_res) {
      sample_command(a, S + L.u_rescmd + e * 4, c);
      tl = a.resampling_time;
    }
    const bool flip = S[L.u_flip + e] < a.p_flip;
    c[2] = c[2] * (1.f - as_float(flip) * 2.f);
    for (int k = 0; k < 3; ++k) S[L.cmd_out + e * 3 + k] = c[k];
    S[L.tl_out + e] = tl;
    // 8. the push: the whole root velocity
    if (a.push && S[L.u_push + e] < a.p_push) {
      qv[0] = S[L.push_vel + 2 * e];
      qv[1] = S[L.push_vel + 2 * e + 1];
      for (int k = 2; k < 6; ++k) qv[k] = 0.f;
    }
  }
};

__global__ void __launch_bounds__(kBlockThreads)
    env_update_kernel(const UpdateArgs a) {
  extern __shared__ __align__(16) float update_smem[];
  const UpdateLayout L(a);
  float* S = update_smem;
  int* Si = reinterpret_cast<int*>(update_smem);
  unsigned char* Sb = reinterpret_cast<unsigned char*>(update_smem);
  PhaseClock clk;
  const int tid = threadIdx.x, E = a.envs, K = a.n_cols, nt = a.n_terms;
  const int nj = a.nj, nq = a.width[0], nv = a.width[1];
  const int P = a.shares_width();
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, a.n - e0);
  const size_t r0 = static_cast<size_t>(e0);
  const bool do_reset = a.part & kPartReset, do_cmd = a.part & kPartCommands;
  const Block blk{a, L, S, Si, Sb, e0, ne};
  const float* const* tmpl = reinterpret_cast<const float* const*>(a.tmpl);

  // staging: every slab this part reads, all in flight at once
  stage_all(S, a.in, r0, ne);
  copy_wait();
  __syncthreads();
  clk.lap(kStaging);

  if (do_reset) {
    // each column's running max after this step, each term's max_p
    for (int c = tid; c < K; c += blockDim.x) {
      const float rm = S[L.rm_in + c], cm = S[L.cm + c];
      const float v = rm < 0.f ? cm : rm * a.tau + cm * a.one_minus_tau;
      S[L.rmax + c] = v;
      if (blockIdx.x == 0) a.running_max_out[c] = v;
    }
    for (int t = tid; t < nt; t += blockDim.x) {
      const float v = max_p_of(S[L.init_p + t], Sb[4 * L.is_cur + t] != 0,
                               Si[L.cs], a.inv_num_steps);
      S[L.max_p + t] = v;
      if (blockIdx.x == 0) a.max_p_out[t] = v;
    }
    // the template's rows of the reset envs over theirs in the copy region
    // (qvel apart), in flight while the columns are computed: the copy
    // region then leaves as the masked reset's rows
    for (int e = warp; e < ne; e += warps) {
      if (!blk.reset(e)) continue;
      const size_t row = r0 + e;
      for (int f = 2; f < kTouchdown; ++f) {
        const int w = a.width[f];
        for (int k = lane; k < w; k += 32)
          copy4(S + L.field[f] + e * w + k, tmpl[f] + row * w + k);
      }
      for (int k = lane; k < nv; k += 32)
        copy4(S + L.tqv + e * nv + k, tmpl[1] + row * nv + k);
      const int w = a.width[kTouchdown];
      for (int k = lane; k < w; k += 32)
        Sb[4 * L.field[kTouchdown] + e * w + k] =
            static_cast<const unsigned char*>(a.tmpl[kTouchdown])[row * w + k];
    }
  }
  __syncthreads();
  clk.lap(kCopy);

  if (do_reset) {
    // 5. each column's probability, in place of its raw value: a thread a
    // column, over the envs of its group
    const ColumnDeal deal(K);
    for (int c = deal.first; deal.active() && c < K; c += deal.step) {
      const float rmax = S[L.rmax + c];
      const float mp = S[L.max_p + Si[L.col_term + c]];
      float* col = S + L.raw + c;
      // four envs at a time: their loads before their stores
      for (int e = deal.group; e < ne; e += 4 * deal.groups) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int eq = e + q * deal.groups;
          if (eq < ne) v[q] = col[eq * K];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int eq = e + q * deal.groups;
          if (eq < ne)
            col[eq * K] = v[q] > 0.f ? 0.f + clampf(v[q] / rmax, 0.f, 1.f) *
                                                 (mp - 0.f)
                                     : 0.f;
        }
      }
    }
    __syncthreads();
    // each term's maximum, the episode sums and their shares
    for_tile(ne, nt, [&](int e, int t) {
      const int c0 = Si[L.tints + kTermInts * t + 1];
      const int nc = Si[L.tints + kTermInts * t + 2];
      const float* p = S + L.raw + e * K;
      float tm = -INFINITY;
      for (int c = c0; c < c0 + nc; ++c) tm = nanmax(tm, p[c]);
      S[L.tm + e * nt + t] = tm;
      const bool rs = blk.reset(e);
      const float rf = as_float(rs);
      const float ep_len_f = clamp_min(static_cast<float>(Si[L.ep + e]), 1.f);
      const float v = S[L.ev + e * nt + t] + as_float(tm > 0.f);
      const float pr = S[L.epr + e * nt + t] + tm;
      float* sh = S + L.sh + e * P;
      sh[t] = rf * v / ep_len_f * 100.f;
      sh[nt + t] = rf * pr / ep_len_f;
      S[L.ev + e * nt + t] = rs ? 0.f : v;
      S[L.epr + e * nt + t] = rs ? 0.f : pr;
    });
  }
  copy_wait();
  __syncthreads();
  clk.lap(kColumns);

  // per-env logic: a warp's worth of envs for each of three roles
  {
    const int role = tid / E, e = tid - role * E;
    if (e < ne) {
      if (role == 0 && do_reset) blk.reward(e);
      if (role == 1 && do_reset) blk.reset_pose(e);
      if (role == 2) blk.commands(e);
    }
  }
  __syncthreads();
  clk.lap(kPerEnv);

  if (do_reset) {
    // the block's partial sums of the shares, in env order; each writer's
    // fence, then one ticket a block (the rest of the block goes on to the
    // write-back while the ticket's atomic is under way)
    if (tid < P) {
      float s = 0.f;
#pragma unroll 4
      for (int e = 0; e < ne; ++e) s += S[L.sh + e * P + tid];
      a.partials[static_cast<size_t>(blockIdx.x) * P + tid] = s;
      __threadfence();
    }
    if (a.shares) unstage_block(a.shares + r0 * P, S + L.sh, ne * P);
    __syncthreads();
    if (tid == 0)
      Si[L.last] = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  clk.lap(kFold);

  // write-back: every output as a slab of the block's rows
  unstage_all(S, a.out_rows, r0, ne);
  if (do_reset) unstage_all(S, a.copy_out, r0, ne);
  clk.lap(kWriteBack);

  // the last block to finish: the partials, a chunk of blocks at a time
  // through shared memory (from the raw region on, free by now), summed in
  // block order and added to the incoming accumulators; the ticket back to
  // 0 for the next launch
  __syncthreads();
  if (do_reset && Si[L.last]) {
    __threadfence();
    float* buf = S + L.raw;
    const int chunk = (L.words - L.raw) / P;
    const int blocks = gridDim.x;
    float s = 0.f;
    for (int b0 = 0; b0 < blocks; b0 += chunk) {
      const int nb = min(chunk, blocks - b0);
      stage_block(buf, a.partials + static_cast<size_t>(b0) * P, nb * P);
      copy_wait();
      __syncthreads();
      if (tid < P) {
#pragma unroll 8
        for (int b = 0; b < nb; ++b) s += buf[b * P + tid];
      }
      __syncthreads();
    }
    if (tid < P) {
      // the incoming accumulators, staged in the order of the shares
      const float v = S[L.acc + tid] + s;
      if (tid < nt)
        a.acc_viol_out[tid] = v;
      else if (tid < 2 * nt)
        a.acc_prob_out[tid - nt] = v;
      else if (tid == 2 * nt)
        *a.acc_rew_out = v;
      else if (tid == 2 * nt + 1)
        *a.acc_len_out = v;
      else if (tid == 2 * nt + 2)
        *a.acc_count_out = v;
      else
        a.acc_term_out[tid - 2 * nt - 3] = v;
    }
    if (tid == 0) *a.ticket = 0;
  }
  clk.lap(kFold);
}

// the dynamic shared memory `bytes` above 48 KB allowed, once a device
int allow_smem(int bytes) {
  static int allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return 0;
  err = cudaFuncSetAttribute(env_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* env_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef ENV_PHASE_CLOCKS
int env_update_set_phase_cycles(void* buf) { return set_phase_cycles(buf); }
#endif

// Blocks of the kernel an SM holds at `threads` threads and `smem` bytes
// of shared memory a block (the occupancy calculator), or -1.
int env_update_blocks_per_sm(int threads, int smem) {
  if (allow_smem(smem) != 0) return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, env_update_kernel, threads, smem) == cudaSuccess
             ? n
             : -1;
}

// Launch over the arguments of UpdateArgs, in its order (the arrays sim,
// tmpl, out and width field by field, the heightfield's fields after
// width), on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a wrong count, shape or geometry).
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
  a.col_term = r.ptr<const int>();
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
  a.acc_viol = r.ptr<const float>();
  a.acc_prob = r.ptr<const float>();
  a.acc_rew = r.ptr<const float>();
  a.acc_len = r.ptr<const float>();
  a.acc_count = r.ptr<const float>();
  a.acc_term = r.ptr<const float>();
  a.running_max_out = r.ptr<float>();
  a.max_p_out = r.ptr<float>();
  a.reward = r.ptr<float>();
  a.dones = r.ptr<float>();
  a.episode_viol_out = r.ptr<float>();
  a.episode_prob_out = r.ptr<float>();
  a.episode_rew_out = r.ptr<float>();
  a.episode_len_out = r.ptr<int>();
  a.action_out = r.ptr<float>();
  a.prev_action_out = r.ptr<float>();
  a.command_out = r.ptr<float>();
  a.time_left_out = r.ptr<float>();
  a.origin_out = r.ptr<float>();
  a.terrain_row_out = r.ptr<int>();
  for (int f = 0; f < kFields; ++f) a.out[f] = r.ptr<void>();
  a.acc_viol_out = r.ptr<float>();
  a.acc_prob_out = r.ptr<float>();
  a.acc_rew_out = r.ptr<float>();
  a.acc_len_out = r.ptr<float>();
  a.acc_count_out = r.ptr<float>();
  a.acc_term_out = r.ptr<float>();
  a.partials = r.ptr<float>();
  a.ticket = r.ptr<int>();
  a.shares = r.ptr<float>();
  a.n = r.in();
  a.envs = r.in();
  a.threads = r.in();
  a.smem_bytes = r.in();
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
  const bool reset_part = a.part & kPartReset, cmd_part = a.part & kPartCommands;
  const UpdateLayout L(a);
  const int K = a.n_cols, nt = a.n_terms, nj = a.nj, P = a.shares_width();
  a.in.add(a.time_out, L.to, 1, kSlabBytes);
  a.in.add(a.illegal, L.il, 1, kSlabBytes);
  a.in.add(a.upside, L.up, 1, kSlabBytes);
  a.in.add(a.command, L.cmd, 3);
  a.in.add(a.sim[1], L.qvel, a.width[1]);
  if (reset_part) {
    a.in.add(a.running_max, L.rm_in, K, kSlabTable);
    a.in.add(a.col_max, L.cm, K, kSlabTable);
    a.in.add(a.init_max_p, L.init_p, nt, kSlabTable);
    a.in.add(a.is_cur, L.is_cur, nt, kSlabTable | kSlabBytes);
    a.in.add(a.term_ints, L.tints, kTermInts * nt, kSlabTable);
    a.in.add(a.col_term, L.col_term, K, kSlabTable);
    a.in.add(a.qj_default, L.qj_default, nj, kSlabTable);
    a.in.add(a.qj_lower, L.qj_lower, nj, kSlabTable);
    a.in.add(a.qj_upper, L.qj_upper, nj, kSlabTable);
    a.in.add(a.common_step, L.cs, 1, kSlabTable);
    // the incoming accumulators, in the order of the shares
    a.in.add(a.acc_viol, L.acc, nt, kSlabTable);
    a.in.add(a.acc_prob, L.acc + nt, nt, kSlabTable);
    a.in.add(a.acc_rew, L.acc + 2 * nt, 1, kSlabTable);
    a.in.add(a.acc_len, L.acc + 2 * nt + 1, 1, kSlabTable);
    a.in.add(a.acc_count, L.acc + 2 * nt + 2, 1, kSlabTable);
    a.in.add(a.acc_term, L.acc + 2 * nt + 3, 3, kSlabTable);
    a.in.add(a.raw, L.raw, K);
    a.in.add(a.episode_len, L.ep, 1);
    a.in.add(a.episode_viol, L.ev, nt);
    a.in.add(a.episode_prob, L.epr, nt);
    a.in.add(a.episode_rew, L.erew, 1);
    a.in.add(a.origin, L.org, 2);
    a.in.add(a.terrain_row, L.trow, 1);
    a.in.add(a.terrain_col, L.tcol, 1);
    a.in.add(a.action, L.act, nj);
    a.in.add(a.prev_action, L.pact, nj);
    a.in.add(a.sim[0], L.qpos, a.width[0]);
    for (int f = 2; f < kFields; ++f) {
      const int kind = f == kTouchdown ? kSlabBytes : 0;
      a.in.add(a.sim[f], L.field[f], a.width[f], kind);
      a.copy_out.add(a.out[f], L.field[f], a.width[f], kind);
    }
    a.in.add(a.u_reset, L.u_reset, 3 + nj);
    a.out_rows.add(a.reward, L.rew, 1);
    a.out_rows.add(a.dones, L.don, 1);
    a.out_rows.add(a.episode_viol_out, L.ev, nt);
    a.out_rows.add(a.episode_prob_out, L.epr, nt);
    a.out_rows.add(a.episode_rew_out, L.erew, 1);
    a.out_rows.add(a.episode_len_out, L.ep_out, 1);
    a.out_rows.add(a.action_out, L.act, nj);
    a.out_rows.add(a.prev_action_out, L.pact, nj);
    a.out_rows.add(a.origin_out, L.org, 2);
    a.out_rows.add(a.terrain_row_out, L.trow, 1);
    a.out_rows.add(a.out[0], L.qpos_out, a.width[0]);
  }
  if (cmd_part) {
    a.in.add(a.time_left, L.tl, 1);
    a.in.add(a.u_reset_cmd, L.u_rcmd, 4);
    a.in.add(a.u_expired_cmd, L.u_ecmd, 4);
    a.in.add(a.u_resample, L.u_res, 1);
    a.in.add(a.u_resample_cmd, L.u_rescmd, 4);
    a.in.add(a.u_flip, L.u_flip, 1);
    if (a.push) {
      a.in.add(a.u_push, L.u_push, 1);
      a.in.add(a.push_vel, L.push_vel, 2);
    }
    a.out_rows.add(a.command_out, L.cmd_out, 3);
    a.out_rows.add(a.time_left_out, L.tl_out, 1);
  }
  a.out_rows.add(a.out[1], L.qvel_out, a.width[1]);
  if (a.in.full || a.copy_out.full || a.out_rows.full || !r.exact() || a.n < 0 || a.part < 1 || a.part > 3 || a.n_terms < 0 ||
      a.envs < 1 || a.threads < 3 * a.envs || a.threads > kBlockThreads ||
      a.threads % 32 != 0 || P > a.threads || L.words - L.raw < P ||
      a.width[0] != 7 + a.nj || a.width[1] < 6 ||
      (a.hfield != nullptr && (a.hf.rows < 2 || a.hf.cols < 2)) ||
      (reset_part && (a.partials == nullptr || a.ticket == nullptr)) ||
      a.smem_bytes != 4 * L.words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int err = allow_smem(a.smem_bytes);
  if (err != 0) return err;
  const int grid = (a.n + a.envs - 1) / a.envs;
  env_update_kernel<<<grid, a.threads, a.smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
