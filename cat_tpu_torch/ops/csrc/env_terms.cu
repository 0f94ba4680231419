// The env step's first stage after the physics, one thread an env: the
// episode and common counters, the terminations (time out, an illegal
// contact in the force history, upside down), the raw constraint matrix
// (N, columns) of the task's terms in their column order, and each
// column's maximum over envs, clamped to >= 1e-6.
//
// Replaces no Pallas kernel: with env_update.cu and env_obs.cu it is the
// counterpart of what XLA fuses of the JAX package's CatEnv.step
// (cat_tpu/envs/env.py:492-683; this kernel :514-541, with
// envs/cat.py ConstraintSet.compute's raw columns and the 15 term
// functions of envs/constraints.py). Its plain version is envs/env.py
// CatEnv.terms_stage.
//
// The terms come from a descriptor table (envs/cat.py term_table): each
// term's kind, column span, two float parameters and its joint, body or
// foot ids. A term of kind kGiven was computed by its own PyTorch function
// (ops/env_step.py) and its columns are copied from the given block.
//
// The column maxima: the raw value clamped to >= 1e-6 is positive, and a
// positive float orders like its bits as an unsigned int, so each warp
// takes the maximum of its lanes' bits (__reduce_max_sync) and one
// atomicMax a warp and column folds it into the zeroed (columns,) buffer:
// the maximum is exact and the same on every run. A NaN is written as
// 0x7fffffff, the largest, so a column with a NaN comes out NaN, as
// torch.amax gives it. The buffer is zeroed by the caller on the stream
// (a memset inside the step's CUDA graph).
//
// Layout: envs leading and contiguous; qpos (N, nq), qvel (N, nv),
// joint_acc and applied_torque (N, nj) in the model's joint order, t2m
// (nj) the task order's model joints, force_hist (N, 9 nreport) as (N, 3,
// nreport, 3), touchdown (N, nfeet) bytes, last_air_time (N, nfeet),
// command (N, 3), action and prev_action (N, nj) in task order, the
// episode counter (N) and the common counter () int32; outputs
// episode_len (N) and common_step () int32, time_out, illegal and upside
// (N) bytes, raw (N, columns), col_max (columns) as uint32 bits.

#include "env_model.cuh"

namespace {

using namespace envk;

struct TermsArgs {
  const float *qpos, *qvel, *joint_acc, *applied_torque, *force_hist;
  const unsigned char* touchdown;
  const float *last_air_time, *command, *action, *prev_action;
  const int *episode_len, *common_step, *t2m;
  const float* default_joint_pos;
  const int *illegal_ids, *term_ints;
  const float* term_floats;
  const int* term_ids;
  const float* given;
  int *episode_len_out, *common_step_out;
  unsigned char *time_out, *illegal, *upside;
  float* raw;
  unsigned* col_max;
  int n, nq, nv, nj, nreport, nfeet, n_illegal, n_terms, n_cols, n_given,
      max_episode_length;
  float contact_threshold, upside_limit, inv_step_dt;
};

// the bits that order a column's values: max(x, 1e-6) (a NaN as
// 0x7fffffff)
__device__ __forceinline__ unsigned max_bits(float x) {
  return isnan(x) ? 0x7fffffffu : __float_as_uint(clamp_min(x, 1e-6f));
}

__global__ void __launch_bounds__(kThreads)
    env_terms_kernel(const TermsArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < a.n;
  // a lane past the last env reads env 0 and writes nothing: every lane of
  // a warp takes part in its column maxima
  const int r = live ? e : 0;
  const int lane = threadIdx.x & 31;

  // 3. counters
  const int ep = a.episode_len[r] + 1;
  if (e == 0) *a.common_step_out = *a.common_step + 1;

  // the step's data (CatEnv.step_data)
  const float* qp = a.qpos + static_cast<size_t>(r) * a.nq;
  const float* qv = a.qvel + static_cast<size_t>(r) * a.nv;
  const float* qa = a.joint_acc + static_cast<size_t>(r) * a.nj;
  const float* tq = a.applied_torque + static_cast<size_t>(r) * a.nj;
  const float* fh = a.force_hist + static_cast<size_t>(r) * 9 * a.nreport;
  const unsigned char* td = a.touchdown + static_cast<size_t>(r) * a.nfeet;
  const float* air = a.last_air_time + static_cast<size_t>(r) * a.nfeet;
  const float* cmd = a.command + static_cast<size_t>(r) * 3;
  const float* act = a.action + static_cast<size_t>(r) * a.nj;
  const float* pact = a.prev_action + static_cast<size_t>(r) * a.nj;
  const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
  const V3 g = quat_rotate_inv(q, {0.f, 0.f, -1.f});
  const float cmd_norm = norm3(cmd[0], cmd[1], cmd[2]);

  // 4. terminations
  bool ill = false;
  for (int i = 0; i < a.n_illegal; ++i)
    ill |= hist_norm(fh, a.nreport, a.illegal_ids[i]) > a.contact_threshold;
  if (live) {
    a.episode_len_out[e] = ep;
    a.time_out[e] = ep >= a.max_episode_length;
    a.illegal[e] = ill;
    a.upside[e] = norm2(g.x, g.y) > a.upside_limit;
  }

  // 5. the raw constraint columns, term by term (the loop is the same in
  // every lane: the warp's maxima below need all 32)
  float* raw = a.raw + static_cast<size_t>(r) * a.n_cols;
  for (int t = 0; t < a.n_terms; ++t) {
    const int* ti = a.term_ints + t * kTermInts;
    const int kind = ti[0], c0 = ti[1], nc = ti[2], first = ti[3],
              nids = ti[4];
    const float p0 = a.term_floats[2 * t], p1 = a.term_floats[2 * t + 1];
    const int* ids = a.term_ids + first;
    // the one-column terms over all their ids
    float single = 0.f;
    if (kind == kContact || kind == kNFootContact) {
      int count = 0;
      bool any = false;
      for (int k = 0; k < nids; ++k) {
        const bool in = hist_norm(fh, a.nreport, ids[k]) > 1.f;
        count += in;
        any |= in;
      }
      single = kind == kContact
                   ? as_float(any)
                   : fabsf(static_cast<float>(count) - p0) *
                         as_float(cmd_norm > p1);
    }
    for (int c = 0; c < nc; ++c) {
      // the column's id: a task-order joint (its model joint a.t2m[id]),
      // a report slot or a foot
      const int id = c < nids ? ids[c] : 0;
      float v;
      switch (kind) {
        case kJointPosition:
          v = fabsf(qp[7 + a.t2m[id]]) - p0;
          break;
        case kJointPositionMovingForward:
          v = (fabsf(qp[7 + a.t2m[id]] - a.default_joint_pos[id]) - p0) *
              as_float(fabsf(cmd[1]) < p1);
          break;
        case kJointTorque:
          v = fabsf(tq[a.t2m[id]]) - p0;
          break;
        case kJointVelocity:
          v = fabsf(qv[6 + a.t2m[id]]) - p0;
          break;
        case kJointAcceleration:
          v = fabsf(qa[a.t2m[id]]) - p0;
          break;
        case kUpsideDown:
          v = as_float(g.z > p0);
          break;
        case kBaseOrientation:
          v = norm2(g.x, g.y) - p0;
          break;
        case kAirTime:
          v = ((p0 - air[id]) * as_float(td[id] != 0)) *
              as_float(cmd_norm > p1);
          break;
        case kJointRange:
          v = fabsf(qp[7 + a.t2m[id]] - a.default_joint_pos[id]) - p0;
          break;
        case kActionRate:
          v = fabsf(act[id] - pact[id]) * a.inv_step_dt - p0;
          break;
        case kFootContactForce:
          v = hist_norm(fh, a.nreport, id) - p0;
          break;
        case kMinBaseHeight:
          v = p0 - qp[2];
          break;
        case kNoMove:
          v = (fabsf(qv[6 + a.t2m[id]]) - p0) * as_float(cmd_norm < p1);
          break;
        case kGiven:
          v = a.given[static_cast<size_t>(r) * a.n_given + first + c];
          break;
        default:  // kContact, kNFootContact
          v = single;
      }
      if (live) raw[c0 + c] = v;
      const unsigned bits =
          __reduce_max_sync(0xffffffffu, live ? max_bits(v) : 0u);
      if (lane == 0) atomicMax(a.col_max + c0 + c, bits);
    }
  }
}

}  // namespace

extern "C" {

const char* env_terms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch over the arguments of TermsArgs, in its order, on `stream` (a
// cudaStream_t of the current device); returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a wrong count or shape).
int env_terms_launch(void* const* p, const int* iv, const float* fv, int np,
                     int ni, int nf, void* stream) {
  ArgReader r{p, iv, fv, np, ni, nf};
  TermsArgs a;
  a.qpos = r.ptr<const float>();
  a.qvel = r.ptr<const float>();
  a.joint_acc = r.ptr<const float>();
  a.applied_torque = r.ptr<const float>();
  a.force_hist = r.ptr<const float>();
  a.touchdown = r.ptr<const unsigned char>();
  a.last_air_time = r.ptr<const float>();
  a.command = r.ptr<const float>();
  a.action = r.ptr<const float>();
  a.prev_action = r.ptr<const float>();
  a.episode_len = r.ptr<const int>();
  a.common_step = r.ptr<const int>();
  a.t2m = r.ptr<const int>();
  a.default_joint_pos = r.ptr<const float>();
  a.illegal_ids = r.ptr<const int>();
  a.term_ints = r.ptr<const int>();
  a.term_floats = r.ptr<const float>();
  a.term_ids = r.ptr<const int>();
  a.given = r.ptr<const float>();
  a.episode_len_out = r.ptr<int>();
  a.common_step_out = r.ptr<int>();
  a.time_out = r.ptr<unsigned char>();
  a.illegal = r.ptr<unsigned char>();
  a.upside = r.ptr<unsigned char>();
  a.raw = r.ptr<float>();
  a.col_max = r.ptr<unsigned>();
  a.n = r.in();
  a.nq = r.in();
  a.nv = r.in();
  a.nj = r.in();
  a.nreport = r.in();
  a.nfeet = r.in();
  a.n_illegal = r.in();
  a.n_terms = r.in();
  a.n_cols = r.in();
  a.n_given = r.in();
  a.max_episode_length = r.in();
  a.contact_threshold = r.fl();
  a.upside_limit = r.fl();
  a.inv_step_dt = r.fl();
  if (!r.exact() || a.n < 0 || a.nq < 7 || a.nv < 6 || a.nj < 0 ||
      a.nreport < 1 || a.n_terms < 0 || a.n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int grid = (a.n + kThreads - 1) / kThreads;
  env_terms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
