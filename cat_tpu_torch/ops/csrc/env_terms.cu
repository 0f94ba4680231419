// The env step's first stage after the physics: the episode and common
// counters, the terminations (time out, an illegal contact in the force
// history, upside down), the raw constraint matrix (N, columns) of the
// task's terms in their column order, and each column's maximum over envs,
// clamped to >= 1e-6.
//
// Replaces no Pallas kernel: with env_update.cu and env_obs.cu it is the
// counterpart of what XLA fuses of the JAX package's CatEnv.step
// (cat_tpu/envs/env.py:492-683; this kernel :514-541, with
// envs/cat.py ConstraintSet.compute's raw columns and the 15 term
// functions of envs/constraints.py). Its plain version is envs/env.py
// CatEnv.terms_stage.
//
// Bound: the bytes of each env's rows (measure.env_counts; 4.03 MB at
// Solo12's 4096 envs, 1.2 us at 3.35 TB/s), far above its operations'. A
// launch is short, so what it costs is round trips to memory and the
// instructions between them. The design (ops/env_step.py env_geometry
// sizes it): a block owns `envs` consecutive envs, so that 4096 envs fill
// the card in one wave, and
//   staging: every input of the block is one contiguous slab of its rows,
//     and every slab is copied into shared memory at once (env_model.cuh
//     stage_all over the slabs the launch function lists: cp.async, 16
//     bytes a copy), one round trip in all; the force
//     history is staged whole (the slots no term reads share their 32-byte
//     sectors with slots that are read);
//   per-env logic: each staged report slot's history norm, once an env (a
//     thread an env and slot, hist_norm's order), and the slots in contact
//     (norm > 1 N) as a 64-bit mask; a thread an env: the projected
//     gravity, the command's norm, the counters and the three flags;
//   columns: term by term, so the kind is the same in every thread (a
//     branch an entry on its column's kind, through a jump table, with the
//     lanes of a warp on several kinds, cost this kernel's first version
//     half its time), the block's threads take the term's (env, column)
//     entries in turn and evaluate each from shared memory by its row of
//     the column table (envs/cat.py column_table: kind, the joint, foot or
//     staged slot it reads, the term's two floats); a given column
//     comes from the given block (a term of its own PyTorch function,
//     ops/env_step.py); contact and n_foot_contact read the contact mask
//     and their slots' mask;
//   maxima: a thread a column takes the block's maximum of the clamped
//     values' bits and folds it into col_max with one atomicMax. The raw
//     value clamped to >= 1e-6 is positive, and a positive float orders
//     like its bits as an unsigned int, so the maximum is exact and the
//     same on every run; a NaN is written as 0x7fffffff, the largest, so a
//     column with a NaN comes out NaN, as torch.amax gives it. col_max is
//     zeroed by the caller on the stream (a memset inside the step's CUDA
//     graph);
//   write-back: the block's raw rows leave as one slab.
//
// Layout: envs leading and contiguous; qpos (N, nq), qvel (N, nv),
// joint_acc and applied_torque (N, nj) in the model's joint order,
// force_hist (N, 9 nreport) as (N, 3, nreport, 3), touchdown (N, nfeet)
// bytes, last_air_time (N, nfeet), command (N, 3), action and prev_action
// (N, nj) in task order, the episode counter (N) and the common counter
// () int32, the default joint positions (nj, task order), the column table
// (columns, 3) int32 and (columns, 2) float32, the staged report slots and
// the illegal ones' places among them, the given block (N, given) or null;
// outputs episode_len (N) and common_step () int32, time_out, illegal and
// upside (N) bytes, raw (N, columns), col_max (columns) as uint32 bits.

#include "env_model.cuh"

namespace {

using namespace envk;

// the phases of the phase-clock build (ops/env_step.py
// EnvTermsKernel.phases)
enum Phase { kStaging, kPerEnv, kColumns, kMaxima, kWriteBack };

struct TermsArgs {
  const float *qpos, *qvel, *joint_acc, *applied_torque, *force_hist;
  const unsigned char* touchdown;
  const float *last_air_time, *command, *action, *prev_action;
  const int *episode_len, *common_step;
  const float* default_joint_pos;
  const int *term_ints, *col_ints;
  const float* col_floats;
  const int *slots, *illegal_places;
  const float* given;
  int *episode_len_out, *common_step_out;
  unsigned char *time_out, *illegal, *upside;
  float* raw;
  unsigned* col_max;
  int n, envs, threads, smem_bytes, nq, nv, nj, nreport, nfeet, n_slots,
      n_illegal, n_terms, n_cols, n_given, max_episode_length;
  float contact_threshold, upside_limit, inv_step_dt;
  Slabs<24> in;   // what a block stages (the launch function lists it)
};

// the block's shared memory, region by region (word offsets; ops/env_step.py
// env_geometry counts the same)
struct TermsLayout {
  int tint, cint, cflt, djp, slots, illegal, qpos, qvel, acc, tq, hist, air,
      cmd, act, pact, given, ep, td, norms, vals, mask, raw, words;
  __host__ __device__ explicit TermsLayout(const TermsArgs& a) {
    Layout l;
    const int E = a.envs;
    tint = l.take(kTermInts * a.n_terms);
    cint = l.take(3 * a.n_cols);
    cflt = l.take(2 * a.n_cols);
    djp = l.take(a.nj);
    slots = l.take(a.n_slots);
    illegal = l.take(a.n_illegal);
    qpos = l.take(E * a.nq);
    qvel = l.take(E * a.nv);
    acc = l.take(E * a.nj);
    tq = l.take(E * a.nj);
    hist = l.take(E * 9 * a.nreport);
    air = l.take(E * a.nfeet);
    cmd = l.take(E * 3);
    act = l.take(E * a.nj);
    pact = l.take(E * a.nj);
    given = l.take(E * a.n_given);
    ep = l.take(E);
    td = l.take_bytes(E * a.nfeet);
    norms = l.take(E * a.n_slots);
    vals = l.take(E * 4);    // g.z, |g_xy|, |command|
    mask = l.take(E * 2);    // the slots in contact, 64 bits
    raw = l.take(E * a.n_cols);
    words = l.words;
  }
};

// the bits that order a column's values: max(x, 1e-6) (a NaN as
// 0x7fffffff)
__device__ __forceinline__ unsigned max_bits(float x) {
  return isnan(x) ? 0x7fffffffu : __float_as_uint(clamp_min(x, 1e-6f));
}

__global__ void __launch_bounds__(kBlockThreads)
    env_terms_kernel(const TermsArgs a) {
  extern __shared__ __align__(16) float terms_smem[];
  const TermsLayout L(a);
  float* S = terms_smem;
  int* Si = reinterpret_cast<int*>(terms_smem);
  unsigned char* Sb = reinterpret_cast<unsigned char*>(terms_smem);
  PhaseClock clk;
  const int tid = threadIdx.x, E = a.envs, K = a.n_cols, ns = a.n_slots;
  const int nq = a.nq, nv = a.nv, nj = a.nj, nr = a.nreport, nf = a.nfeet;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, a.n - e0);
  const size_t r0 = static_cast<size_t>(e0);

  // staging: the tables and the block's slabs, all in flight at once
  stage_all(S, a.in, r0, ne);
  copy_wait();
  __syncthreads();
  clk.lap(kStaging);

  // per-env logic: each staged slot's history norm once an env; each env's
  // gravity, command norm and counters (3-4)
  for_tile(ne, ns, [&](int e, int s) {
    S[L.norms + e * ns + s] = hist_norm(S + L.hist + e * 9 * nr, nr,
                                        Si[L.slots + s]);
  });
  if (tid < ne) {
    const float* qp = S + L.qpos + tid * nq;
    const float* cmd = S + L.cmd + tid * 3;
    const float q[4] = {qp[3], qp[4], qp[5], qp[6]};
    const V3 g = quat_rotate_inv(q, {0.f, 0.f, -1.f});
    float* v = S + L.vals + 4 * tid;
    v[0] = g.z;
    v[1] = norm2(g.x, g.y);
    v[2] = norm3(cmd[0], cmd[1], cmd[2]);
    const int ep = Si[L.ep + tid] + 1;
    a.episode_len_out[e0 + tid] = ep;
    a.time_out[e0 + tid] = ep >= a.max_episode_length;
  }
  if (blockIdx.x == 0 && tid == 0) *a.common_step_out = *a.common_step + 1;
  __syncthreads();
  // 4. the illegal contacts, upside down; the slots in contact
  if (tid < ne) {
    const float* nrm = S + L.norms + tid * ns;
    bool ill = false;
    for (int i = 0; i < a.n_illegal; ++i)
      ill |= nrm[Si[L.illegal + i]] > a.contact_threshold;
    unsigned long long in = 0;
    for (int s = 0; s < ns; ++s)
      if (nrm[s] > 1.f) in |= 1ull << s;
    Si[L.mask + 2 * tid] = static_cast<int>(in & 0xffffffffu);
    Si[L.mask + 2 * tid + 1] = static_cast<int>(in >> 32);
    a.illegal[e0 + tid] = ill;
    a.upside[e0 + tid] = S[L.vals + 4 * tid + 1] > a.upside_limit;
  }
  __syncthreads();
  clk.lap(kPerEnv);

  // 5. the raw constraint columns, term by term: the kind is the same in
  // every thread, and the block's threads take the term's (env, column)
  // entries in turn, each column's ids from its row of the column table
  for (int t = 0; t < a.n_terms; ++t) {
    const int c0 = Si[L.tint + kTermInts * t + 1];
    const int nc = Si[L.tint + kTermInts * t + 2];
    const int kind = Si[L.cint + 3 * c0];
    const float p0 = S[L.cflt + 2 * c0], p1 = S[L.cflt + 2 * c0 + 1];
    // the entries' values: value(e, a, b) of env e, the column's ids a, b
    auto each = [&](auto value) {
      for_tile(ne, nc, [&](int e, int j) {
        const int c = c0 + j;
        S[L.raw + e * K + c] =
            value(e, Si[L.cint + 3 * c + 1], Si[L.cint + 3 * c + 2]);
      });
    };
    auto cmd_norm = [&](int e) { return S[L.vals + 4 * e + 2]; };
    // the env's slots in contact among the column's (a mask in ia, ib)
    auto contact = [&](int e, int ia, int ib) {
      return (static_cast<unsigned>(Si[L.mask + 2 * e]) |
              static_cast<unsigned long long>(
                  static_cast<unsigned>(Si[L.mask + 2 * e + 1]))
                  << 32) &
             (static_cast<unsigned>(ia) |
              static_cast<unsigned long long>(static_cast<unsigned>(ib))
                  << 32);
    };
    switch (kind) {
      case kJointPosition:
        each([&](int e, int ia, int) {
          return fabsf(S[L.qpos + e * nq + ia]) - p0;
        });
        break;
      case kJointPositionMovingForward:
        each([&](int e, int ia, int ib) {
          return (fabsf(S[L.qpos + e * nq + ia] - S[L.djp + ib]) - p0) *
                 as_float(fabsf(S[L.cmd + e * 3 + 1]) < p1);
        });
        break;
      case kJointTorque:
        each([&](int e, int ia, int) {
          return fabsf(S[L.tq + e * nj + ia]) - p0;
        });
        break;
      case kJointVelocity:
        each([&](int e, int ia, int) {
          return fabsf(S[L.qvel + e * nv + ia]) - p0;
        });
        break;
      case kJointAcceleration:
        each([&](int e, int ia, int) {
          return fabsf(S[L.acc + e * nj + ia]) - p0;
        });
        break;
      case kUpsideDown:
        each([&](int e, int, int) { return as_float(S[L.vals + 4 * e] > p0); });
        break;
      case kContact:
        each([&](int e, int ia, int ib) {
          return as_float(contact(e, ia, ib) != 0);
        });
        break;
      case kBaseOrientation:
        each([&](int e, int, int) { return S[L.vals + 4 * e + 1] - p0; });
        break;
      case kAirTime:
        each([&](int e, int ia, int) {
          return ((p0 - S[L.air + e * nf + ia]) *
                  as_float(Sb[4 * L.td + e * nf + ia] != 0)) *
                 as_float(cmd_norm(e) > p1);
        });
        break;
      case kNFootContact:
        each([&](int e, int ia, int ib) {
          return fabsf(static_cast<float>(__popcll(contact(e, ia, ib))) -
                       p0) *
                 as_float(cmd_norm(e) > p1);
        });
        break;
      case kJointRange:
        each([&](int e, int ia, int ib) {
          return fabsf(S[L.qpos + e * nq + ia] - S[L.djp + ib]) - p0;
        });
        break;
      case kActionRate:
        each([&](int e, int ia, int) {
          return fabsf(S[L.act + e * nj + ia] - S[L.pact + e * nj + ia]) *
                     a.inv_step_dt -
                 p0;
        });
        break;
      case kFootContactForce:
        each([&](int e, int ia, int) { return S[L.norms + e * ns + ia] - p0; });
        break;
      case kMinBaseHeight:
        each([&](int e, int, int) { return p0 - S[L.qpos + e * nq + 2]; });
        break;
      case kNoMove:
        each([&](int e, int ia, int) {
          return (fabsf(S[L.qvel + e * nv + ia]) - p0) *
                 as_float(cmd_norm(e) < p1);
        });
        break;
      default:  // kGiven
        each([&](int e, int ia, int) {
          return S[L.given + e * a.n_given + ia];
        });
    }
  }
  __syncthreads();
  clk.lap(kColumns);

  // each column's maximum over the block's envs, one atomicMax a column
  for (int c = tid; c < K; c += blockDim.x) {
    unsigned m = 0u;
    for (int e = 0; e < ne; ++e) m = max(m, max_bits(S[L.raw + e * K + c]));
    atomicMax(a.col_max + c, m);
  }
  clk.lap(kMaxima);

  unstage_block(a.raw + r0 * K, S + L.raw, ne * K);
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
  err = cudaFuncSetAttribute(env_terms_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* env_terms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef ENV_PHASE_CLOCKS
int env_terms_set_phase_cycles(void* buf) { return set_phase_cycles(buf); }
#endif

// Blocks of the kernel an SM holds at `threads` threads and `smem` bytes
// of shared memory a block (the occupancy calculator), or -1.
int env_terms_blocks_per_sm(int threads, int smem) {
  if (allow_smem(smem) != 0) return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, env_terms_kernel, threads, smem) == cudaSuccess
             ? n
             : -1;
}

// Launch over the arguments of TermsArgs, in its order, on `stream` (a
// cudaStream_t of the current device); returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a wrong count, shape or geometry).
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
  a.default_joint_pos = r.ptr<const float>();
  a.term_ints = r.ptr<const int>();
  a.col_ints = r.ptr<const int>();
  a.col_floats = r.ptr<const float>();
  a.slots = r.ptr<const int>();
  a.illegal_places = r.ptr<const int>();
  a.given = r.ptr<const float>();
  a.episode_len_out = r.ptr<int>();
  a.common_step_out = r.ptr<int>();
  a.time_out = r.ptr<unsigned char>();
  a.illegal = r.ptr<unsigned char>();
  a.upside = r.ptr<unsigned char>();
  a.raw = r.ptr<float>();
  a.col_max = r.ptr<unsigned>();
  a.n = r.in();
  a.envs = r.in();
  a.threads = r.in();
  a.smem_bytes = r.in();
  a.nq = r.in();
  a.nv = r.in();
  a.nj = r.in();
  a.nreport = r.in();
  a.nfeet = r.in();
  a.n_slots = r.in();
  a.n_illegal = r.in();
  a.n_terms = r.in();
  a.n_cols = r.in();
  a.n_given = r.in();
  a.max_episode_length = r.in();
  a.contact_threshold = r.fl();
  a.upside_limit = r.fl();
  a.inv_step_dt = r.fl();
  const TermsLayout L(a);
  const int K = a.n_cols, nj = a.nj;
  a.in.add(a.term_ints, L.tint, kTermInts * a.n_terms, kSlabTable);
  a.in.add(a.col_ints, L.cint, 3 * K, kSlabTable);
  a.in.add(a.col_floats, L.cflt, 2 * K, kSlabTable);
  a.in.add(a.default_joint_pos, L.djp, nj, kSlabTable);
  a.in.add(a.slots, L.slots, a.n_slots, kSlabTable);
  a.in.add(a.illegal_places, L.illegal, a.n_illegal, kSlabTable);
  a.in.add(a.qpos, L.qpos, a.nq);
  a.in.add(a.qvel, L.qvel, a.nv);
  a.in.add(a.joint_acc, L.acc, nj);
  a.in.add(a.applied_torque, L.tq, nj);
  a.in.add(a.force_hist, L.hist, 9 * a.nreport);
  a.in.add(a.last_air_time, L.air, a.nfeet);
  a.in.add(a.command, L.cmd, 3);
  a.in.add(a.action, L.act, nj);
  a.in.add(a.prev_action, L.pact, nj);
  a.in.add(a.given, L.given, a.n_given);
  a.in.add(a.episode_len, L.ep, 1);
  a.in.add(a.touchdown, L.td, a.nfeet, kSlabBytes);
  if (a.in.full || !r.exact() || a.n < 0 || a.envs < 1 || a.threads < a.envs ||
      a.threads > kBlockThreads || a.threads % 32 != 0 || a.nq < 7 ||
      a.nv < 6 || a.nj < 0 || a.nreport < 1 || a.n_slots < 0 ||
      a.n_slots > kMaxSlots || a.n_cols < 0 ||
      a.smem_bytes != 4 * L.words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int err = allow_smem(a.smem_bytes);
  if (err != 0) return err;
  const int grid = (a.n + a.envs - 1) / a.envs;
  env_terms_kernel<<<grid, a.threads, a.smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
