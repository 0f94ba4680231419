// The post stage of one physics substep, one warp per env: the contact
// impulses applied (v = v_free + W lam), semi-implicit Euler with the
// quaternion exponential map and the joint-limit clamp, the net contact
// force of each report slot and their 3-deep history, and the feet's air
// and contact times.
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// lanes post stage (cat_tpu/sim/engine_lanes.py:131 _substep_post_lanes),
// which XLA fused into a few full-width passes on the TPU. Its plain
// version is sim/engine.py post_stage, ~60 PyTorch operations a substep,
// three of them batched products (W lam, the frames' impulses into the
// world, the report matrix's product).
//
// What bounds it on an H100: the bytes it must read, and W dominates them.
// Per env at Solo12's shape it reads W (18 x 108 floats, 7.8 KB), lam, the
// frames, the state it updates (~3.4 KB in all besides W) and writes ~0.9
// KB: at N = 4096 about 46 MB, 0.014 ms at 3.35 TB/s when every column of
// W is read. The design:
//   * lam's entries are exactly 0 for every inactive contact (the PGS
//     kernels keep them there, pgs_vspace.cuh); the column of W such an
//     entry multiplies is never read, nor the contact's frame. W * 0 is
//     +-0, and adding +-0 to a sum that starts at +0 changes no bit, so
//     the skip changes nothing but the bytes read;
//   * W is read coalesced: a row of W (one dof, 3nc contiguous floats) by
//     the whole warp, lane l its columns l, l + 32, ... against the
//     warp's lam kept in registers, then a butterfly of shuffles sums the
//     lanes' parts, and lane k keeps dof k's;
//   * a lane a dof integrates (lane 3 the base's quaternion), a lane a
//     contact turns its impulse into the world and into a force, a lane a
//     report slot's component sums its contacts by the packed index table
//     (ops/substep.py pack_post) in a fixed order, a lane a foot updates
//     its times; the outputs leave in lane-strided (coalesced) stores.
// The two decisions that compare a float with a limit round their
// deciding quantity as the plain version does: the joint's new angle is a
// multiply then an add (no contracted FMA), the foot's force norm squares
// and sums op by op. Their inputs, v and the forces, still sum in another
// order than cuBLAS or the CPU, so a quantity within a few float32
// spacings of its limit may decide the other way (chip_smoke.py counts
// them). The summation order is fixed and no atomics are used: a launch is
// deterministic bit for bit. 44 registers, no spills, 10 blocks an SM:
// 4096 envs in one wave. Measured (chip_smoke.py kernel-post, H100 80GB
// HBM3 at 700 W): 0.0227 ms on the flat env's states, where 2.85 of 36
// contacts an env hold an impulse (11.4 MB to read: 15% of that bound, 60%
// of the bound with every column of W); the plain version 0.379 ms as a
// graph replay. Not measured yet: what holds it above the bound; each
// warp walks W's rows one after another, a shuffle butterfly each, so
// latency rather than bytes is the first suspect.
//
// Layout: envs leading and contiguous: qpos (N, nq), qvel (N, nv), v_free
// (N, nv), W (N, nv, 3nc), lam (N, 3nc), frame (N, nc, 3, 3) or null (the
// world frame), force_hist (N, 9 nreport), the four air fields (N, nfeet),
// touchdown (N, nfeet) bytes; the outputs the same, joint_acc (N, nj),
// forces (N, 3 nreport). nv <= 32, nc <= 64, nfeet <= 32.
//
// The tables (ops/substep.py pack_post), one float and one int table:
//   floats: joint_lower (nj), joint_upper (nj)
//   ints:   foot (nfeet: each foot's report slot), start (nreport + 1: the
//           first entry of each slot), entry (nct + 2 npair: contact c for
//           its +f, -1 - c for the -f a self-collision pair c reports to
//           its body B's slot), a slot's entries in the order of the plain
//           version's columns (terrain candidates, pairs' A, pairs' B)

#include "substep_model.cuh"

namespace {

using namespace substep;

constexpr int kMaxFeet = 32;
constexpr int kLamRegs = 3 * kMaxContacts / kWarp;   // a lane's lam entries

struct PostArgs {
  const float* qpos;
  const float* qvel;
  const float* v_free;
  const float* W;
  const float* lam;
  const float* frame;        // (N, nc, 3, 3) or null
  const float* force_hist;
  const float* air[4];       // current_air, last_air, current_contact,
                             // last_contact
  const unsigned char* touchdown;
  const float* ftab;
  const int* itab;
  float* qpos_out;
  float* qvel_out;
  float* joint_acc;
  float* forces;
  float* hist_out;
  float* air_out[4];
  unsigned char* touchdown_out;
  int n_env, nv, nct, npair, nreport, nfeet;
  float h, threshold;
};

// One warp's slice of shared memory, in floats: lam, each contact's world
// force, each slot's net force, v.
struct PostLayout {
  int lam, f, forces, v, words;
  __host__ __device__ PostLayout(int nv, int nc, int nreport) {
    int p = 0;
    lam = p;    p += 3 * nc;
    f = p;      p += 3 * nc;
    forces = p; p += 3 * nreport;
    v = p;      p += nv;
    words = (p + 3) & ~3;
  }
};

// q = exp(h omega / 2) q0 for the world angular velocity omega, then
// renormalised (sim/maths.py quat_integrate; the axis divides by the angle
// clamped at 1e-12); IEEE sqrtf, sinf, cosf and divisions.
__device__ void quat_integrate(const float* q0, V3 om, float h, float* out) {
  const float ang = sqrtf(om.x * om.x + om.y * om.y + om.z * om.z);
  const float d = ang < 1e-12f ? 1e-12f : ang;
  const V3 ax = {om.x / d, om.y / d, om.z / d};
  const float half = 0.5f * ang * h;
  const float aw = cosf(half), sn = sinf(half);
  const float bx = ax.x * sn, by = ax.y * sn, bz = ax.z * sn;
  const float w = q0[0], x = q0[1], y = q0[2], z = q0[3];
  float r[4] = {aw * w - bx * x - by * y - bz * z,
                aw * x + bx * w + by * z - bz * y,
                aw * y - bx * z + by * w + bz * x,
                aw * z + bx * y - by * x + bz * w};
  const float nrm = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] +
                          r[3] * r[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i] / nrm;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
substep_post_kernel(const PostArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= a.n_env) return;        // the whole warp
  const int nv = a.nv, nj = nv - 6, nq = nv + 1;
  const int nc = a.nct + a.npair, nrow = 3 * nc, nr = a.nreport;
  const PostLayout Ly(nv, nc, nr);
  float* s = smem + static_cast<size_t>(warp) * Ly.words;
  float* lam = s + Ly.lam;
  float* f = s + Ly.f;
  float* frc = s + Ly.forces;
  float* v = s + Ly.v;
  const size_t e = env;
  const float h = a.h;

  // lam: in registers (lane l: entries l, l + 32, ...) and shared memory
  float lr[kLamRegs];
#pragma unroll
  for (int t = 0; t < kLamRegs; ++t) {
    const int i = lane + kWarp * t;
    lr[t] = i < nrow ? a.lam[e * nrow + i] : 0.f;
    if (i < nrow) lam[i] = lr[t];
  }

  // v = v_free + W lam, a row of W (a dof) at a time, the columns of zero
  // impulse unread; lane k keeps dof k's sum
  const float* W = a.W + e * nv * nrow;
  float wl = 0.f;
  for (int k = 0; k < nv; ++k) {
    const float* row = W + k * nrow;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kLamRegs; ++t) {
      const int i = lane + kWarp * t;
      if (i < nrow && lr[t] != 0.f) acc += row[i] * lr[t];
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == k) wl = acc;
  }
  if (lane < nv) v[lane] = __fadd_rn(a.v_free[e * nv + lane], wl);
  __syncwarp();

  // integration: a lane a dof; the joint-limit clamp zeroes a clamped
  // joint's velocity
  const float* qpos = a.qpos + e * nq;
  const float* qvel = a.qvel + e * nv;
  float* qpos_o = a.qpos_out + e * nq;
  float* qvel_o = a.qvel_out + e * nv;
  if (lane < 3) {
    qpos_o[lane] = __fadd_rn(qpos[lane], __fmul_rn(h, v[lane]));
  } else if (lane == 3) {
    // the body rate into the world (sim/maths.py quat_rotate), then the
    // exponential map
    const float qw = qpos[3];
    const V3 qv = {qpos[4], qpos[5], qpos[6]}, wb = ld3(v + 3);
    const V3 t = scale(2.f, cross(qv, wb));
    quat_integrate(qpos + 3, add(add(wb, scale(qw, t)), cross(qv, t)), h,
                   qpos_o + 3);
  }
  if (lane < 6) {
    qvel_o[lane] = v[lane];
  } else if (lane < nv) {
    const int j = lane - 6;
    const float qn = __fadd_rn(qpos[7 + j], __fmul_rn(h, v[lane]));
    const float c = clampf(qn, a.ftab[j], a.ftab[nj + j]);
    const float qd = c != qn ? 0.f : v[lane];
    qpos_o[7 + j] = c;
    qvel_o[lane] = qd;
    a.joint_acc[e * nj + j] = __fdiv_rn(__fsub_rn(qd, qvel[lane]), h);
  }

  // a lane a contact: its impulse in the world (frame^T lam, rows t1, t2,
  // n of the frame), over h; an inactive contact's frame is unread
  for (int c = lane; c < nc; c += kWarp) {
    const float l0 = lam[3 * c], l1 = lam[3 * c + 1], l2 = lam[3 * c + 2];
    float w[3] = {l0, l1, l2};
    if (a.frame != nullptr && (l0 != 0.f || l1 != 0.f || l2 != 0.f)) {
      const float* F = a.frame + (e * nc + c) * 9;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        w[i] = F[i] * l0 + F[3 + i] * l1 + F[6 + i] * l2;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) f[3 * c + i] = __fdiv_rn(w[i], h);
  }
  __syncwarp();

  // a lane a slot's component: the slot's contacts summed in table order
  const int* foot = a.itab;
  const int* start = foot + a.nfeet;
  const int* entry = start + nr + 1;
  float* forces = a.forces + e * 3 * nr;
  for (int q = lane; q < 3 * nr; q += kWarp) {
    const int r = q / 3, i = q % 3;
    float acc = 0.f;
    for (int k = start[r]; k < start[r + 1]; ++k) {
      const int c = entry[k];
      acc += c >= 0 ? f[3 * c + i] : -f[3 * (-1 - c) + i];
    }
    frc[q] = acc;
    forces[q] = acc;
  }
  __syncwarp();
  // the history shifted by one substep, the newest forces last
  const float* hist = a.force_hist + e * 9 * nr;
  float* hist_o = a.hist_out + e * 9 * nr;
  for (int q = lane; q < 9 * nr; q += kWarp)
    hist_o[q] = q < 6 * nr ? hist[q + 3 * nr] : frc[q - 6 * nr];

  // a lane a foot: in contact above the threshold, then its times
  if (lane < a.nfeet) {
    const size_t o = e * a.nfeet + lane;
    const float* x = frc + 3 * foot[lane];
    const float nrm = sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
        __fmul_rn(x[2], x[2])));
    const bool in = nrm > a.threshold;
    const float cur_air = a.air[0][o], cur_con = a.air[2][o];
    const float air_h = __fadd_rn(cur_air, h), con_h = __fadd_rn(cur_con, h);
    const bool touchdown = in && cur_air > 0.f;
    const bool liftoff = !in && cur_con > 0.f;
    a.air_out[0][o] = in ? 0.f : air_h;
    a.air_out[1][o] = touchdown ? air_h : a.air[1][o];
    a.air_out[2][o] = in ? con_h : 0.f;
    a.air_out[3][o] = liftoff ? con_h : a.air[3][o];
    a.touchdown_out[o] = (a.touchdown[o] != 0 || touchdown) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* substep_post_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once a device, before the first launch there.
int substep_post_setup(int device) {
  return substep::setup_device(substep_post_kernel, device);
}

// Bytes of shared memory a block of the kernel takes at this shape.
size_t substep_post_block_bytes(int nv, int nc, int nreport) {
  return sizeof(float) * PostLayout(nv, nc, nreport).words * substep::kWarps;
}

// Blocks an SM holds at this shape (after substep_post_setup on the
// current device), or -1.
int substep_post_blocks_per_sm(int nv, int nc, int nreport) {
  return substep::blocks_per_sm(substep_post_kernel,
                                substep_post_block_bytes(nv, nc, nreport));
}

// Launch over n_env envs on `stream` (a cudaStream_t of the current
// device); returns the cudaError_t of the launch. frame null: the world
// frame.
int substep_post_launch(
    const float* qpos, const float* qvel, const float* v_free, const float* W,
    const float* lam, const float* frame, const float* force_hist,
    const float* cur_air, const float* last_air, const float* cur_con,
    const float* last_con, const unsigned char* touchdown, const float* ftab,
    const int* itab, float* qpos_out, float* qvel_out, float* joint_acc,
    float* forces, float* hist_out, float* cur_air_out, float* last_air_out,
    float* cur_con_out, float* last_con_out, unsigned char* touchdown_out,
    int n_env, int nv, int nct, int npair, int nreport, int nfeet, float h,
    float threshold, void* stream) {
  const int nc = nct + npair;
  if (nv < 6 || nv > substep::kMaxDofs || nc < 1 ||
      nc > substep::kMaxContacts || npair < 0 || nreport < 1 || nfeet < 0 ||
      nfeet > kMaxFeet || n_env < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  const PostArgs a{qpos, qvel, v_free, W, lam, frame, force_hist,
                   {cur_air, last_air, cur_con, last_con}, touchdown, ftab,
                   itab, qpos_out, qvel_out, joint_acc, forces, hist_out,
                   {cur_air_out, last_air_out, cur_con_out, last_con_out},
                   touchdown_out, n_env, nv, nct, npair, nreport, nfeet, h,
                   threshold};
  const int grid = (n_env + substep::kWarps - 1) / substep::kWarps;
  substep_post_kernel<<<grid, substep::kThreads,
                        substep_post_block_bytes(nv, nc, nreport),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
