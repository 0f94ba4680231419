// The dynamics stage of one physics substep, one warp per env: PD torque,
// forward kinematics, the joint-space inertia M, the bias forces C, M^-1
// and the free velocity v_free = qvel + h M^-1 (tau - C).
//
// Replaces no Pallas kernel: it is the counterpart of the dynamics half of
// the JAX package's lanes substep (cat_tpu/sim/engine_lanes.py:38
// _substep_pre_lanes, through dynamics_lanes.fk_lanes :141,
// body_jacobians_lanes :212, world_inertias_lanes :241, mass_matrix_lanes
// :248, bias_forces_lanes :272, mass_matrix_inverse_lanes :368 and
// dense_inverse_lanes :405), which XLA fused into a few full-width passes
// on the TPU. Its plain version is sim/engine.py dynamics_stage, which
// runs the same arithmetic as ~600 small batched kernels a substep.
//
// What bounds it on an H100: neither bytes nor operations. Per env it
// reads qpos, qvel and the PD targets (~200 B) and writes tau_j, v_free,
// M^-1 and the kinematics the contact kernel reads (~2.2 KB at Solo12's
// shape); at N = 4096 that is ~9.75 MB (2.9 us at 3.35 TB/s). All 4096
// warps are resident at once (8 blocks of 4 warps an SM, about 8 warps a
// scheduler), so a launch costs about eight times one env's instruction
// stream. The design cuts that stream and fills more lanes an
// instruction, keeping every intermediate in registers and the warp's
// slice of shared memory (5.5 KB at Solo12's shape); the state's copies
// to shared memory are issued at once (cp.async) and waited for once:
//   * the tree walk, a lane a body, a level at a time (3 levels for a
//     quadruped): R, o, omega, the joint axes and the bias recursion's
//     alpha and a_o (unchanged from the first design);
//   * a lane a body: its world inertia, its bias force F = m a_com and
//     torque N = I alpha + omega x I omega (Newton-Euler at qacc = 0), and
//     its part of five sums about the base origin o0: mass m, first moment
//     h = m d, second moment J = I + m (|d|^2 - d d^T), force F and moment
//     N + d x F (d = x_com - o0);
//   * a lane a body again: those sums over its subtree (the bodies whose
//     chain holds its joint, the anc masks), its composite rigid body;
//   * a lane a dof l: its motion (w_l, v_l) (a point r - o0 of its subtree
//     moves at v_l + w_l x r), the momentum of its subtree under it, f_l =
//     m v_l + w_l x h and n_l = J w_l + h x v_l, and C_l = v_l . F + w_l .
//     N over the subtree (the backward pass of Newton-Euler);
//   * M by the composite-rigid-body rule, a lane an entry: M[k][l] = w_k .
//     n_l + v_k . f_l for l the deeper of two dofs on one chain, 0 for dofs
//     on different legs; exactly symmetric (one product for both
//     entries). ~2.3 k flops an env against the first design's ~38 k
//     (a lane a dof summing J^T I J over every body);
//   * M^-1, for legs of three contiguous dofs (sim/dynamics.py
//     mass_matrix_inverse): the closed-form 3x3 leg inverses D_i^-1, W = X
//     D^-1 a lane a column, the Schur complement S = B - W X^T a lane an
//     entry, its Cholesky factor L (a column at a time), H = L^-1 [I, -W]
//     a lane a column, then M^-1 = H^T H + blockdiag(0, D^-1) a lane an
//     entry over all 32 lanes, symmetric by its form, written to shared
//     memory and, coalesced, to device memory; for any other model (the
//     joint-less box) the Cholesky factor of M and a lane a column of the
//     identity solved forward and back, as the plain version does.
// The summation order is fixed and no atomics are used, so a launch is
// deterministic bit for bit; it differs from the plain version's order
// (which sums J^T I J over the bodies). No lane holds an array indexed by
// dof, so one instantiation serves every nv <= 32: at most 64 registers,
// no spills, 8 blocks an SM, 4096 envs in one wave. Measured
// (chip_smoke.py kernel-dyn, H100 80GB HBM3 at 700 W): 0.031 ms, 9.5% of
// the byte bound (the first design 0.061 ms, 4.8%); M/C and M^-1 still
// take more than half of a warp's cycles.
//
// Phases of the phase-clock build (-DSUBSTEP_PHASE_CLOCKS): PD (the state's
// loads and the PD torque), tree walk, body forces (the bodies' forces and
// their parts of the sums), M/C, M^-1 (with M^-1's write to device memory),
// v_free, writes.
//
// Layout: envs leading and contiguous: qpos (N, nq), qvel (N, nv), target
// (N, nj), com_offset (N, nb, 3) or null; out tau_j (N, nj), v_free
// (N, nv), minv (N, nv, nv), R (N, nb, 3, 3), o (N, nb, 3), a_w (N, nj, 3);
// nv = nb + 5 <= 32 (a floating base and one joint a body).

#include "substep_model.cuh"

namespace {

using namespace substep;

struct DynArgs {
  const float* qpos;
  const float* qvel;
  const float* target;
  const float* com_offset;   // (N, nb, 3) or null
  const float* ftab;
  const int* itab;
  float* tau_j;
  float* v_free;
  float* minv;
  float* R;
  float* o;
  float* a_w;
  int n_env, nb, nv, max_depth;
  float kp, kd, h;
  int schur;                 // 1: structured M^-1 (3-dof legs), 0: Cholesky
};

// Words of the Schur path's scratch: D^-1, W, S, L, 1 / diag L, H.
__host__ __device__ inline int schur_words(int nv) {
  const int nj = nv - 6;
  return 3 * nj + 6 * nj + 36 + 36 + 8 + 8 * nv;
}

// One warp's slice of shared memory, in floats. The body sums (own: each
// body's part, cmp: its subtree's, the composite body; 4 float4 a body)
// and the dofs' motions and momenta (2 float4 a dof) are read no more once
// M is built: the M^-1 scratch (scr) then takes their place. M^-1
// overwrites M.
struct DynLayout {
  int q, qd, tau, anc, R, o, om, aw, al, ao, own, cmp, mot, mom, scr, M,
      words;
  __host__ __device__ DynLayout(int nb, int nv) {
    int p = 0;
    q = p;    p += nv + 1;
    qd = p;   p += nv;
    tau = p;  p += nv;         // tau, then tau - C
    anc = p;  p += nb;         // the anc masks (as unsigned)
    R = p;    p += 9 * nb;
    o = p;    p += 3 * nb;
    om = p;   p += 3 * nb;
    aw = p;   p += 3 * nb;
    al = p;   p += 3 * nb;
    ao = p;   p += 3 * nb;
    p = (p + 3) & ~3;
    own = p;
    cmp = own + 16 * nb;
    mot = cmp + 16 * nb;
    mom = mot + 8 * nv;
    scr = own;
    const int end = mom + 8 * nv;
    const int need = scr + (nv * nv > schur_words(nv) ? nv * nv
                                                      : schur_words(nv));
    p = ((end > need ? end : need) + 3) & ~3;
    M = p;    p += nv * nv;
    words = (p + 3) & ~3;
  }
};

// Closed-form inverse of the 3x3 block of A (leading dimension lda) at
// (r0, r0): adjugate over determinant, as sim/dynamics.py inv3.
__device__ void inv3(const float* A, int lda, int r0, float* out) {
  const float* m = A + r0 * lda + r0;
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[lda], e = m[lda + 1], f = m[lda + 2];
  const float g = m[2 * lda], h = m[2 * lda + 1], i = m[2 * lda + 2];
  const float co00 = e * i - f * h, co01 = c * h - b * i, co02 = b * f - c * e;
  const float co10 = f * g - d * i, co11 = a * i - c * g, co12 = c * d - a * f;
  const float co20 = d * h - e * g, co21 = b * g - a * h, co22 = a * e - b * d;
  const float det = a * co00 + b * co10 + c * co20;
  const float inv = 1.f / det;
  out[0] = co00 * inv; out[1] = co01 * inv; out[2] = co02 * inv;
  out[3] = co10 * inv; out[4] = co11 * inv; out[5] = co12 * inv;
  out[6] = co20 * inv; out[7] = co21 * inv; out[8] = co22 * inv;
}

// Lower Cholesky factor L of the n x n SPD A (both leading dimension n), a
// lane a row, a column at a time, the pivot clamped at 1e-12 (as
// sim/dynamics.py cholesky_factor); dinv, if given, gets 1 / L[j][j].
// Every lane of the warp calls it.
__device__ void chol_factor(const float* A, float* L, int n, int lane,
                            float* dinv = nullptr) {
  for (int j = 0; j < n; ++j) {
    float ci = 0.f;
    if (lane < n) {
      ci = A[lane * n + j];
      for (int k = 0; k < j; ++k) ci -= L[lane * n + k] * L[j * n + k];
    }
    const float cj = __shfl_sync(kFull, ci, j);
    const float d = 1.f / sqrtf(cj < 1e-12f ? 1e-12f : cj);
    if (lane < n) L[lane * n + j] = lane >= j ? ci * d : 0.f;
    if (dinv != nullptr && lane == 0) dinv[j] = d;
    __syncwarp();
  }
}

// Steps entry (k, l) of a row-major n x n matrix on by 32 entries.
__device__ __forceinline__ void next_entry(int& k, int& l, int n) {
  l += kWarp;
  while (l >= n) {
    l -= n;
    ++k;
  }
}

// Structured M^-1 for a floating base with 3-dof legs (sim/dynamics.py
// mass_matrix_inverse):  M = [[B, X], [X^T, D]], D = blockdiag(D_i),
// W = X D^-1, S = B - W X^T = L L^T, H = L^-1 [I, -W] (6 x nv), M^-1 =
// H^T H + blockdiag(0, D^-1) (= [[S^-1, -S^-1 W], [-W^T S^-1, D^-1 +
// W^T S^-1 W]]). M is overwritten with M^-1, which also goes to out.
__device__ void schur_inverse(float* M, float* scr, float* out, int nv,
                              int lane) {
  const int nj = nv - 6, nbr = nj / 3;
  float* Dinv = scr;                 // (nbr, 3, 3)
  float* Wm = Dinv + 9 * nbr;        // (6, nj)
  float* S = Wm + 6 * nj;            // (6, 6)
  float* Lc = S + 36;                // (6, 6)
  float* Ld = Lc + 36;               // 1 / diag L (8)
  float4* Ht = reinterpret_cast<float4*>(Ld + 8);   // column k of H: 2 float4
  if (lane < nbr) inv3(M, nv, 6 + 3 * lane, Dinv + 9 * lane);
  __syncwarp();
  float wc[6];                       // lane 6 + a: column a of W
  if (lane >= 6 && lane < nv) {
    const int a = lane - 6, i = a / 3, c = a % 3;
    const float* Di = Dinv + 9 * i;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float* X = M + r * nv + 6 + 3 * i;
      wc[r] = X[0] * Di[c] + X[1] * Di[3 + c] + X[2] * Di[6 + c];
      Wm[r * nj + a] = wc[r];
    }
  }
  __syncwarp();
  if (lane < 21) {                   // S's entries r <= c, both halves
    int r = 0, c = lane;
    while (c >= 6 - r) {
      c -= 6 - r;
      ++r;
    }
    c += r;
    float acc = 0.f;
    for (int a = 0; a < nj; ++a) acc += Wm[r * nj + a] * M[c * nv + 6 + a];
    S[r * 6 + c] = S[c * 6 + r] = M[r * nv + c] - acc;
  }
  __syncwarp();
  chol_factor(S, Lc, 6, lane, Ld);
  if (lane < nv) {                   // column k of H, forward substitution
    float y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float acc = lane < 6 ? (i == lane ? 1.f : 0.f) : -wc[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc -= Lc[i * 6 + k] * y[k];
      y[i] = acc * Ld[i];
    }
    Ht[2 * lane] = make_float4(y[0], y[1], y[2], y[3]);
    Ht[2 * lane + 1] = make_float4(y[4], y[5], 0.f, 0.f);
  }
  __syncwarp();
  // a lane an entry of M^-1, row-major: the same products in the same
  // order for (k, l) and (l, k); coalesced to device memory
  int k = lane / nv, l = lane % nv;
  for (int e = lane; e < nv * nv; e += kWarp) {
    const float4 a0 = Ht[2 * k], a1 = Ht[2 * k + 1];
    const float4 b0 = Ht[2 * l], b1 = Ht[2 * l + 1];
    float v = a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w +
              a1.x * b1.x + a1.y * b1.y;
    const int ka = k - 6, la = l - 6;
    if (ka >= 0 && la >= 0 && ka / 3 == la / 3)
      v += Dinv[9 * (ka / 3) + 3 * (ka % 3) + la % 3];
    M[e] = v;
    out[e] = v;
    next_entry(k, l, nv);
  }
  __syncwarp();
}

// M^-1 by the Cholesky factor of M and one solve of each column of the
// identity, forward and back, a lane a column (sim/dynamics.py
// cholesky_factor, cholesky_solve); not symmetrised, as there. M is
// overwritten with M^-1, which also goes to out.
__device__ void cholesky_inverse(float* M, float* L, float* out, int nv,
                                 int lane) {
  chol_factor(M, L, nv, lane);
  float* Minv = M;                   // M is read no more
  if (lane < nv) {
    const int r = lane;
    for (int i = 0; i < nv; ++i) {
      float acc = i == r ? 1.f : 0.f;
      for (int k = 0; k < i; ++k) acc -= L[i * nv + k] * Minv[k * nv + r];
      Minv[i * nv + r] = acc / L[i * nv + i];
    }
    for (int i = nv - 1; i >= 0; --i) {
      float acc = Minv[i * nv + r];
      for (int k = i + 1; k < nv; ++k) acc -= L[k * nv + i] * Minv[k * nv + r];
      Minv[i * nv + r] = acc / L[i * nv + i];
    }
  }
  __syncwarp();
  for (int i = lane; i < nv * nv; i += kWarp) out[i] = Minv[i];
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
substep_dyn_kernel(const DynArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= a.n_env) return;        // the whole warp
  PhaseClock clk(env, lane);
  const int nb = a.nb, nv = a.nv, nj = nb - 1, nq = nv + 1;
  const DynLayout Ly(nb, nv);
  const FloatTable ft(nb, nv, 0, 0);
  const IntTable it(nb, 0, 0);
  const float* tf = a.ftab;
  const int* ti = a.itab;
  float* s = smem + static_cast<size_t>(warp) * Ly.words;
  float* q = s + Ly.q;
  float* qd = s + Ly.qd;
  float* tau = s + Ly.tau;
  unsigned* anc = reinterpret_cast<unsigned*>(s + Ly.anc);
  float* R = s + Ly.R;
  float* o = s + Ly.o;
  float* om = s + Ly.om;
  float* aw = s + Ly.aw;
  float* al = s + Ly.al;
  float* ao = s + Ly.ao;
  float4* own = reinterpret_cast<float4*>(s + Ly.own);
  float4* cmp = reinterpret_cast<float4*>(s + Ly.cmp);
  float4* mot = reinterpret_cast<float4*>(s + Ly.mot);
  float4* mom = reinterpret_cast<float4*>(s + Ly.mom);
  float* M = s + Ly.M;
  float* scr = s + Ly.scr;

  const float* qpos = a.qpos + static_cast<size_t>(env) * nq;
  const float* qvel = a.qvel + static_cast<size_t>(env) * nv;
  for (int i = lane; i < nq; i += kWarp) copy4(q + i, qpos + i);
  for (int i = lane; i < nv; i += kWarp) copy4(qd + i, qvel + i);
  for (int i = lane; i < nb; i += kWarp) copy4(anc + i, ti + it.anc + i);
  // PD torque, rounded op by op as the plain version's (no contraction)
  if (lane < nv) {
    float t = 0.f;
    if (lane >= 6) {
      const int j = lane - 6;
      const float lim = tf[ft.effort + j];
      const float tq = a.target[static_cast<size_t>(env) * nj + j];
      t = __fsub_rn(__fmul_rn(a.kp, __fsub_rn(tq, qpos[7 + j])),
                    __fmul_rn(a.kd, qvel[6 + j]));
      t = clampf(t, -lim, lim);
      a.tau_j[static_cast<size_t>(env) * nj + j] = t;
    }
    tau[lane] = t;
  }
  copy_wait();
  clk.lap(0);

  // the base: R0 from the quaternion, omega0 = R0 applied to the body rate
  // (quat_rotate), gravity as the base's acceleration
  if (lane == 0) {
    const float w = q[3], x = q[4], y = q[5], z = q[6];
    R[0] = 1.f - 2.f * (y * y + z * z);
    R[1] = 2.f * (x * y - w * z);
    R[2] = 2.f * (x * z + w * y);
    R[3] = 2.f * (x * y + w * z);
    R[4] = 1.f - 2.f * (x * x + z * z);
    R[5] = 2.f * (y * z - w * x);
    R[6] = 2.f * (x * z - w * y);
    R[7] = 2.f * (y * z + w * x);
    R[8] = 1.f - 2.f * (x * x + y * y);
    st3(o, ld3(q));
    const V3 qv = {x, y, z}, v = ld3(qd + 3);
    const V3 t = scale(2.f, cross(qv, v));
    st3(om, add(add(v, scale(w, t)), cross(qv, t)));
    st3(al, V3{0.f, 0.f, 0.f});
    st3(ao, ld3(tf + ft.base_acc));
  }
  __syncwarp();

  // the tree, a level at a time, a lane a body
  for (int d = 1; d <= a.max_depth; ++d) {
    if (lane < nb && ti[it.depth + lane] == d) {
      const int b = lane, p = ti[it.parent + b];
      const float* Rp = R + 9 * p;
      const V3 op = ld3(o + 3 * p), omp = ld3(om + 3 * p);
      const V3 alp = ld3(al + 3 * p), aop = ld3(ao + 3 * p);
      const float qb = q[6 + b], qdb = qd[5 + b];
      const V3 oj = add(op, mv(Rp, ld3(tf + ft.joint_pos + 3 * b)));
      float Rpw[9];
      mm(Rp, tf + ft.joint_rot + 9 * b, Rpw);
      const V3 ax = mv(Rpw, ld3(tf + ft.joint_axis + 3 * b));
      const float K[9] = {0.f, -ax.z, ax.y, ax.z, 0.f, -ax.x, -ax.y, ax.x, 0.f};
      float KK[9], Rax[9];
      mm(K, K, KK);
      const float sq = sinf(qb), cq = 1.f - cosf(qb);
#pragma unroll
      for (int i = 0; i < 9; ++i)
        Rax[i] = ((i % 4 == 0) ? 1.f : 0.f) + sq * K[i] + cq * KK[i];
      mm(Rax, Rpw, R + 9 * b);
      const V3 dv = sub(oj, op);
      const V3 wq = scale(qdb, ax);
      st3(o + 3 * b, oj);
      st3(om + 3 * b, add(omp, wq));
      st3(aw + 3 * (b - 1), ax);
      st3(al + 3 * b, add(alp, cross(omp, wq)));
      st3(ao + 3 * b, add(add(aop, cross(alp, dv)), cross(omp, cross(omp, dv))));
    }
    __syncwarp();
  }
  clk.lap(1);

  // a lane a body: centre of mass, world inertia, the bias force and
  // torque (Newton-Euler at qacc = 0), and the body's part of the sums
  // about o0: (m, h), (J00, J01, J02, J11), (J12, J22, F.x, F.y),
  // (F.z, N + d x F)
  const V3 o0 = ld3(o);
  if (lane < nb) {
    const int b = lane;
    const float* Rb = R + 9 * b;
    const V3 ob = ld3(o + 3 * b);
    V3 c = ld3(tf + ft.com + 3 * b);
    if (a.com_offset)
      c = add(c, ld3(a.com_offset + (static_cast<size_t>(env) * nb + b) * 3));
    const V3 x = add(ob, mv(Rb, c));
    float RI[9], Ib[9];
    mm(Rb, tf + ft.inertia + 9 * b, RI);
    mmt(RI, Rb, Ib);
    const V3 w = ld3(om + 3 * b), alb = ld3(al + 3 * b);
    const V3 r = sub(x, ob);
    const V3 acom =
        add(add(ld3(ao + 3 * b), cross(alb, r)), cross(w, cross(w, r)));
    const float m = tf[ft.mass + b];
    const V3 F = scale(m, acom);
    const V3 N = add(mv(Ib, alb), cross(w, mv(Ib, w)));
    const V3 d = sub(x, o0);
    const V3 h = scale(m, d);
    const float md = m * dot(d, d);
    const V3 Nd = add(N, cross(d, F));
    own[4 * b] = make_float4(m, h.x, h.y, h.z);
    own[4 * b + 1] = make_float4(Ib[0] + md - h.x * d.x, Ib[1] - h.x * d.y,
                                 Ib[2] - h.x * d.z, Ib[4] + md - h.y * d.y);
    own[4 * b + 2] = make_float4(Ib[5] - h.y * d.z, Ib[8] + md - h.z * d.z,
                                 F.x, F.y);
    own[4 * b + 3] = make_float4(F.z, Nd.x, Nd.y, Nd.z);
  }
  __syncwarp();
  clk.lap(2);

  // a lane a body b: the sums over its subtree (the bodies whose chain
  // holds joint b - 1; every body for the base), in body order
  if (lane < nb) {
    const unsigned bit = lane == 0 ? 0u : 1u << (lane - 1);
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0, s2 = s0, s3 = s0;
    for (int c = 0; c < nb; ++c)
      if (lane == 0 || (anc[c] & bit)) {
        const float4 u0 = own[4 * c], u1 = own[4 * c + 1];
        const float4 u2 = own[4 * c + 2], u3 = own[4 * c + 3];
        s0 = make_float4(s0.x + u0.x, s0.y + u0.y, s0.z + u0.z, s0.w + u0.w);
        s1 = make_float4(s1.x + u1.x, s1.y + u1.y, s1.z + u1.z, s1.w + u1.w);
        s2 = make_float4(s2.x + u2.x, s2.y + u2.y, s2.z + u2.z, s2.w + u2.w);
        s3 = make_float4(s3.x + u3.x, s3.y + u3.y, s3.z + u3.z, s3.w + u3.w);
      }
    cmp[4 * lane] = s0;
    cmp[4 * lane + 1] = s1;
    cmp[4 * lane + 2] = s2;
    cmp[4 * lane + 3] = s3;
  }
  __syncwarp();
  // a lane a dof l: its motion (w, v), the momentum (n, f) of the subtree
  // it moves (the whole tree for the base's dofs, else body l - 5's), and
  // C_l = v . F + w . N over that subtree; tau - C
  if (lane < nv) {
    V3 w = {0.f, 0.f, 0.f}, v = {0.f, 0.f, 0.f};
    int cb = 0;
    if (lane < 3) {
      v = V3{lane == 0 ? 1.f : 0.f, lane == 1 ? 1.f : 0.f,
             lane == 2 ? 1.f : 0.f};
    } else if (lane < 6) {
      w = col(R, lane - 3);
    } else {
      const int j = lane - 6;
      w = ld3(aw + 3 * j);
      v = cross(sub(ld3(o + 3 * (j + 1)), o0), w);
      cb = j + 1;
    }
    const float4 c0 = cmp[4 * cb], c1 = cmp[4 * cb + 1];
    const float4 c2 = cmp[4 * cb + 2], c3 = cmp[4 * cb + 3];
    const V3 h = {c0.y, c0.z, c0.w};
    const V3 f = add(scale(c0.x, v), cross(w, h));
    const V3 Jw = {c1.x * w.x + c1.y * w.y + c1.z * w.z,
                   c1.y * w.x + c1.w * w.y + c2.x * w.z,
                   c1.z * w.x + c2.x * w.y + c2.y * w.z};
    const V3 n = add(Jw, cross(h, v));
    const float C =
        dot(v, V3{c2.z, c2.w, c3.x}) + dot(w, V3{c3.y, c3.z, c3.w});
    mot[2 * lane] = make_float4(w.x, w.y, w.z, v.x);
    mot[2 * lane + 1] = make_float4(v.y, v.z, 0.f, 0.f);
    mom[2 * lane] = make_float4(n.x, n.y, n.z, f.x);
    mom[2 * lane + 1] = make_float4(f.y, f.z, 0.f, 0.f);
    tau[lane] -= C;
  }
  __syncwarp();
  // M, a lane an entry, row-major: the shallower dof's motion against the
  // deeper one's momentum when both lie on one chain (a base dof lies on
  // every chain), else 0; the armature on the diagonal
  {
    int k = lane / nv, l = lane % nv;
    for (int e = lane; e < nv * nv; e += kWarp) {
      const int lo = k < l ? k : l, hi = k < l ? l : k;
      float v = 0.f;
      if (lo < 6 || ((anc[hi - 5] >> (lo - 6)) & 1u)) {
        const float4 a0 = mot[2 * lo], a1 = mot[2 * lo + 1];
        const float4 b0 = mom[2 * hi], b1 = mom[2 * hi + 1];
        v = a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w +
            a1.x * b1.x + a1.y * b1.y;
      }
      if (k == l) v += tf[ft.armature + k];
      M[e] = v;
      next_entry(k, l, nv);
    }
  }
  __syncwarp();
  clk.lap(3);

  float* minv = a.minv + static_cast<size_t>(env) * nv * nv;
  if (a.schur)
    schur_inverse(M, scr, minv, nv, lane);
  else
    cholesky_inverse(M, scr, minv, nv, lane);
  clk.lap(4);

  if (lane < nv) {
    float acc = 0.f;
    for (int l = 0; l < nv; ++l) acc += M[lane * nv + l] * tau[l];
    a.v_free[static_cast<size_t>(env) * nv + lane] = qd[lane] + a.h * acc;
  }
  clk.lap(5);
  float* Rout = a.R + static_cast<size_t>(env) * 9 * nb;
  for (int i = lane; i < 9 * nb; i += kWarp) Rout[i] = R[i];
  float* oout = a.o + static_cast<size_t>(env) * 3 * nb;
  for (int i = lane; i < 3 * nb; i += kWarp) oout[i] = o[i];
  float* awout = a.a_w + static_cast<size_t>(env) * 3 * nj;
  for (int i = lane; i < 3 * nj; i += kWarp) awout[i] = aw[i];
  clk.lap(6);
}

}  // namespace

extern "C" {

const char* substep_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once a device, before the first launch there.
int substep_dyn_setup(int device) {
  return substep::setup_device(substep_dyn_kernel, device);
}

// Bytes of shared memory a block of the kernel takes at this shape.
size_t substep_dyn_block_bytes(int nb, int nv) {
  return sizeof(float) * DynLayout(nb, nv).words * substep::kWarps;
}

// Blocks an SM holds at this shape (after substep_dyn_setup on the
// current device), or -1.
int substep_dyn_blocks_per_sm(int nb, int nv) {
  return substep::blocks_per_sm(substep_dyn_kernel,
                                substep_dyn_block_bytes(nb, nv));
}

#ifdef SUBSTEP_PHASE_CLOCKS
// The phase-clock build only: where the next launches add each env's
// cycles a phase (int64 (n_env, kPhaseSlots), zeroed), or null.
int substep_dyn_set_phase_cycles(void* buf) {
  return substep::set_phase_cycles(buf);
}
#endif

// Launch over n_env envs on `stream` (a cudaStream_t of the current
// device); returns the cudaError_t of the launch.
int substep_dyn_launch(const float* qpos, const float* qvel,
                       const float* target, const float* com_offset,
                       const float* ftab, const int* itab, float* tau_j,
                       float* v_free, float* minv, float* R, float* o,
                       float* a_w, int n_env, int nb, int nv, int max_depth,
                       float kp, float kd, float h, int schur, void* stream) {
  if (nb < 1 || nv != nb + 5 || nv > substep::kMaxDofs || n_env < 0 ||
      (schur && (nv - 6) % 3 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  const DynArgs a{qpos, qvel,  target, com_offset, ftab, itab, tau_j,
                  v_free, minv, R,    o,          a_w,  n_env, nb,
                  nv,    max_depth, kp, kd,       h,    schur};
  const int grid = (n_env + substep::kWarps - 1) / substep::kWarps;
  substep_dyn_kernel<<<grid, substep::kThreads,
                       substep_dyn_block_bytes(nb, nv),
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
