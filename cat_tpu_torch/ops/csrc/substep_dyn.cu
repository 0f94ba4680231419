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
// shape), and does ~40 k operations; at N = 4096 that is ~9 MB (2.7 us at
// 3.35 TB/s) and ~0.16 GFLOP (2.4 us at 67 TFLOP/s). What costs is the
// chain of dependent steps (tree levels, Cholesky columns), so the design
// keeps every intermediate of an env in its warp's slice of shared memory
// and its lanes' registers and never writes M, C or a Jacobian to device
// memory:
//   * the tree walk runs a lane a body, level by level (3 levels for a
//     quadruped), computing R, o, omega, the joint axes and, in the same
//     pass, the bias recursion's alpha and a_o;
//   * a lane a dof then builds its own column of each body's Jacobians
//     from those (the Jacobians are never stored) and sums its row of M
//     and its entry of C over the bodies, in registers;
//   * M^-1: for legs of three contiguous dofs the closed-form 3x3 leg
//     inverses, a 6x6 Schur complement, its Cholesky factor and inverse,
//     lanes a column or an entry; for any other model (the joint-less box)
//     the Cholesky factor of M (a lane a row, a column at a time) and a
//     lane a column of identity solved forward and back, as the plain
//     version does.
// The summation order is fixed and no atomics are used, so a launch is
// deterministic bit for bit; it differs from the plain version's order.
// Each warp's slice (6.9 KB at Solo12's shape) holds the state, the
// bodies' frames, inertias, forces, the Jacobian columns being summed
// (packed for 16-byte reads), M, M^-1 and scratch. A lane's row of M takes
// kD registers, the kernel's template argument (8, 24 or 32 >= nv: 24 for
// the quadrupeds), which keeps it at 64 registers, so an SM holds 8 blocks
// and 4096 envs run in one wave (at 72 registers, with 32 slots whatever
// nv, 4096 envs took two waves).
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

// One warp's slice of shared memory, in floats.
struct DynLayout {
  int q, qd, tau, R, o, om, aw, al, ao, xc, Iw, F, Nt, cols, M, Minv, scr,
      words;
  __host__ __device__ DynLayout(int nb, int nv) {
    const int nj = nb - 1;
    int p = 0;
    q = p;    p += nv + 1;
    qd = p;   p += nv;
    tau = p;  p += nv;         // tau, then tau - C
    R = p;    p += 9 * nb;
    o = p;    p += 3 * nb;
    om = p;   p += 3 * nb;
    aw = p;   p += 3 * nb;
    al = p;   p += 3 * nb;
    ao = p;   p += 3 * nb;
    xc = p;   p += 3 * nb;
    Iw = p;   p += 9 * nb;
    F = p;    p += 3 * nb;
    Nt = p;   p += 3 * nb;
    p = (p + 3) & ~3;
    cols = p; p += 8 * nv;       // a dof's jv (3), I_w jw (3), 2 unused
    M = p;    p += nv * nv;
    Minv = p; p += nv * nv;
    scr = p;
    const int schur_words = 15 * nj + 144;
    p += nv * nv > schur_words ? nv * nv : schur_words;
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
// sim/dynamics.py cholesky_factor). Every lane of the warp calls it.
__device__ void chol_factor(const float* A, float* L, int n, int lane) {
  for (int j = 0; j < n; ++j) {
    float ci = 0.f;
    if (lane < n) {
      ci = A[lane * n + j];
      for (int k = 0; k < j; ++k) ci -= L[lane * n + k] * L[j * n + k];
    }
    const float cj = __shfl_sync(kFull, ci, j);
    const float d = 1.f / sqrtf(cj < 1e-12f ? 1e-12f : cj);
    if (lane < n) L[lane * n + j] = lane >= j ? ci * d : 0.f;
    __syncwarp();
  }
}

// A lane a row k < n: A[k][l] = 0.5 (raw[k][l] + raw[l][k]).
__device__ void symmetrise(const float* raw, float* A, int n, int lane) {
  if (lane < n)
    for (int l = 0; l < n; ++l)
      A[lane * n + l] = 0.5f * (raw[lane * n + l] + raw[l * n + lane]);
  __syncwarp();
}

// Structured M^-1 for a floating base with 3-dof legs (sim/dynamics.py
// mass_matrix_inverse):  M = [[B, X], [X^T, D]], D = blockdiag(D_i),
// W = X D^-1, S = B - W X^T, M^-1 = [[S^-1, -S^-1 W], [-W^T S^-1,
// D^-1 + W^T S^-1 W]], symmetrised. M is overwritten (scratch).
__device__ void schur_inverse(float* M, float* Minv, float* scr, int nv,
                              int lane) {
  const int nj = nv - 6, nbr = nj / 3;
  float* Dinv = scr;
  float* Wm = Dinv + 9 * nbr;        // (6, nj)
  float* S = Wm + 6 * nj;            // (6, 6)
  float* Lc = S + 36;
  float* Li = Lc + 36;
  float* Si = Li + 36;
  float* SW = Si + 36;               // (6, nj)
  if (lane < nbr) inv3(M, nv, 6 + 3 * lane, Dinv + 9 * lane);
  __syncwarp();
  if (lane < nj) {                   // W = X blockdiag(D^-1), a lane a column
    const int i = lane / 3, c = lane % 3;
    const float* Di = Dinv + 9 * i;
    for (int r = 0; r < 6; ++r) {
      const float* X = M + r * nv + 6 + 3 * i;
      Wm[r * nj + lane] = X[0] * Di[c] + X[1] * Di[3 + c] + X[2] * Di[6 + c];
    }
  }
  __syncwarp();
  for (int e = lane; e < 36; e += kWarp) {   // S = B - W X^T
    const int r = e / 6, c = e % 6;
    float acc = 0.f;
    for (int j = 0; j < nj; ++j) acc += Wm[r * nj + j] * M[c * nv + 6 + j];
    S[e] = M[r * nv + c] - acc;
  }
  __syncwarp();
  chol_factor(S, Lc, 6, lane);
  if (lane < 6) {                    // Li = Lc^-1, a lane a column
    for (int i = 0; i < 6; ++i) {
      float acc = i == lane ? 1.f : 0.f;
      for (int k = 0; k < i; ++k) acc -= Lc[i * 6 + k] * Li[k * 6 + lane];
      Li[i * 6 + lane] = acc / Lc[i * 6 + i];
    }
  }
  __syncwarp();
  for (int e = lane; e < 36; e += kWarp) {   // S^-1 = Li^T Li
    const int r = e / 6, c = e % 6;
    float acc = 0.f;
    for (int m = 0; m < 6; ++m) acc += Li[m * 6 + r] * Li[m * 6 + c];
    Si[e] = acc;
  }
  __syncwarp();
  if (lane < nj)                     // SW = S^-1 W, a lane a column
    for (int r = 0; r < 6; ++r) {
      float acc = 0.f;
      for (int m = 0; m < 6; ++m) acc += Si[r * 6 + m] * Wm[m * nj + lane];
      SW[r * nj + lane] = acc;
    }
  __syncwarp();
  // M is read no more: the unsymmetrised M^-1 goes there, a lane a row
  if (lane < nv) {
    const int k = lane;
    for (int l = 0; l < nv; ++l) {
      float v;
      if (k < 6 && l < 6) {
        v = Si[k * 6 + l];
      } else if (k < 6) {
        v = -SW[k * nj + l - 6];
      } else if (l < 6) {
        v = -SW[l * nj + k - 6];
      } else {
        const int a = k - 6, b = l - 6;
        float acc = 0.f;
        for (int m = 0; m < 6; ++m) acc += Wm[m * nj + a] * SW[m * nj + b];
        if (a / 3 == b / 3) acc += Dinv[9 * (a / 3) + 3 * (a % 3) + b % 3];
        v = acc;
      }
      M[k * nv + l] = v;
    }
  }
  __syncwarp();
  symmetrise(M, Minv, nv, lane);
}

// M^-1 by the Cholesky factor of M and one solve of each column of the
// identity, forward and back, a lane a column (sim/dynamics.py
// cholesky_factor, cholesky_solve); not symmetrised, as there.
__device__ void cholesky_inverse(const float* M, float* Minv, float* L,
                                 int nv, int lane) {
  chol_factor(M, L, nv, lane);
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
}

// kD: the dof slots a lane's row of M takes in registers (>= nv)
template <int kD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
substep_dyn_kernel(const DynArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= a.n_env) return;        // the whole warp
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
  float* R = s + Ly.R;
  float* o = s + Ly.o;
  float* om = s + Ly.om;
  float* aw = s + Ly.aw;
  float* al = s + Ly.al;
  float* ao = s + Ly.ao;
  float* xc = s + Ly.xc;
  float* Iw = s + Ly.Iw;
  float* F = s + Ly.F;
  float* Nt = s + Ly.Nt;
  float4* cols = reinterpret_cast<float4*>(s + Ly.cols);
  float* M = s + Ly.M;
  float* Minv = s + Ly.Minv;
  float* scr = s + Ly.scr;

  const float* qpos = a.qpos + static_cast<size_t>(env) * nq;
  const float* qvel = a.qvel + static_cast<size_t>(env) * nv;
  for (int i = lane; i < nq; i += kWarp) q[i] = qpos[i];
  for (int i = lane; i < nv; i += kWarp) qd[i] = qvel[i];
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
  __syncwarp();

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

  // a lane a body: centre of mass, world inertia, the body's force and
  // torque of the bias (Newton-Euler at qacc = 0)
  if (lane < nb) {
    const int b = lane;
    const float* Rb = R + 9 * b;
    const V3 ob = ld3(o + 3 * b);
    V3 c = ld3(tf + ft.com + 3 * b);
    if (a.com_offset)
      c = add(c, ld3(a.com_offset + (static_cast<size_t>(env) * nb + b) * 3));
    const V3 x = add(ob, mv(Rb, c));
    st3(xc + 3 * b, x);
    float RI[9];
    mm(Rb, tf + ft.inertia + 9 * b, RI);
    float* Ib = Iw + 9 * b;
    mmt(RI, Rb, Ib);
    const V3 w = ld3(om + 3 * b), alb = ld3(al + 3 * b);
    const V3 r = sub(x, ob);
    const V3 acom =
        add(add(ld3(ao + 3 * b), cross(alb, r)), cross(w, cross(w, r)));
    st3(F + 3 * b, scale(tf[ft.mass + b], acom));
    st3(Nt + 3 * b, add(mv(Ib, alb), cross(w, mv(Ib, w))));
  }
  __syncwarp();

  // a lane a dof k: column k of each body's Jacobians (Jv at the centre of
  // mass, Jw), summed into row k of M and entry k of C
  float macc[kD];
#pragma unroll
  for (int l = 0; l < kD; ++l) macc[l] = 0.f;
  float cacc = 0.f;
  const V3 o0 = ld3(o);
  for (int b = 0; b < nb; ++b) {
    V3 jv = {0.f, 0.f, 0.f}, jw = {0.f, 0.f, 0.f};
    bool live = false;
    const V3 x = ld3(xc + 3 * b);
    if (lane < 3) {
      jv = V3{lane == 0 ? 1.f : 0.f, lane == 1 ? 1.f : 0.f,
              lane == 2 ? 1.f : 0.f};
      live = true;
    } else if (lane < 6) {
      jw = col(R, lane - 3);
      jv = scale(-1.f, cross(sub(x, o0), jw));
      live = true;
    } else if (lane < nv) {
      const int j = lane - 6;
      if ((static_cast<unsigned>(ti[it.anc + b]) >> j) & 1u) {
        jw = ld3(aw + 3 * j);
        jv = cross(jw, sub(x, ld3(o + 3 * (j + 1))));
        live = true;
      }
    }
    const V3 X = mv(Iw + 9 * b, jw);
    if (lane < nv) {
      cols[2 * lane] = make_float4(jv.x, jv.y, jv.z, X.x);
      cols[2 * lane + 1] = make_float4(X.y, X.z, 0.f, 0.f);
    }
    __syncwarp();
    if (live) {
      const float m = tf[ft.mass + b];
#pragma unroll
      for (int l = 0; l < kD; ++l)
        if (l < nv) {
          const float4 c0 = cols[2 * l], c1 = cols[2 * l + 1];
          macc[l] += m * (jv.x * c0.x + jv.y * c0.y + jv.z * c0.z) +
                     (jw.x * c0.w + jw.y * c1.x + jw.z * c1.y);
        }
      cacc += dot(jv, ld3(F + 3 * b)) + dot(jw, ld3(Nt + 3 * b));
    }
    __syncwarp();
  }
  // M with the armature, symmetrised; tau - C
  if (lane < nv) {
    const float arm = tf[ft.armature + lane];
#pragma unroll
    for (int l = 0; l < kD; ++l)
      if (l < nv) scr[lane * nv + l] = l == lane ? macc[l] + arm : macc[l];
    tau[lane] -= cacc;
  }
  __syncwarp();
  symmetrise(scr, M, nv, lane);

  if (a.schur)
    schur_inverse(M, Minv, scr, nv, lane);
  else
    cholesky_inverse(M, Minv, scr, nv, lane);

  if (lane < nv) {
    float acc = 0.f;
    for (int l = 0; l < nv; ++l) acc += Minv[lane * nv + l] * tau[l];
    a.v_free[static_cast<size_t>(env) * nv + lane] = qd[lane] + a.h * acc;
  }
  float* minv = a.minv + static_cast<size_t>(env) * nv * nv;
  for (int i = lane; i < nv * nv; i += kWarp) minv[i] = Minv[i];
  float* Rout = a.R + static_cast<size_t>(env) * 9 * nb;
  for (int i = lane; i < 9 * nb; i += kWarp) Rout[i] = R[i];
  float* oout = a.o + static_cast<size_t>(env) * 3 * nb;
  for (int i = lane; i < 3 * nb; i += kWarp) oout[i] = o[i];
  float* awout = a.a_w + static_cast<size_t>(env) * 3 * nj;
  for (int i = lane; i < 3 * nj; i += kWarp) awout[i] = aw[i];
}

}  // namespace

extern "C" {

const char* substep_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once a device, before the first launch there.
int substep_dyn_setup(int device) {
  int err = substep::setup_device(substep_dyn_kernel<8>, device);
  if (!err) err = substep::setup_device(substep_dyn_kernel<24>, device);
  if (!err) err = substep::setup_device(substep_dyn_kernel<32>, device);
  return err;
}

// Bytes of shared memory a block of the kernel takes at this shape.
size_t substep_dyn_block_bytes(int nb, int nv) {
  return sizeof(float) * DynLayout(nb, nv).words * substep::kWarps;
}

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
  const size_t smem = substep_dyn_block_bytes(nb, nv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nv <= 8)
    substep_dyn_kernel<8><<<grid, substep::kThreads, smem, st>>>(a);
  else if (nv <= 24)
    substep_dyn_kernel<24><<<grid, substep::kThreads, smem, st>>>(a);
  else
    substep_dyn_kernel<32><<<grid, substep::kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
