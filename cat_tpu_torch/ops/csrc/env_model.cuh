// What the three env-step kernels share (env_terms.cu, env_update.cu,
// env_obs.cu): the term kinds, the argument reader of their C interface,
// and device versions of the plain helpers they call:
//   sim/maths.py quat_rotate_inv, quat_yaw, quat_from_euler_zyx;
//   sim/terrain.py height_at (the bilinear lookup of the packed corner
//   table, height_grad_at's first output);
//   envs/constraints.py _hist_force_norm and the norms of the terms.
//
// Each follows its plain version's operations in their order, one rounding
// an operation: the kernels are built with -fmad=false (ops/env_step.py),
// so no multiply and add are contracted into one. A division by a Python
// number is a multiplication by its float reciprocal, as PyTorch's CUDA
// division by a scalar does it (the plain stage on the card); the caller
// passes the reciprocal, rounded as PyTorch rounds it. What may still
// differ from the plain stage on the card: PyTorch's own kernels may
// contract (a norm's sum of squares, a cross product), and its reductions
// may sum in another order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace envk {

constexpr int kThreads = 128;     // threads a block: one an env (terms,
                                  // update) or one an output (obs)
constexpr int kMaxDofs = 32;

// envs/cat.py KERNEL_TERMS, in its order; kGiven: columns a term's own
// PyTorch function computed, handed to the kernel
enum TermKind {
  kGiven = -1,
  kJointPosition = 0,
  kJointPositionMovingForward,
  kJointTorque,
  kJointVelocity,
  kJointAcceleration,
  kUpsideDown,
  kContact,
  kBaseOrientation,
  kAirTime,
  kNFootContact,
  kJointRange,
  kActionRate,
  kFootContactForce,
  kMinBaseHeight,
  kNoMove,
};
// a term's ints (envs/cat.py TERM_INTS): kind, first column, columns, the
// offset of its ids (or of its first given column), how many ids
constexpr int kTermInts = 5;

// ---------------------------------------------------------------------------
// the C interface: every launch function takes its pointers, ints and
// floats as three arrays, in the order its kernel's argument struct lists
// them (ops/env_step.py names each); the reader hands them out in turn

struct ArgReader {
  void* const* p;
  const int* i;
  const float* f;
  int np, ni, nf;
  int kp = 0, ki = 0, kf = 0;

  template <class T>
  T* ptr() {
    void* v = kp < np ? p[kp] : nullptr;
    ++kp;
    return static_cast<T*>(v);
  }
  int in() {
    const int v = ki < ni ? i[ki] : 0;
    ++ki;
    return v;
  }
  float fl() {
    const float v = kf < nf ? f[kf] : 0.f;
    ++kf;
    return v;
  }
  // every argument read, no more and no fewer
  bool exact() const { return kp == np && ki == ni && kf == nf; }
};

// ---------------------------------------------------------------------------
// scalar helpers with PyTorch's NaN rules

// torch.clamp(x, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}
// torch.amax's combine: a NaN wins
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float as_float(bool b) { return b ? 1.f : 0.f; }

struct V3 {
  float x, y, z;
};

// torch.linalg.vector_norm of 2 and 3 entries: the squares summed in order
__device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(x * x + y * y);
}
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// sim/maths.py quat_rotate(quat_conj(q), v): t = 2 (qv x v), v + qw t +
// qv x t, q = (w, x, y, z)
__device__ __forceinline__ V3 quat_rotate_inv(const float q[4], V3 v) {
  const V3 qv = {-q[1], -q[2], -q[3]};
  const float qw = q[0];
  const V3 c = cross(qv, v);
  const V3 t = {c.x * 2.f, c.y * 2.f, c.z * 2.f};
  const V3 u = cross(qv, t);
  return {(v.x + qw * t.x) + u.x, (v.y + qw * t.y) + u.y,
          (v.z + qw * t.z) + u.z};
}

// sim/maths.py quat_yaw
__device__ __forceinline__ float quat_yaw(const float q[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  return atan2f((w * z + x * y) * 2.f, 1.f - (y * y + z * z) * 2.f);
}

// sim/maths.py quat_from_euler_zyx
__device__ __forceinline__ void quat_from_euler_zyx(float roll, float pitch,
                                                    float yaw, float q[4]) {
  const float cr = cosf(roll * 0.5f), sr = sinf(roll * 0.5f);
  const float cp = cosf(pitch * 0.5f), sp = sinf(pitch * 0.5f);
  const float cy = cosf(yaw * 0.5f), sy = sinf(yaw * 0.5f);
  q[0] = cy * cp * cr + sy * sp * sr;
  q[1] = cy * cp * sr - sy * sp * cr;
  q[2] = cy * sp * cr + sy * cp * sr;
  q[3] = sy * cp * cr - cy * sp * sr;
}

// ---------------------------------------------------------------------------
// the heightfield (sim/terrain.py): the packed (R-1)(C-1) x 4 corner table
// read as float4, int32 cell indices; cells null: the plane (height 0)

struct Hfield {
  const float4* cells;
  int rows, cols;
  float inv_cell;            // 1 / cell, rounded as PyTorch's scalar division
  float half_rows, half_cols;  // R / 2, C / 2
  float max_u, max_v;        // R - 1.001, C - 1.001
};

// height_at: the grid coordinate clamped to [0, R - 1.001] (a NaN stays
// NaN and reads cell 0), the cell's four corners in one load, the bilinear
// blend in the plain version's order
__device__ __forceinline__ float height_at(const Hfield& hf, float x,
                                           float y) {
  if (hf.cells == nullptr) return 0.f;
  float u = (x * hf.inv_cell + hf.half_rows) - 0.5f;
  float v = (y * hf.inv_cell + hf.half_cols) - 0.5f;
  u = clampf(u, 0.f, hf.max_u);
  v = clampf(v, 0.f, hf.max_v);
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const int iu = isnan(u0) ? 0 : static_cast<int>(u0);
  const int iv = isnan(v0) ? 0 : static_cast<int>(v0);
  const float4 c = __ldg(hf.cells + (iu * (hf.cols - 1) + iv));
  const float gu = 1.f - fu, gv = 1.f - fv;
  return ((c.x * gu * gv + c.y * gu * fv) + c.z * fu * gv) + c.w * fu * fv;
}

// envs/constraints.py _hist_force_norm of one report slot: the largest
// force norm over the 3-deep history (N, 3, nreport, 3), a NaN winning
__device__ __forceinline__ float hist_norm(const float* hist, int nreport,
                                           int slot) {
  float m = -INFINITY;
  for (int h = 0; h < 3; ++h) {
    const float* f = hist + (h * nreport + slot) * 3;
    m = nanmax(m, norm3(f[0], f[1], f[2]));
  }
  return m;
}

}  // namespace envk
