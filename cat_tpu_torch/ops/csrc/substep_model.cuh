// What both substep kernels share (substep_dyn.cu, contact_rows.cu): the
// layout of the model's tables, packed once a model and device by
// ops/substep.py (`model_tables`), and small vector helpers.
//
// The tables: one float table and one int table, each the concatenation
// of the parts below in this order, every part row-major.
//   floats: base_acc (3), joint_pos (nb, 3), joint_rot (nb, 3, 3),
//           joint_axis (nb, 3), mass (nb), com (nb, 3), inertia (nb, 3, 3),
//           armature (nv; 0 for the base's six), effort_limit (nj),
//           cand_offset (nct, 3), cand_radius (nct), pair_p0_a, pair_p1_a,
//           pair_p0_b, pair_p1_b (npair, 3 each), pair_rsum (npair)
//   ints:   parent (nb), depth (nb), anc (nb: bit j set when joint j is
//           on the chain from the base to the body), cand_body (nct),
//           pair_body_a (npair), pair_body_b (npair)
// The dynamics parts come first, so the dynamics kernel needs only nb and
// nv to find them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace substep {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDofs = 32;      // a lane owns each dof
constexpr int kMaxContacts = 64;
constexpr int kWarps = 4;         // warps a block, one env a warp
constexpr int kThreads = kWarps * kWarp;
// blocks an SM must hold (64 registers a thread at most): 4096 envs are
// 1024 blocks, one wave over 132 SMs at 8 blocks an SM
constexpr int kBlocksPerSM = 8;

struct FloatTable {
  int base_acc, joint_pos, joint_rot, joint_axis, mass, com, inertia,
      armature, effort, cand_offset, cand_radius, p0a, p1a, p0b, p1b, rsum;
  __host__ __device__ FloatTable(int nb, int nv, int nct, int npair) {
    const int nj = nb - 1;
    int o = 0;
    base_acc = o;    o += 3;
    joint_pos = o;   o += 3 * nb;
    joint_rot = o;   o += 9 * nb;
    joint_axis = o;  o += 3 * nb;
    mass = o;        o += nb;
    com = o;         o += 3 * nb;
    inertia = o;     o += 9 * nb;
    armature = o;    o += nv;
    effort = o;      o += nj;
    cand_offset = o; o += 3 * nct;
    cand_radius = o; o += nct;
    p0a = o;         o += 3 * npair;
    p1a = o;         o += 3 * npair;
    p0b = o;         o += 3 * npair;
    p1b = o;         o += 3 * npair;
    rsum = o;
  }
};

struct IntTable {
  int parent, depth, anc, cand_body, pair_a, pair_b;
  __host__ __device__ IntTable(int nb, int nct, int npair) {
    parent = 0;
    depth = nb;
    anc = 2 * nb;
    cand_body = 3 * nb;
    pair_a = cand_body + nct;
    pair_b = pair_a + npair;
  }
};

// ---------------------------------------------------------------------------
// 3-vectors and 3x3 matrices (row-major float[9]) in registers

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// A v, A row-major 3x3
__device__ __forceinline__ V3 mv(const float* A, V3 v) {
  return {A[0] * v.x + A[1] * v.y + A[2] * v.z,
          A[3] * v.x + A[4] * v.y + A[5] * v.z,
          A[6] * v.x + A[7] * v.y + A[8] * v.z};
}
// column c of A
__device__ __forceinline__ V3 col(const float* A, int c) {
  return {A[c], A[3 + c], A[6 + c]};
}
// C = A B
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}
// C = A B^T
__device__ __forceinline__ void mmt(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] +
                     A[3 * i + 2] * B[3 * j + 2];
}

// A 4-byte copy from device memory to shared memory that does not wait
// (cp.async): a lane issues all its copies, then copy_wait waits for them
// and makes every lane's visible to the warp.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
#endif
}
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncwarp();
}

// torch.clamp's semantics: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The phase-clock build (nvcc -DSUBSTEP_PHASE_CLOCKS, a library of its
// own; the production library never defines the macro): lane 0 of each
// warp adds the clock64() cycles of each phase of its env to
// phase_cycles[env][k] (the phases are each kernel's, in its header), once
// the whole warp has left the phase, by a reduction that does not wait on
// memory. In the production build `lap` is empty.
constexpr int kPhaseSlots = 8;
#ifdef SUBSTEP_PHASE_CLOCKS
__device__ unsigned long long* phase_cycles;  // (n_env, kPhaseSlots) or null
__device__ __forceinline__ long long phase_now() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct PhaseClock {
  unsigned long long* out;
  long long last;
  __device__ PhaseClock(int env, int lane)
      : out(lane == 0 && phase_cycles ? phase_cycles + env * kPhaseSlots
                                      : nullptr),
        last(phase_now()) {}
  __device__ void lap(int k) {
    __syncwarp();
    if (out) {
      const long long t = phase_now();
      atomicAdd(out + k, static_cast<unsigned long long>(t - last));
      last = t;
    }
  }
};
inline int set_phase_cycles(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(phase_cycles, &buf, sizeof(void*)));
}
#else
struct PhaseClock {
  __device__ PhaseClock(int, int) {}
  __device__ void lap(int) {}
};
#endif

// Blocks of `kernel` an SM holds with `smem` bytes of dynamic shared memory
// a block, or -1 on an error.
template <class Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                       smem) == cudaSuccess
             ? n
             : -1;
}

// Lets `kernel` use all the shared memory a block may opt into on
// `device`; leaves the current device as it found it.
template <class Kernel>
int setup_device(Kernel kernel, int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace substep
