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

constexpr int kBlockThreads = 256;  // at most, a block of env_terms and
                                    // env_update (ops/env_step.py THREADS)
constexpr int kObsThreads = 512;  // at most, a block of env_obs
                                  // (ops/env_step.py OBS_THREADS_MAX)
constexpr int kMaxSlots = 64;     // report slots env_terms stages: a 64-bit
                                  // mask of them (envs/cat.py MAX_SLOTS)
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

// height_at in two halves, so that a caller can have several lookups'
// loads in flight: cell_of, the grid coordinate clamped to [0, R - 1.001]
// (a NaN stays NaN and reads cell 0), the cell's row of the corner table
// and the fractions; blend, the bilinear blend of the cell's four corners
// (one load) in the plain version's order
struct Cell {
  int index;
  float fu, fv;
};
__device__ __forceinline__ Cell cell_of(const Hfield& hf, float x, float y) {
  float u = (x * hf.inv_cell + hf.half_rows) - 0.5f;
  float v = (y * hf.inv_cell + hf.half_cols) - 0.5f;
  u = clampf(u, 0.f, hf.max_u);
  v = clampf(v, 0.f, hf.max_v);
  const float u0 = floorf(u), v0 = floorf(v);
  const int iu = isnan(u0) ? 0 : static_cast<int>(u0);
  const int iv = isnan(v0) ? 0 : static_cast<int>(v0);
  return {iu * (hf.cols - 1) + iv, u - u0, v - v0};
}
__device__ __forceinline__ float blend(float4 c, float fu, float fv) {
  const float gu = 1.f - fu, gv = 1.f - fv;
  return ((c.x * gu * gv + c.y * gu * fv) + c.z * fu * gv) + c.w * fu * fv;
}
__device__ __forceinline__ float height_at(const Hfield& hf, float x,
                                           float y) {
  if (hf.cells == nullptr) return 0.f;
  const Cell c = cell_of(hf, x, y);
  return blend(__ldg(hf.cells + c.index), c.fu, c.fv);
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

// ---------------------------------------------------------------------------
// A block owns `envs` consecutive envs (env_terms, env_update): each input
// is one contiguous slab of their rows, staged into shared memory with
// copies that do not wait (cp.async), 16 bytes each where the slab's
// address allows, so that all of a block's loads are in flight at once;
// each output leaves shared memory as one contiguous slab, in 16-byte
// stores where it can.

// cp.async of 16 and of 4 bytes from device memory to shared memory
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *static_cast<float4*>(dst) = *static_cast<const float4*>(src);
#endif
}
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
// waits for every copy this thread issued; a __syncthreads() after it
// makes every thread's visible to the block
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A warp copies a slab (its lanes over the slab's 16-byte pieces, 4-byte
// words where an address is not 16-byte aligned); the warps of the block
// take the slabs of a list in turn (stage_all, unstage_all), so the slabs'
// copies are issued side by side.

// stage `words` 4-byte words from src (device memory) to dst (shared
// memory), by the calling warp
__device__ __forceinline__ void stage(void* dst, const void* src, int words) {
  const int lane = threadIdx.x & 31;
  int head = 0;
  if (aligned16(src) && aligned16(dst)) {
    head = words & ~3;
    for (int i = 4 * lane; i < head; i += 128)
      copy16(static_cast<float*>(dst) + i, static_cast<const float*>(src) + i);
  }
  for (int i = head + lane; i < words; i += 32)
    copy4(static_cast<float*>(dst) + i, static_cast<const float*>(src) + i);
}

// stage `count` bytes (flags, touchdown), by the calling warp: whole words
// where src is 4-byte aligned, the rest byte by byte (loads that wait; at
// most 3)
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int count) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    head = count & ~3;
    stage(dst, src, head >> 2);
  }
  for (int i = head + static_cast<int>(threadIdx.x & 31); i < count; i += 32)
    dst[i] = src[i];
}

// write `words` 4-byte words from src (shared memory) to dst (device
// memory), by the calling warp
__device__ __forceinline__ void unstage(void* dst, const void* src,
                                        int words) {
  const int lane = threadIdx.x & 31;
  int head = 0;
  if (aligned16(dst) && aligned16(src)) {
    head = words & ~3;
    for (int i = 4 * lane; i < head; i += 128)
      *reinterpret_cast<float4*>(static_cast<float*>(dst) + i) =
          *reinterpret_cast<const float4*>(static_cast<const float*>(src) +
                                           i);
  }
  for (int i = head + lane; i < words; i += 32)
    static_cast<float*>(dst)[i] = static_cast<const float*>(src)[i];
}
__device__ __forceinline__ void unstage_bytes(unsigned char* dst,
                                              const unsigned char* src,
                                              int count) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    head = count & ~3;
    unstage(dst, src, head >> 2);
  }
  for (int i = head + static_cast<int>(threadIdx.x & 31); i < count; i += 32)
    dst[i] = src[i];
}

// one slab by the whole block: each warp its share of 16-byte pieces
__device__ __forceinline__ void stage_block(void* dst, const void* src,
                                            int words) {
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int share = (words + 4 * warps - 1) / (4 * warps) * 4;
  const int at = w * share;
  if (at < words)
    stage(static_cast<float*>(dst) + at, static_cast<const float*>(src) + at,
          min(share, words - at));
}
__device__ __forceinline__ void unstage_block(void* dst, const void* src,
                                              int words) {
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int share = (words + 4 * warps - 1) / (4 * warps) * 4;
  const int at = w * share;
  if (at < words)
    unstage(static_cast<float*>(dst) + at, static_cast<const float*>(src) + at,
            min(share, words - at));
}

// The slabs a block stages or writes back, listed by the launch function
// on the host: a loop over the list is one copy of the copy code, where a
// call a slab would inline one each. A slab's `ptr` is env 0's row in
// device memory (a table: the whole table), `smem` its region (word
// offset), `row` its words a row (bytes, for bytes), `kind` a kSlab* mask.
constexpr int kSlabBytes = 1, kSlabTable = 2;
struct Slab {
  const void* ptr;
  int smem;
  short row, kind;
};
template <int N>
struct Slabs {
  Slab s[N];
  int n = 0;
  bool full = false;
  void add(const void* ptr, int smem, int row, int kind = 0) {
    if (ptr == nullptr) return;
    if (n == N || row > 32767) {
      full = true;
      return;
    }
    s[n++] = {ptr, smem, static_cast<short>(row), static_cast<short>(kind)};
  }
};

// every slab of `in` into the block's shared memory S: the rows of the
// block's ne envs from env r0 on; a warp a slab in turn
template <int N>
__device__ __forceinline__ void stage_all(float* S, const Slabs<N>& in,
                                          size_t r0, int ne) {
  for (int k = threadIdx.x >> 5; k < in.n; k += blockDim.x >> 5) {
    const Slab sl = in.s[k];
    const bool table = sl.kind & kSlabTable;
    const size_t at = table ? 0 : r0 * sl.row;
    const int count = table ? sl.row : ne * sl.row;
    if (sl.kind & kSlabBytes)
      stage_bytes(reinterpret_cast<unsigned char*>(S + sl.smem),
                  static_cast<const unsigned char*>(sl.ptr) + at, count);
    else
      stage(S + sl.smem, static_cast<const float*>(sl.ptr) + at, count);
  }
}
// every slab of `out` from the block's shared memory S to its rows; a warp
// a slab in turn
template <int N>
__device__ __forceinline__ void unstage_all(const float* S,
                                            const Slabs<N>& out, size_t r0,
                                            int ne) {
  for (int k = threadIdx.x >> 5; k < out.n; k += blockDim.x >> 5) {
    const Slab sl = out.s[k];
    const size_t at = r0 * sl.row;
    const int count = ne * sl.row;
    if (sl.kind & kSlabBytes)
      unstage_bytes(
          static_cast<unsigned char*>(const_cast<void*>(sl.ptr)) + at,
          reinterpret_cast<const unsigned char*>(S + sl.smem), count);
    else
      unstage(static_cast<float*>(const_cast<void*>(sl.ptr)) + at,
              S + sl.smem, count);
  }
}

// x / d for 0 <= x, d < 2^20, rd = 1 / d in float: the float estimate is
// within one of the quotient, and one step corrects it
__device__ __forceinline__ int small_div(int x, int d, float rd) {
  int q = static_cast<int>(static_cast<float>(x) * rd);
  if (q * d > x)
    --q;
  else if ((q + 1) * d <= x)
    ++q;
  return q;
}

// The entries of a rows x cols tile dealt to the block's threads in turn:
// thread t takes entries t, t + blockDim.x, ..., walked without a division
// (or thread t of nt dealt threads, 0 <= t < nt: entries t, t + nt, ...)
struct TileWalk {
  int r, c, dr, dc, rows, cols;
  __device__ TileWalk(int rows_, int cols_)
      : TileWalk(rows_, cols_, threadIdx.x, blockDim.x) {}
  __device__ TileWalk(int rows_, int cols_, int t, int nt)
      : rows(rows_), cols(cols_) {
    const float rc = 1.f / static_cast<float>(cols > 0 ? cols : 1);
    dr = cols > 0 ? small_div(nt, cols, rc) : 0;
    dc = nt - dr * cols;
    r = cols > 0 ? small_div(t, cols, rc) : rows;
    c = t - r * cols;
  }
  __device__ bool more() const { return r < rows; }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// f(row, col) over the tile, each thread's entries in turn
template <class F>
__device__ __forceinline__ void for_tile(int rows, int cols, F f) {
  for (TileWalk w(rows, cols); w.more(); w.next()) f(w.r, w.c);
}
// the same, the tile dealt to nt threads of which the caller is thread t
template <class F>
__device__ __forceinline__ void for_tile(int rows, int cols, int t, int nt,
                                         F f) {
  for (TileWalk w(rows, cols, t, nt); w.more(); w.next()) f(w.r, w.c);
}

// The columns of a rows x cols tile dealt to the block's threads: with
// cols <= blockDim.x the threads form blockDim.x / cols groups, and thread
// t takes column t % cols and the rows of its group (g, g + groups, ...);
// with more columns, a column a thread in turn and every row. A thread
// reads what its column needs once and walks the rows.
struct ColumnDeal {
  int first, step, group, groups;
  __device__ explicit ColumnDeal(int cols) {
    const int nt = blockDim.x, t = threadIdx.x;
    const int c = cols > 0 ? cols : 1;
    groups = c <= nt ? nt / c : 1;
    group = t / c;
    first = t - group * c;
    step = c <= nt ? c : nt;
  }
  __device__ bool active() const { return group < groups; }
};

// The shared-memory layout of a block: regions in order, each a multiple
// of 16 bytes (ops/env_step.py env_geometry counts the same).
struct Layout {
  int words = 0;
  __host__ __device__ int take(int n) {   // n 4-byte words
    const int at = words;
    words += (n + 3) & ~3;
    return at;
  }
  __host__ __device__ int take_bytes(int n) { return take((n + 3) >> 2); }
};

// ---------------------------------------------------------------------------
// The phase-clock build (nvcc -DENV_PHASE_CLOCKS, a library of its own; the
// production library never defines the macro): thread 0 of each block adds
// the clock64() cycles of each phase of its block to
// phase_cycles[block][k] (the phases are each kernel's, in its header),
// once every thread of the block has left the phase (a __syncthreads() a
// lap, which the production build does not have), by an atomic that does
// not wait on memory. In the production build `lap` is empty.
constexpr int kPhaseSlots = 8;
#ifdef ENV_PHASE_CLOCKS
__device__ unsigned long long* phase_cycles;  // (blocks, kPhaseSlots) or null
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
  __device__ PhaseClock()
      : out(threadIdx.x == 0 && phase_cycles
                ? phase_cycles + static_cast<size_t>(blockIdx.x) * kPhaseSlots
                : nullptr),
        last(phase_now()) {}
  __device__ void lap(int k) {
    __syncthreads();
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
  __device__ void lap(int) {}
};
#endif

}  // namespace envk
