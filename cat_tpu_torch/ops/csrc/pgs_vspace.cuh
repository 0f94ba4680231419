// Projected Gauss-Seidel in the space of the dofs (nv) instead of the
// contact rows (3nc), one warp per env: the machinery both contact kernels
// share (pgs_bj.cu, pgs_gs.cu). Each kernel keeps only its sweep order.
//
// The contact problem of one env: E (3nc x nv) contact rows, W = M^-1 E^T
// (nv x 3nc), b (3nc), bias / active (nc), mu, a warm start lam0 (3nc). The
// TPU kernels assemble the Delassus operator A = E W (3nc x 3nc), keep
// w = A lam, and add an impulse change back with A's rows serving as its
// columns (A is symmetric). Here A is never formed: w = W^T (E^T lam), so
// the warp keeps the generalized impulse u = E^T (lam * active), nv floats
// (the velocity change is M^-1 u), and computes
//   * five entries of A per active contact c (k = 3c): A[k,k], A[k+1,k+1],
//     A[k+2,k+2], A[k,k+2], A[k+1,k+2], each a dot product of nv terms;
//   * for each group of contacts the sweep visits (a block of block-Jacobi,
//     one contact of the serial sweep), the group's rows of w as
//     W[:, rows]^T u; then it projects each contact of the group (normal
//     clamp, tangent correction by A[k,k+2] dn, friction disc, omega, cfm)
//     and adds the impulse change back as u += E[rows]^T dlam.
// W^T E^T is A^T, so this is exactly the TPU kernels' rows-as-columns
// update, also where a table of nonzero dofs (masks) leaves A unsymmetric.
// A contact with active = 0 keeps lam = 0 and moves u by exact zeros, so it
// is left out: the warp builds the list of active contacts (a __ballot_sync
// over active) and sweeps over it. Only the summation order differs from
// the TPU kernels.
//
// Layout: envs leading, contiguous: E (N, 3nc, nv), W (N, nv, 3nc),
// b/lam0/out (N, 3nc) interleaved (t1, t2, n) per contact, bias/active
// (N, nc), mu (N,); nc <= 64, nv <= 32.
//
// Mapping: one warp runs one env's chain; lanes share data through shared
// memory and __syncwarp, with no block barrier. Lanes own rows for the dot
// products (several lanes a row when there are few rows, their partial sums
// joined by __shfl_xor_sync) and own dofs for the u update. A block holds a
// few warps; a persistent grid, sized at load time by the occupancy
// calculator, walks over the envs. Each warp stages its env's E and W into
// its slice of shared memory with two 1-D bulk copies (cp.async.bulk,
// completing on an mbarrier), issued for the next env as soon as the sweep
// of the current one is done, so the copy overlaps writing the result and
// gathering the next env's small operands. (A second copy of E and W, to
// copy during the sweep, halves the warps an SM holds at Solo12's shape,
// and the chain's latency needs the warps more.) E and W whose size or
// address is not a multiple of 16 bytes are copied by the lanes instead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vspace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxContacts = 64;
constexpr int kMaxDofs = 32;
constexpr int kMaxWarps = 4;               // warps a block
constexpr int kMaxThreads = kMaxWarps * kWarp;
// an active contact's record: 1/(A[k,k]+cfm), 1/(A[k+1,k+1]+cfm),
// 1/(A[k+2,k+2]+cfm), A[k,k+2], A[k+1,k+2], b[k..k+2], bias, active
constexpr int kRec = 10;

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Bytes of E (or W) of one env, as staged.
__host__ __device__ inline size_t operand_bytes(int nc, int nv) {
  return round16(static_cast<size_t>(12) * nc * nv);
}

// Bytes of one warp's slice of shared memory: an mbarrier, E and W, then
// u, lam, the group's rows of w, dlam, the records
// of the active contacts, their rows' dof masks, and four int arrays
// (active contact ids, each contact's slot in that list, each block's first
// slot and count).
__host__ __device__ inline size_t warp_bytes(int nc, int nv) {
  const size_t words =
      kWarp + 9 * static_cast<size_t>(nc) + kRec * nc + 3 * nc + 4 * nc;
  return 16 + 2 * operand_bytes(nc, nv) + round16(4 * words);
}

struct Operands {
  const float* E;
  const float* W;
  const float* b;
  const float* bias;
  const float* active;
  const float* mu;
  const float* lam0;
  const unsigned* masks;   // (3nc,) nonzero dofs of each row of E, or null
  float* out;
  int n_env, nc, nv, iterations;
  float cfm;
  int bulk;                // 1: stage by cp.async.bulk, 0: by the lanes
};

// ---------------------------------------------------------------------------
// bulk copies and mbarriers (PTX, sm_90)

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ inline void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// orders this thread's generic-proxy accesses of shared memory before the
// async proxy's (a bulk copy's) writes to it
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// ---------------------------------------------------------------------------
// dot products over a warp

// Row r of a batch of dot products: sum over k < nv with bit k of m set
// of a[k] * x[k * xs].
struct Dot {
  const float* a;
  const float* x;
  int xs;
  unsigned m;
};

// R dot products of nv terms. S lanes share a row (the largest power of two
// with R * S <= 32); lane p of a row sums terms p, p + S, ... and the S
// partial sums are joined by a butterfly of __shfl_xor_sync. `row(r)` gives
// the Dot of row r, `store(r, value)` takes its result (from one lane).
template <class Row, class Store>
__device__ inline void warp_dots(int R, int nv, int lane, Row row, Store store) {
  int S = kWarp;
  while (S > 1 && S * R > kWarp) S >>= 1;
  const int per = kWarp / S;
  for (int r0 = 0; r0 < R; r0 += per) {
    const int r = r0 + lane / S;
    const int p = lane & (S - 1);
    float acc = 0.f;
    if (r < R) {
      const Dot d = row(r);
      for (int k = p; k < nv; k += S)
        acc = fmaf((d.m >> k) & 1u ? d.a[k] : 0.f, d.x[k * d.xs], acc);
    }
    for (int o = S >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (r < R && p == 0) store(r, acc);
  }
}

// ---------------------------------------------------------------------------
// one warp, one env at a time

struct Warp {
  // shared memory
  uint64_t* bar;   // completes the bulk copies of E and W
  float* Es;       // (3nc, nv) E of the current env
  float* Ws;       // (nv, 3nc) W of the current env
  float* u;        // (32,) generalized impulse E^T (lam * active)
  float* lam;      // (3nc,) impulses of the active contacts, by slot
  float* wrow;     // (3nc,) the current group's rows of w = W^T u
  float* dl;       // (3nc,) the current group's impulse changes
  float* rec;      // (nc, kRec) records of the active contacts, by slot
  unsigned* rmask; // (3nc,) dof masks of their rows, by slot
  int* cid;        // (nc,) contact id of each slot
  int* slot_of;    // (nc,) slot of each contact, -1 if inactive
  int* blk_s0;     // (nc,) first slot of each block (block-Jacobi)
  int* blk_m;      // (nc,) active contacts of each block
  // registers
  int lane, nc, nv, n3, n_act;
  uint64_t amask;  // bit p: the contact at sweep position p is active
  float mu, ul;    // lane l < nv owns u[l]
  uint32_t phase;  // parity of the bulk copy to wait for

  __device__ Warp(unsigned char* base, const Operands& op, int lane_)
      : lane(lane_), nc(op.nc), nv(op.nv), n3(3 * op.nc), phase(0) {
    bar = reinterpret_cast<uint64_t*>(base);
    Es = reinterpret_cast<float*>(base + 16);
    Ws = reinterpret_cast<float*>(base + 16 + operand_bytes(nc, nv));
    u = reinterpret_cast<float*>(base + 16 + 2 * operand_bytes(nc, nv));
    lam = u + kWarp;
    wrow = lam + n3;
    dl = wrow + n3;
    rec = dl + n3;
    rmask = reinterpret_cast<unsigned*>(rec + kRec * nc);
    cid = reinterpret_cast<int*>(rmask + n3);
    slot_of = cid + nc;
    blk_s0 = slot_of + nc;
    blk_m = blk_s0 + nc;
  }

  // Start copying env's E and W into Es and Ws.
  __device__ void stage_in(const Operands& op, int env) {
    const size_t count = static_cast<size_t>(n3) * nv;
    const float* Eg = op.E + static_cast<size_t>(env) * count;
    const float* Wg = op.W + static_cast<size_t>(env) * count;
    if (op.bulk) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        const uint32_t bytes = static_cast<uint32_t>(count * 4);
        mbar_expect_tx(bar, 2 * bytes);
        bulk_copy(Es, Eg, bytes, bar);
        bulk_copy(Ws, Wg, bytes, bar);
      }
    } else {
      __syncwarp();
      for (size_t i = lane; i < count; i += kWarp) {
        Es[i] = Eg[i];
        Ws[i] = Wg[i];
      }
      __syncwarp();
    }
  }

  __device__ void wait_staged(const Operands& op) {
    if (op.bulk) {
      while (!mbar_try_wait(bar, phase)) {
      }
      phase ^= 1u;
    }
  }

  // The active contacts of env, in sweep order (perm(p) is the contact at
  // position p), with their b, bias, active and warm start.
  template <class Perm>
  __device__ void gather(const Operands& op, int env, Perm perm) {
    n_act = 0;
    amask = 0;
    const size_t e3 = static_cast<size_t>(env) * n3;
    for (int base = 0; base < nc; base += kWarp) {
      const int p = base + lane;
      const bool in = p < nc;
      const int c = in ? perm(p) : 0;
      const float a = in ? op.active[static_cast<size_t>(env) * nc + c] : 0.f;
      const unsigned bal = __ballot_sync(kFull, a != 0.f);
      if (in) {
        const int slot = n_act + __popc(bal & ((1u << lane) - 1u));
        if (a != 0.f) {
          float* r = rec + slot * kRec;
          const int k = 3 * c;
          r[5] = op.b[e3 + k];
          r[6] = op.b[e3 + k + 1];
          r[7] = op.b[e3 + k + 2];
          r[8] = op.bias[static_cast<size_t>(env) * nc + c];
          r[9] = a;
          lam[3 * slot] = op.lam0[e3 + k] * a;
          lam[3 * slot + 1] = op.lam0[e3 + k + 1] * a;
          lam[3 * slot + 2] = op.lam0[e3 + k + 2] * a;
          for (int t = 0; t < 3; ++t)
            rmask[3 * slot + t] = op.masks ? op.masks[k + t] : ~0u;
          cid[slot] = c;
          slot_of[c] = slot;
        } else {
          slot_of[c] = -1;
        }
      }
      amask |= static_cast<uint64_t>(bal) << base;
      n_act += __popc(bal);
    }
    mu = op.mu[env];
    __syncwarp();
  }

  // E[row, dof] of active slot j's row t, zero where the row's mask leaves
  // the dof out.
  __device__ float e_at(int j, int t, int dof) const {
    return (rmask[3 * j + t] >> dof) & 1u ? Es[(3 * cid[j] + t) * nv + dof]
                                          : 0.f;
  }

  // With E and W staged: the five entries of A of each active contact and
  // the warm start u = E^T (lam0 * active).
  __device__ void setup(float cfm) {
    // A[k+t, k+u] = E[k+t, :] . W[:, k+u]
    // for (t, u) = (0,0), (1,1), (2,2), (0,2), (1,2)
    warp_dots(
        5 * n_act, nv, lane,
        [&](int r) {
          const int j = r / 5, e = r - 5 * (r / 5);
          const int k = 3 * cid[j];
          const int t = e < 3 ? e : e - 3, u = e < 3 ? e : 2;
          return Dot{Es + (k + t) * nv, Ws + k + u, n3, rmask[3 * j + t]};
        },
        [&](int r, float val) { rec[(r / 5) * kRec + r % 5] = val; });
    __syncwarp();
    for (int j = lane; j < n_act; j += kWarp) {
      float* r = rec + j * kRec;
      r[0] = 1.f / (r[0] + cfm);
      r[1] = 1.f / (r[1] + cfm);
      r[2] = 1.f / (r[2] + cfm);
    }
    if (lane < nv) {
      float acc = 0.f;
      for (int j = 0; j < n_act; ++j) {
        acc = fmaf(e_at(j, 0, lane), lam[3 * j], acc);
        acc = fmaf(e_at(j, 1, lane), lam[3 * j + 1], acc);
        acc = fmaf(e_at(j, 2, lane), lam[3 * j + 2], acc);
      }
      ul = acc;
      u[lane] = acc;
    }
    __syncwarp();
  }

  // One group of the sweep: the m active contacts in slots s0 .. s0+m-1
  // project against the same w (Jacobi inside the group), then their
  // impulse changes move u.
  __device__ void group(int s0, int m, float omega) {
    warp_dots(
        3 * m, nv, lane,
        [&](int r) {
          return Dot{u, Ws + 3 * cid[s0 + r / 3] + r % 3, n3, ~0u};
        },
        [&](int r, float val) { wrow[r] = val; });
    __syncwarp();
    for (int j = lane; j < m; j += kWarp) {
      const float* r = rec + (s0 + j) * kRec;
      float* l = lam + 3 * (s0 + j);
      const float* w = wrow + 3 * j;
      const float act = r[9];
      const float l0 = l[0], l1 = l[1], l2 = l[2];
      const float vn = (w[2] + r[7]) + r[8];
      const float ln_new = fmaxf(l2 - omega * vn * r[2], 0.f) * act;
      const float dn = ln_new - l2;
      const float vt1 = (w[0] + r[5]) + r[3] * dn;
      const float vt2 = (w[1] + r[6]) + r[4] * dn;
      const float lt1 = l0 - omega * vt1 * r[0];
      const float lt2 = l1 - omega * vt2 * r[1];
      const float tn = sqrtf(lt1 * lt1 + lt2 * lt2 + 1e-12f);
      const float scale = fminf(1.f, mu * ln_new / tn) * act;
      const float n1 = lt1 * scale, n2 = lt2 * scale;
      dl[3 * j] = n1 - l0;
      dl[3 * j + 1] = n2 - l1;
      dl[3 * j + 2] = dn;
      l[0] = n1;
      l[1] = n2;
      l[2] = ln_new;
    }
    __syncwarp();
    if (lane < nv) {
      float acc = ul;
      for (int j = 0; j < m; ++j) {
        acc = fmaf(e_at(s0 + j, 0, lane), dl[3 * j], acc);
        acc = fmaf(e_at(s0 + j, 1, lane), dl[3 * j + 1], acc);
        acc = fmaf(e_at(s0 + j, 2, lane), dl[3 * j + 2], acc);
      }
      ul = acc;
      u[lane] = acc;
    }
    __syncwarp();
  }

  // lam of every row: the sweep's for active contacts, 0 for the others.
  __device__ void write_out(const Operands& op, int env) {
    float* o = op.out + static_cast<size_t>(env) * n3;
    for (int r = lane; r < n3; r += kWarp) {
      const int c = r / 3;
      const int s = slot_of[c];
      o[r] = s >= 0 ? lam[3 * s + r - 3 * c] : 0.f;
    }
    __syncwarp();
  }
};

// The persistent loop of one warp over its envs: gather, wait for E and W,
// set up, `sweeps(w)`, start the next env's copy, write out.
template <class Perm, class Sweeps>
__device__ inline void solve_envs(const Operands& op, Perm perm, Sweeps sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  Warp w(smem + warp * warp_bytes(op.nc, op.nv), op, lane);
  if (op.bulk && lane == 0) {
    mbar_init(w.bar);
    fence_mbar_init();
  }
  __syncwarp();
  const int first = blockIdx.x * nwarps + warp;
  const int stride = gridDim.x * nwarps;
  if (first < op.n_env) w.stage_in(op, first);
  for (int env = first; env < op.n_env; env += stride) {
    w.gather(op, env, perm);
    w.wait_staged(op);
    w.setup(op.cfm);
    sweeps(w);
    if (env + stride < op.n_env) w.stage_in(op, env + stride);
    w.write_out(op, env);
  }
}

// ---------------------------------------------------------------------------
// host side

// Checks the C entry points make before a launch.
inline bool shape_ok(int nc, int nv, int warps) {
  return nc >= 1 && nc <= kMaxContacts && nv >= 1 && nv <= kMaxDofs &&
         warps >= 1 && warps <= kMaxWarps;
}

// Once a device: lets `kernel` use all the shared memory a block may opt
// into, and reports the device's SM count. Leaves the current device as
// it found it.
template <class Kernel>
int setup_device(Kernel kernel, int device, int* num_sms) {
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
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Blocks of `warps` warps an SM can hold with `smem` bytes of shared memory
// each (registers and shared memory both counted).
template <class Kernel>
int occupancy(Kernel kernel, int device, int warps, size_t smem, int* blocks) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      warps * kWarp, smem);
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Launches on `stream` (of `device`, which must be current), without a
// synchronisation or an allocation.
template <class Kernel, class... Args>
int launch(Kernel kernel, int grid, int warps, const Operands& op,
           void* stream, Args... args) {
  if (op.n_env == 0) return 0;
  const size_t smem = warps * warp_bytes(op.nc, op.nv);
  kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      op, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vspace
