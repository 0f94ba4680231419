// The contact stage of one physics substep, one warp per env: the terrain
// candidates (plane or heightfield) and the self-collision capsule pairs,
// their signed distances phi and contact frames, and the contact problem's
// rows E (3nc x nv, interleaved t1, t2, n a contact), W = M^-1 E^T
// (nv x 3nc) and b = E v_free, in the layout the PGS kernels read
// (pgs_bj.cu, pgs_gs.cu).
//
// Replaces no Pallas kernel: it is the counterpart of the contact half of
// the JAX package's lanes substep (cat_tpu/sim/engine_lanes.py:38
// _substep_pre_lanes, through dynamics_lanes.detect_contacts_lanes :505
// and detect_pair_contacts_lanes :439; the heightfield's gap is
// cat_tpu/sim/terrain.py surface_gap :148 over its packed corner table).
// Its plain version is sim/engine.py contact_stage.
//
// What bounds it on an H100: the bytes it must write. Per env at Solo12's
// shape it reads the kinematics, M^-1 and v_free (~2.2 KB) and writes E
// and W (2 x 108 x 18 floats), b, phi and the frames (~17 KB). At N =
// 4096 that is ~80 MB (24 us at 3.35 TB/s). All 4096 warps are resident
// at once (8 blocks of 4 warps an SM) and move through the same phases
// together, so the store stream only starts once the rows do; what comes
// before it, and each warp's instruction stream, is what the design cuts.
// The first design read its operands one dependent load after another
// and built every row over all dof slots, half of them zeros. This one:
//   * issues every operand's copy to the warp's slice of shared memory at
//     once (cp.async, 4 bytes a copy; M^-1 lands transposed) and waits
//     once;
//   * a lane a contact (two passes for 36) finds the contact's points,
//     phi and frame; on a heightfield the five probes of the deepest
//     column, each a bilinear height and gradient from one 16-byte read of
//     the packed corner table, rounded op by op as the plain version's on
//     the CPU, with its clamped, NaN-safe indexing (unchanged);
//   * then a pass of 32 rows at a time, a lane a row, on the row's nonzero
//     dofs alone (the base's six and the ancestor joints of the contact's
//     body or bodies, as pgs.contact_row_dofs): the base's entries in
//     closed form (f for the translation, R0 e_k . ((x - o0) x f) for the
//     rotation), a joint's as a_j . ((x - p_j) x f) from its axis and
//     origin packed in two float4, a pair's two points subtracted; they go
//     into the pass's block of E, staged in shared memory and zeroed
//     first, and b's entry sums over them;
//   * W's column is the sum over the same nonzero dofs l of E[r][l] times
//     column l of M^-1 (M^-1 kept transposed, rows padded to four floats,
//     read four at a time), kK = 12 dofs at a time in registers (chunks
//     of 12 for nv > 12), and leaves the registers
//     as it stands: a pass's lanes store 32 consecutive floats of a row of
//     W, one 128-byte line a store (a shared tile of W would not fit
//     beside the rest at 8 blocks an SM); the pass's block of E, 32 rows
//     contiguous in E, leaves in 16-byte stores.
// At most 64 registers and no spills: an SM holds 8 blocks and 4096 envs
// run in one wave. The
// summation order is fixed and no atomics are used: a launch is
// deterministic bit for bit. Measured (chip_smoke.py kernel-dyn, H100
// 80GB HBM3 at 700 W): 0.057 ms on flat states, 42% of the byte bound
// (the first design 0.067 ms, 36%), most of it in the rows and W phases,
// which carry the store stream.
//
// Phases of the phase-clock build (-DSUBSTEP_PHASE_CLOCKS): detection (the
// operands' copies, points, phi and frames, and the frames' write), rows
// (E's nonzero entries and b), W (W's columns and their stores), writes
// (E's staged blocks); the last three summed over the passes.
//
// Layout: envs leading and contiguous: R (N, nb, 3, 3), o (N, nb, 3), a_w
// (N, nj, 3), minv (N, nv, nv), v_free (N, nv); hfield ((R-1)(C-1), 4)
// packed corners or null for the plane; out E (N, 3nc, nv), W (N, nv,
// 3nc), b (N, 3nc), phi (N, nc), frame (N, nc, 3, 3) or null (the plane
// without pairs: the world frame); nv <= 32, nc <= 64.

#include "substep_model.cuh"

namespace {

using namespace substep;

struct ConArgs {
  const float* R;
  const float* o;
  const float* a_w;
  const float* minv;
  const float* v_free;
  const float* ftab;
  const int* itab;
  const float4* hfield;      // null: the z = 0 plane
  float* E;
  float* W;
  float* b;
  float* phi;
  float* frame;              // null: not written
  int n_env, nb, nv, nct, npair, hrows, hcols;
  float cell, umax, vmax;    // umax = R - 1.001, vmax = C - 1.001
};

// One warp's slice of shared memory, in floats: M^-1 transposed (row l is
// column l of M^-1, padded to ld = nv rounded up to 4 with zeros, for
// float4 reads), a pass's 32 rows of E, each joint's world axis and
// origin (2 float4), R, o, v_free, each contact's points (pa: the
// candidate's centre or body A's closest point; pb: body B's) and frame.
struct ConLayout {
  int ld, MinvT, rows, jt, R, o, vf, pa, pb, fr, words;
  __host__ __device__ ConLayout(int nb, int nv, int nc) {
    ld = (nv + 3) & ~3;
    int p = 0;
    MinvT = p; p += nv * ld;
    rows = p;  p += kWarp * nv;    // offsets a multiple of 4 so far
    jt = p;    p += 8 * (nb - 1);
    R = p;     p += 9 * nb;
    o = p;     p += 3 * nb;
    vf = p;    p += nv;
    pa = p;    p += 3 * nc;
    pb = p;    p += 3 * nc;
    fr = p;    p += 9 * nc;
    words = (p + 3) & ~3;
  }
};

// Bilinear height and in-cell gradient at world (x, y) (sim/terrain.py
// height_grad_at), each operation rounded as the plain version's.
__device__ void height_grad(const ConArgs& a, float x, float y, float& h,
                            float& gx, float& gy) {
  float u = __fsub_rn(__fadd_rn(__fdiv_rn(x, a.cell), 0.5f * a.hrows), 0.5f);
  float v = __fsub_rn(__fadd_rn(__fdiv_rn(y, a.cell), 0.5f * a.hcols), 0.5f);
  u = clampf(u, 0.f, a.umax);
  v = clampf(v, 0.f, a.vmax);
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = __fsub_rn(u, u0), fv = __fsub_rn(v, v0);
  // a NaN position reads cell 0 and gives NaN values
  const int iu = isnan(u0) ? 0 : static_cast<int>(u0);
  const int iv = isnan(v0) ? 0 : static_cast<int>(v0);
  const float4 c = a.hfield[static_cast<size_t>(iu) * (a.hcols - 1) + iv];
  const float gu = __fsub_rn(1.f, fu), gv = __fsub_rn(1.f, fv);
  h = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(c.x, gu), gv),
                          __fmul_rn(__fmul_rn(c.y, gu), fv)),
                __fmul_rn(__fmul_rn(c.z, fu), gv)),
      __fmul_rn(__fmul_rn(c.w, fu), fv));
  gx = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(c.z, c.x), gv),
                           __fmul_rn(__fsub_rn(c.w, c.y), fv)), a.cell);
  gy = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(c.y, c.x), gu),
                           __fmul_rn(__fsub_rn(c.w, c.z), fu)), a.cell);
}

// The deepest of five columns (the centre and four axis offsets of r) under
// the sphere centre p (sim/terrain.py surface_gap): its gap d (radius not
// subtracted) and surface normal n. The first NaN gap wins, else the first
// smallest, as torch.argmin.
__device__ void surface_gap(const ConArgs& a, V3 p, float r, float& d, V3& n) {
  const float ox[5] = {0.f, 1.f, -1.f, 0.f, 0.f};
  const float oy[5] = {0.f, 0.f, 0.f, 1.f, -1.f};
  int best = -1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float x = __fadd_rn(p.x, __fmul_rn(ox[i], r));
    const float y = __fadd_rn(p.y, __fmul_rn(oy[i], r));
    float h, gx, gy;
    height_grad(a, x, y, h, gx, gy);
    const float inv = __fdiv_rn(
        1.f, __fsqrt_rn(__fadd_rn(__fadd_rn(1.f, __fmul_rn(gx, gx)),
                                  __fmul_rn(gy, gy))));
    const V3 ni = {__fmul_rn(-gx, inv), __fmul_rn(-gy, inv), inv};
    const float di = __fadd_rn(
        __fsub_rn(__fmul_rn(-ni.x, __fsub_rn(x, p.x)),
                  __fmul_rn(ni.y, __fsub_rn(y, p.y))),
        __fmul_rn(ni.z, __fsub_rn(p.z, h)));
    if (best < 0 || (!isnan(d) && (isnan(di) || di < d))) {
      best = i;
      d = di;
      n = ni;
    }
  }
}

__device__ __forceinline__ V3 normalise(V3 v) {
  return scale(1.f / sqrtf(dot(v, v)), v);
}

// The dofs of W's column a lane holds in registers at a time (a multiple
// of 4; 12 keeps the kernel at 64 registers without spills).
constexpr int kK = 12;

// acc[k] += M^-1[k0 + k][l] v for k < min(kK, nv - k0): column l of M^-1
// (row l of MinvT from k0) read four floats at a time
__device__ __forceinline__ void axpy(float* acc, const float* MinvT_l,
                                     float v, int left) {
  const float4* m = reinterpret_cast<const float4*>(MinvT_l);
#pragma unroll
  for (int q = 0; q < kK / 4; ++q)
    if (4 * q < left) {
      const float4 m4 = m[q];
      acc[4 * q] += m4.x * v;
      acc[4 * q + 1] += m4.y * v;
      acc[4 * q + 2] += m4.z * v;
      acc[4 * q + 3] += m4.w * v;
    }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
contact_rows_kernel(const ConArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= a.n_env) return;        // the whole warp
  PhaseClock clk(env, lane);
  const int nb = a.nb, nv = a.nv, nj = nb - 1, nct = a.nct;
  const int nc = nct + a.npair, n3 = 3 * nc;
  const ConLayout Ly(nb, nv, nc);
  const FloatTable ft(nb, nv, nct, a.npair);
  const IntTable it(nb, nct, a.npair);
  const float* tf = a.ftab;
  const int* ti = a.itab;
  float* s = smem + static_cast<size_t>(warp) * Ly.words;
  float* R = s + Ly.R;
  float* o = s + Ly.o;
  float4* jt = reinterpret_cast<float4*>(s + Ly.jt);
  float* MinvT = s + Ly.MinvT;
  float* vf = s + Ly.vf;
  float* pa = s + Ly.pa;
  float* pb = s + Ly.pb;
  float* fr = s + Ly.fr;
  float* rows = s + Ly.rows;
  const int ld = Ly.ld;

  // the operands, every copy in flight at once (a_w lands in the rows'
  // staging, free until the first pass); M^-1 read row by row, stored
  // transposed
  const size_t e = static_cast<size_t>(env);
  float* aw = rows;
  for (int i = lane; i < 9 * nb; i += kWarp)
    copy4(R + i, a.R + e * 9 * nb + i);
  for (int i = lane; i < 3 * nb; i += kWarp)
    copy4(o + i, a.o + e * 3 * nb + i);
  for (int i = lane; i < 3 * nj; i += kWarp)
    copy4(aw + i, a.a_w + e * 3 * nj + i);
  for (int i = lane, r = lane / nv, c = lane % nv; i < nv * nv; i += kWarp) {
    copy4(MinvT + c * ld + r, a.minv + e * nv * nv + i);
    c += kWarp;
    while (c >= nv) {
      c -= nv;
      ++r;
    }
  }
  for (int i = lane; i < nv; i += kWarp) copy4(vf + i, a.v_free + e * nv + i);
  for (int i = lane; i < nv * (ld - nv); i += kWarp) {
    const int pad = ld - nv;
    MinvT[(i / pad) * ld + nv + i % pad] = 0.f;
  }
  copy_wait();
  for (int j = lane; j < nj; j += kWarp) {
    jt[2 * j] = make_float4(aw[3 * j], aw[3 * j + 1], aw[3 * j + 2],
                            o[3 * (j + 1)]);
    jt[2 * j + 1] = make_float4(o[3 * (j + 1) + 1], o[3 * (j + 1) + 2], 0.f,
                                0.f);
  }
  __syncwarp();

  // a lane a terrain candidate: the sphere centre, phi, the frame
  for (int c = lane; c < nct; c += kWarp) {
    const int body = ti[it.cand_body + c];
    const V3 x = add(ld3(o + 3 * body),
                     mv(R + 9 * body, ld3(tf + ft.cand_offset + 3 * c)));
    const float rad = tf[ft.cand_radius + c];
    st3(pa + 3 * c, x);
    float* f = fr + 9 * c;
    if (a.hfield == nullptr) {
      a.phi[e * nc + c] = x.z - rad;
      st3(f, V3{1.f, 0.f, 0.f});
      st3(f + 3, V3{0.f, 1.f, 0.f});
      st3(f + 6, V3{0.f, 0.f, 1.f});
    } else {
      float d;
      V3 n;
      surface_gap(a, x, rad, d, n);
      a.phi[e * nc + c] = d - rad;
      const V3 t1 = normalise(V3{1.f - n.x * n.x, -(n.y * n.x), -(n.z * n.x)});
      st3(f, t1);
      st3(f + 3, cross(n, t1));
      st3(f + 6, n);
    }
  }
  // a lane a capsule pair: the segments' closest points, phi, the frame
  // (sim/collision.py detect_pair_contacts)
  for (int p = lane; p < a.npair; p += kWarp) {
    const float eps = 1e-12f;
    const int ba = ti[it.pair_a + p], bb = ti[it.pair_b + p];
    const V3 oa = ld3(o + 3 * ba), ob = ld3(o + 3 * bb);
    const V3 p0a = add(oa, mv(R + 9 * ba, ld3(tf + ft.p0a + 3 * p)));
    const V3 p1a = add(oa, mv(R + 9 * ba, ld3(tf + ft.p1a + 3 * p)));
    const V3 p0b = add(ob, mv(R + 9 * bb, ld3(tf + ft.p0b + 3 * p)));
    const V3 p1b = add(ob, mv(R + 9 * bb, ld3(tf + ft.p1b + 3 * p)));
    const V3 d1 = sub(p1a, p0a), d2 = sub(p1b, p0b), r = sub(p0a, p0b);
    const float aa = dot(d1, d1), ee = dot(d2, d2), bq = dot(d1, d2);
    const float cc = dot(d1, r), ff = dot(d2, r);
    const float denom = aa * ee - bq * bq;
    float sp = clampf((bq * ff - cc * ee) / (denom + eps), 0.f, 1.f);
    const float tp = clampf((bq * sp + ff) / (ee + eps), 0.f, 1.f);
    sp = clampf((bq * tp - cc) / (aa + eps), 0.f, 1.f);
    const V3 ca = add(p0a, scale(sp, d1)), cb = add(p0b, scale(tp, d2));
    const V3 delta = sub(ca, cb);
    const float dist = sqrtf(dot(delta, delta) + eps);
    // the axes' normal, +-cross(d1, d2) by the midpoints' difference, when
    // the closest points (nearly) meet; ez when the axes are parallel
    const V3 cr = cross(d1, d2);
    const float crn = sqrtf(dot(cr, cr));
    const V3 ref = sub(scale(0.5f, add(p0a, p1a)), scale(0.5f, add(p0b, p1b)));
    const float sgn = dot(cr, ref) >= 0.f ? 1.f : -1.f;
    const V3 n_fb = crn > 1e-6f ? scale(1.f / (crn + eps), scale(sgn, cr))
                                : V3{0.f, 0.f, 1.f};
    const V3 n = dist > 1e-3f ? scale(1.f / dist, delta) : n_fb;
    const int c = nct + p;
    a.phi[e * nc + c] = dist - tf[ft.rsum + p];
    const bool near_z = fabsf(n.z) > 0.9f;
    const V3 t1 = normalise(
        cross(n, near_z ? V3{1.f, 0.f, 0.f} : V3{0.f, 0.f, 1.f}));
    float* f = fr + 9 * c;
    st3(f, t1);
    st3(f + 3, cross(n, t1));
    st3(f + 6, n);
    st3(pa + 3 * c, ca);
    st3(pb + 3 * c, cb);
  }
  __syncwarp();
  if (a.frame != nullptr) {
    float* out = a.frame + e * 9 * nc;
    for (int i = lane; i < 9 * nc; i += kWarp) out[i] = fr[i];
  }
  clk.lap(0);

  // a pass of 32 rows at a time, a lane a row r: contact r / 3, frame row
  // r % 3
  const unsigned* anc = reinterpret_cast<const unsigned*>(ti + it.anc);
  float4* rows4 = reinterpret_cast<float4*>(rows);
  const V3 o0 = ld3(o);
  for (int r0 = 0; r0 < n3; r0 += kWarp) {
    for (int i = lane; i < kWarp * nv / 4; i += kWarp)
      rows4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    const int r = r0 + lane;
    unsigned mj = 0u;                // the row's joints
    float* row = rows + lane * nv;
    if (r < n3) {
      const int c = r / 3, i = r % 3;
      const V3 f = ld3(fr + 9 * c + 3 * i);
      const bool pair = c >= nct;
      const unsigned ma =
          anc[ti[pair ? it.pair_a + c - nct : it.cand_body + c]];
      const unsigned mb = pair ? anc[ti[it.pair_b + c - nct]] : 0u;
      const V3 xa = ld3(pa + 3 * c);
      const V3 xb = pair ? ld3(pb + 3 * c) : xa;
      mj = ma | mb;
      // the base: f . e_k (0 for a pair: both points move with the base),
      // then f . (R0 e_k x (x - o0)) = R0 e_k . ((x - o0) x f), a pair's
      // two points subtracted
      const V3 u = cross(pair ? sub(xa, xb) : sub(xa, o0), f);
      const float eb[6] = {pair ? 0.f : f.x, pair ? 0.f : f.y,
                           pair ? 0.f : f.z, dot(col(R, 0), u),
                           dot(col(R, 1), u), dot(col(R, 2), u)};
      float bb = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        row[k] = eb[k];
        bb += eb[k] * vf[k];
      }
      // a joint j on the chain: f . (a_j x (x - p_j)) = a_j . ((x - p_j)
      // x f), body B's point subtracted
      for (unsigned rest = mj; rest != 0u; rest &= rest - 1u) {
        const int j = __ffs(rest) - 1;
        const float4 j0 = jt[2 * j], j1 = jt[2 * j + 1];
        const V3 ax = {j0.x, j0.y, j0.z}, pj = {j0.w, j1.x, j1.y};
        float v = 0.f;
        if ((ma >> j) & 1u) v = dot(ax, cross(sub(xa, pj), f));
        if ((mb >> j) & 1u) v -= dot(ax, cross(sub(xb, pj), f));
        row[6 + j] = v;
        bb += v * vf[6 + j];
      }
      a.b[e * n3 + r] = bb;
    }
    clk.lap(1);
    // W's column r, kK dofs at a time: the sum over the row's nonzero dofs
    // l of E[r][l] times column l of M^-1
    for (int k0 = 0; k0 < nv; k0 += kK) {
      float acc[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) acc[k] = 0.f;
      if (r < n3) {
#pragma unroll
        for (int l = 0; l < 6; ++l)
          axpy(acc, MinvT + l * ld + k0, row[l], nv - k0);
        for (unsigned rest = mj; rest != 0u; rest &= rest - 1u) {
          const int l = 6 + __ffs(rest) - 1;
          axpy(acc, MinvT + l * ld + k0, row[l], nv - k0);
        }
        float* Wr = a.W + (e * nv + k0) * n3 + r;
#pragma unroll
        for (int k = 0; k < kK; ++k)
          if (k0 + k < nv) Wr[static_cast<size_t>(k) * n3] = acc[k];
      }
    }
    __syncwarp();
    clk.lap(2);
    // the pass's rows of E, contiguous in E: 16-byte stores when aligned
    const int count = (n3 - r0 < kWarp ? n3 - r0 : kWarp) * nv;
    float* Eo = a.E + (e * n3 + r0) * nv;
    if ((reinterpret_cast<uintptr_t>(Eo) & 15u) == 0 && count % 4 == 0) {
      float4* Eo4 = reinterpret_cast<float4*>(Eo);
      for (int i = lane; i < count / 4; i += kWarp) Eo4[i] = rows4[i];
    } else {
      for (int i = lane; i < count; i += kWarp) Eo[i] = rows[i];
    }
    __syncwarp();
    clk.lap(3);
  }
}

}  // namespace

extern "C" {

const char* contact_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once a device, before the first launch there.
int contact_rows_setup(int device) {
  return substep::setup_device(contact_rows_kernel, device);
}

// Bytes of shared memory a block of the kernel takes at this shape.
size_t contact_rows_block_bytes(int nb, int nv, int nc) {
  return sizeof(float) * ConLayout(nb, nv, nc).words * substep::kWarps;
}

// Blocks an SM holds at this shape (after contact_rows_setup on the
// current device), or -1.
int contact_rows_blocks_per_sm(int nb, int nv, int nc) {
  return substep::blocks_per_sm(contact_rows_kernel,
                                contact_rows_block_bytes(nb, nv, nc));
}

#ifdef SUBSTEP_PHASE_CLOCKS
// The phase-clock build only: where the next launches add each env's
// cycles a phase (int64 (n_env, kPhaseSlots), zeroed), or null.
int contact_rows_set_phase_cycles(void* buf) {
  return substep::set_phase_cycles(buf);
}
#endif

// Launch over n_env envs on `stream` (a cudaStream_t of the current
// device); returns the cudaError_t of the launch. hfield null: the plane
// (hrows, hcols, cell unread); frame null: not written.
int contact_rows_launch(const float* R, const float* o, const float* a_w,
                        const float* minv, const float* v_free,
                        const float* ftab, const int* itab,
                        const float* hfield, float* E, float* W, float* b,
                        float* phi, float* frame, int n_env, int nb, int nv,
                        int nct, int npair, int hrows, int hcols, float cell,
                        void* stream) {
  const int nc = nct + npair;
  if (nb < 1 || nv != nb + 5 || nv > substep::kMaxDofs || nc < 1 ||
      nc > substep::kMaxContacts || n_env < 0 ||
      (hfield != nullptr && (hrows < 2 || hcols < 2 || !(cell > 0.f))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  // R - 1.001 as the plain version's clamp bound: a double cast to float
  const ConArgs a{R, o, a_w, minv, v_free, ftab, itab,
                  reinterpret_cast<const float4*>(hfield), E, W, b, phi,
                  frame, n_env, nb, nv, nct, npair, hrows, hcols, cell,
                  static_cast<float>(hrows - 1.001),
                  static_cast<float>(hcols - 1.001)};
  const int grid = (n_env + substep::kWarps - 1) / substep::kWarps;
  const size_t smem = contact_rows_block_bytes(nb, nv, nc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  contact_rows_kernel<<<grid, substep::kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
