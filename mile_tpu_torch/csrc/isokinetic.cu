// Hand-written Hopper kernels for the MCLMC hot path (sm_90a).
//
// These replace the Pallas TPU kernels of mile_tpu/ops/isokinetic.py:
//
//   isokinetic_momentum  <- _batched_momentum_kernel (K1) and, with one
//                           chain, _momentum_kernel (K2)
//   partial_refresh      <- _batched_refresh_kernel (K3) and, with one
//                           chain, _refresh_kernel (K4)
//
// Both work on a chain batch (C, dim) of float32, row-major, contiguous.
//
// What bounds them on an H100: bytes. Each is one or two reductions over a
// chain and an elementwise write, a few tens of 32-bit operations per
// element against 8-20 bytes moved. At the main path's (12, 674) a call
// moves 65-162 KB, whose bound (about 20-50 ns at 3.35 TB/s) is far under
// the cost of a launch and of one round trip to device memory; so what
// the design can win is the number of round trips, barriers and launches.
//
// The TPU kernels held a chain in VMEM and read it once. Here:
//
// * One read. A chain is cut into groups of 4 consecutive elements; the
//   threads of a chain hold up to kSlots groups each in registers, so u and
//   g (and the preconditioner and x, when given) are read from device
//   memory once per element, both reductions are taken from the registers,
//   and the result is written once. Groups are loaded as one float4, two
//   float2 or four floats, whichever the rows' alignment allows (at dim 674
//   a row is 8-byte but not 16-byte aligned: float2).
// * Threads per chain follow dim (about two groups a thread: 96 threads at
//   dim 674, 256 at 2048, at most kMaxThreads).
// * A chain longer than one block holds (kMaxThreads * kSlots groups =
//   8192 elements) is split over a thread-block cluster of up to
//   kMaxCluster blocks on neighbouring SMs; the partial sums cross blocks
//   through distributed shared memory, and every block adds them in the
//   same order, so all get the same bits. Up to 65,536 elements a chain
//   stays resident in registers. Past that (the streaming route, e.g. dim
//   300,000), each block loops over its slice: the first pass parks the
//   unnormalized result in the output, the last pass rescales it there
//   (from L2), and K1 re-reads u and g once more for its second reduction.
// * Reductions: warp shuffles, then one barrier per reduction (every thread
//   sums the per-warp slots itself), then one cluster barrier per reduction
//   on the cluster route.
//
// K1 also moves the position when asked (the integrator's drift that
// follows a rotation, x' = x + (x_frac eps) u' s, rounded as PyTorch rounds
// it: no contraction into fma) and adds its dK into a running kinetic
// energy in place.
//
// K3 draws its noise with Philox4x32-10 keyed by (run seed, chain, step
// counter, group): one call gives four 32-bit words, i.e. two Box-Muller
// pairs of 24-bit uniforms (the first of each pair in (0, 1] so its log is
// finite), whose cosine and sine make the group's four normals. Each
// element's noise is drawn once. (The first version of this kernel drew
// one normal per call, keyed by element, and drew it twice: its stream is
// not this one, and the two are held to the same statistics.) The step
// counter is either a value or a device int64 that the kernel reads and
// advances itself, with a last-block ticket: the step sits in the word's
// high bits and the ticket in its low kTicketBits, so one atomic add per
// block both reads the step and takes a ticket, and the block with the
// last ticket adds one to the step and clears the ticket with a second.
// Every access is an atomic on one word, so no fence is needed (a separate
// counter and ticket needed a release atomic and a fence, which cost about
// 0.7 us a call on an H100). A CUDA graph that replays the call draws
// fresh noise each time.
// K3 also writes dE = dK - logp' + logp for each chain, and adds dE and
// dE^2 into running sums, in one thread per chain.
//
// The C interface is plain so that the library is built with nvcc alone
// and bound with ctypes; each entry point launches on the given stream and
// returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

// Keep in step with ops/isokinetic.py, which picks the launch shape.
constexpr int kSlots = 4;          // groups of 4 elements a thread holds
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kTicketBits = 24;    // of a device step counter (see K3)
constexpr float kLog2 = 0.69314718055994531f;

// ------------------------------------------------------------- helpers
// Elements [i, i + 4) of a row, zeros past dim; LV is the vector width
// (floats) that the row's alignment allows.
template <int LV>
__device__ __forceinline__ void load4(const float* row, int64_t i,
                                      int64_t dim, float (&v)[4]) {
  if (i + 4 <= dim) {
    if constexpr (LV == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + i);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if constexpr (LV == 2) {
      const float2 a = *reinterpret_cast<const float2*>(row + i);
      const float2 b = *reinterpret_cast<const float2*>(row + i + 2);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = row[i + j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < dim ? row[i + j] : 0.f;
  }
}

template <int LV>
__device__ __forceinline__ void store4(float* row, int64_t i, int64_t dim,
                                       const float (&v)[4]) {
  if (i + 4 <= dim) {
    if constexpr (LV == 4) {
      *reinterpret_cast<float4*>(row + i) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    } else if constexpr (LV == 2) {
      *reinterpret_cast<float2*>(row + i) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(row + i + 2) = make_float2(v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) row[i + j] = v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < dim) row[i + j] = v[j];
    }
  }
}

__device__ __forceinline__ void zero4(float (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 0.f;
}

// The part of the chain batch a block works on: chain `chain`, groups
// [lo, hi) of it, as block `rank` of the chain's cluster.
struct Slice {
  int64_t chain, lo, hi;
  int rank;
};

__device__ __forceinline__ Slice slice_of(int64_t dim, int64_t per_cta,
                                          int cluster) {
  const int64_t groups = (dim + 3) / 4;
  Slice s;
  s.chain = blockIdx.x / cluster;
  s.rank = static_cast<int>(blockIdx.x % cluster);
  s.lo = min(groups, s.rank * per_cta);
  s.hi = min(groups, s.lo + per_cta);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sums of v[0..N) over the chain, returned to every thread with the same
// bits: the xor butterfly leaves one value in all lanes, and every thread
// adds the per-warp slots, then the cluster's per-block slots, in one
// order. One block barrier, and one cluster barrier on the cluster route.
// Each reduction of a kernel has slots of its own, so none needs a
// trailing barrier; a kernel on the cluster route ends on a cluster
// barrier, so that no block leaves while another still reads its slots.
template <int N>
__device__ __forceinline__ void chain_sum(float (&v)[N],
                                          float (*warp_slots)[N],
                                          float* cta_slot, int cluster) {
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) warp_slots[threadIdx.x >> 5][n] = v[n];
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = 0.f;
  for (int w = 0; w < n_warps; ++w) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += warp_slots[w][n];
  }
  if (cluster == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) cta_slot[n] = v[n];
  }
  cl.sync();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = 0.f;
  for (int r = 0; r < cluster; ++r) {
    const float* remote = cl.map_shared_rank(cta_slot, r);
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += remote[n];
  }
}

// ------------------------------------------------ K1: momentum rotation
struct MomentumArgs {
  const float* u;
  const float* g;
  const float* sdc;       // null: identity preconditioner
  int64_t sdc_stride;     // dim: per-chain (C, dim); 0: one shared (dim,)
  const float* step_size;
  float coef;             // the integrator's stage fraction of eps
  const float* x;         // null: no drift
  float x_frac;
  float* x_out;
  float* u_out;
  float* dk;
  int accumulate;         // add dK into dk instead of writing it
  int64_t dim;
  int64_t per_cta;        // groups per block
  int cluster;
  int resident;           // the block's groups fit in its registers
};

// The exact isokinetic velocity rotation towards g' = g * sqrt_diag_cov:
//   e = g'/max(|g'|, 1e-30), delta = eps |g'| / (d - 1), zeta = exp(-delta)
//   u' = e (1 - zeta)(1 + zeta + (u.e)(1 - zeta)) + 2 zeta u, renormalized
//   dK = (d - 1)(delta - log 2 + log1p(u.e + (1 - u.e) zeta^2))
// with eps = coef * step_size[c]. The norm of u' is reduced explicitly: the
// closed form from (|g'|^2, u.g', |u|^2) cancels when u.e nears -1.
template <int LV>
__global__ void __launch_bounds__(kMaxThreads)
    isokinetic_momentum_kernel(const MomentumArgs a) {
  __shared__ float warp_a[kMaxWarps][2], cta_a[2];
  __shared__ float warp_b[kMaxWarps][1], cta_b[1];
  const Slice s = slice_of(a.dim, a.per_cta, a.cluster);
  const int64_t row = s.chain * a.dim;
  const float* uc = a.u + row;
  const float* gc = a.g + row;
  const float* sc = a.sdc == nullptr ? nullptr : a.sdc + s.chain * a.sdc_stride;
  const float* xc = a.x == nullptr ? nullptr : a.x + row;
  float* oc = a.u_out + row;
  float* xo = a.x == nullptr ? nullptr : a.x_out + row;
  const int64_t first = s.lo + threadIdx.x;
  const int64_t stride = blockDim.x;
  const float step = a.step_size[s.chain];
  const float eps = a.coef * step;
  const float x_step = a.x_frac * step;
  // the running kinetic energy, loaded now so that its latency hides
  // under pass 1's
  const bool owner = s.rank == 0 && threadIdx.x == 0;
  const float kinetic = owner && a.accumulate ? a.dk[s.chain] : 0.f;

  // u and g' of one group, and the preconditioner in `ss` when there is one
  auto load_group = [&](int64_t grp, float (&uu)[4], float (&gp)[4],
                        float (&ss)[4]) {
    load4<LV>(uc, 4 * grp, a.dim, uu);
    load4<LV>(gc, 4 * grp, a.dim, gp);
    if (sc != nullptr) {
      load4<LV>(sc, 4 * grp, a.dim, ss);
#pragma unroll
      for (int j = 0; j < 4; ++j) gp[j] *= ss[j];
    }
  };

  // pass 1: |g'|^2 and u.g' (resident: keep u, g', s and x in registers)
  float ur[kSlots][4], wr[kSlots][4], sr[kSlots][4], xr[kSlots][4];
  float sums[2] = {0.f, 0.f};
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t grp = first + k * stride;
      zero4(ur[k]);
      zero4(wr[k]);
      if (grp < s.hi) {
        load_group(grp, ur[k], wr[k], sr[k]);
        if (xc != nullptr) load4<LV>(xc, 4 * grp, a.dim, xr[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sums[0] = fmaf(wr[k][j], wr[k][j], sums[0]);
        sums[1] = fmaf(ur[k][j], wr[k][j], sums[1]);
      }
    }
  } else {
    for (int64_t grp = first; grp < s.hi; grp += stride) {
      float uu[4], gp[4], ss[4];
      load_group(grp, uu, gp, ss);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sums[0] = fmaf(gp[j], gp[j], sums[0]);
        sums[1] = fmaf(uu[j], gp[j], sums[1]);
      }
    }
  }
  chain_sum(sums, warp_a, cta_a, a.cluster);
  const float g_norm = sqrtf(sums[0]);
  const float inv_norm = 1.f / fmaxf(g_norm, 1e-30f);
  const float ue = sums[1] * inv_norm;
  const float dim_m1 = static_cast<float>(a.dim - 1);
  const float delta = eps * g_norm / dim_m1;
  const float zeta = expf(-delta);
  // u' (before renormalization) w = ca * g' + cb * u
  const float ca = (1.f - zeta) * (1.f + zeta + ue * (1.f - zeta)) * inv_norm;
  const float cb = 2.f * zeta;

  // pass 2: |w|^2 (streaming: w is parked in u_out)
  float nn[1] = {0.f};
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wr[k][j] = fmaf(ca, wr[k][j], cb * ur[k][j]);
        nn[0] = fmaf(wr[k][j], wr[k][j], nn[0]);
      }
    }
  } else {
    for (int64_t grp = first; grp < s.hi; grp += stride) {
      float uu[4], gp[4], ss[4];
      load_group(grp, uu, gp, ss);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gp[j] = fmaf(ca, gp[j], cb * uu[j]);
        nn[0] = fmaf(gp[j], gp[j], nn[0]);
      }
      store4<LV>(oc, 4 * grp, a.dim, gp);
    }
  }
  chain_sum(nn, warp_b, cta_b, a.cluster);
  const float scale = rsqrtf(fmaxf(nn[0], 1e-30f));

  // pass 3: u' = w * scale, and x' = x + (x_frac eps) u' s
  auto emit = [&](int64_t grp, float (&w)[4], const float (&ss)[4],
                  const float (&xx)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] *= scale;
    store4<LV>(oc, 4 * grp, a.dim, w);
    if (xo != nullptr) {
      float nx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d = __fmul_rn(x_step, w[j]);
        if (sc != nullptr) d = __fmul_rn(d, ss[j]);
        nx[j] = __fadd_rn(xx[j], d);
      }
      store4<LV>(xo, 4 * grp, a.dim, nx);
    }
  };
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t grp = first + k * stride;
      if (grp < s.hi) emit(grp, wr[k], sr[k], xr[k]);
    }
  } else {
    for (int64_t grp = first; grp < s.hi; grp += stride) {
      float w[4], ss[4], xx[4];
      load4<LV>(oc, 4 * grp, a.dim, w);
      if (sc != nullptr) load4<LV>(sc, 4 * grp, a.dim, ss);
      if (xc != nullptr) load4<LV>(xc, 4 * grp, a.dim, xx);
      emit(grp, w, ss, xx);
    }
  }
  if (owner) {
    const float dk = (delta - kLog2 + log1pf(ue + (1.f - ue) * zeta * zeta))
                     * dim_m1;
    a.dk[s.chain] = a.accumulate ? __fadd_rn(kinetic, dk) : dk;
  }
  if (a.cluster > 1) cg::this_cluster().sync();
}

// --------------------------------------------------- K3: partial refresh
// Philox4x32-10 (Salmon et al., SC'11): a counter-based generator, so any
// group's numbers are computed where they are needed.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// Box-Muller on one pair of words: two normals from 24-bit uniforms (exact
// in float32; the first lies in (0, 1] so its log is finite).
__device__ __forceinline__ void box_muller(uint32_t wa, uint32_t wb,
                                           float& z0, float& z1) {
  const float ua = (static_cast<float>(wa >> 8) + 1.f) * (1.f / 16777216.f);
  const float ub = static_cast<float>(wb >> 8) * (1.f / 16777216.f);
  const float r = sqrtf(-2.f * logf(ua));
  float sn, cs;
  sincospif(2.f * ub, &sn, &cs);
  z0 = r * cs;
  z1 = r * sn;
}

// The four standard normals of group `grp` of chain `chain` at `step`.
__device__ __forceinline__ void normals4(uint64_t seed, uint32_t chain,
                                         uint64_t step, int64_t grp,
                                         float (&z)[4]) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), chain,
                 static_cast<uint32_t>(step),
                 static_cast<uint32_t>(step >> 32)),
      make_uint2(static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(seed >> 32)));
  box_muller(r.x, r.y, z[0], z[1]);
  box_muller(r.z, r.w, z[2], z[3]);
}

struct RefreshArgs {
  const float* u;
  const float* step_size;
  const float* L;
  const float* z;           // injected normals (C, dim), or null: Philox
  uint64_t seed;
  uint64_t counter;         // the step counter, when counter_ptr is null
  // a device step counter, advanced by the kernel: step << kTicketBits,
  // plus the ticket while a launch runs
  unsigned long long* counter_ptr;
  float* u_out;
  const float* dk;          // null: no dE
  const float* logp_new;
  const float* logp;
  float* de;
  float* de_sum;            // null: no running sums
  float* de_sq_sum;
  int64_t dim;
  int64_t per_cta;
  int cluster;
  int resident;
};

// Partial momentum refresh on the sphere:
//   nu = sqrt((exp(2 eps / L) - 1) / d),  u' = (u + nu z) / |u + nu z|
// Entries where u == 0 get no noise (the TPU kernel's rule for its padding
// lanes, kept so that kernel and plain version agree exactly).
template <int LV>
__global__ void __launch_bounds__(kMaxThreads)
    partial_refresh_kernel(const RefreshArgs a) {
  __shared__ float warp_a[kMaxWarps][1], cta_a[1];
  const Slice s = slice_of(a.dim, a.per_cta, a.cluster);
  const int64_t row = s.chain * a.dim;
  const float* uc = a.u + row;
  const float* zc = a.z == nullptr ? nullptr : a.z + row;
  float* oc = a.u_out + row;
  const int64_t first = s.lo + threadIdx.x;
  const int64_t stride = blockDim.x;
  const uint32_t chain = static_cast<uint32_t>(s.chain);
  // the inputs of the dE epilogue, loaded first so that their latency hides
  // under pass 1's
  const int64_t c = s.chain;
  const bool owner = a.de != nullptr && s.rank == 0 && threadIdx.x == 0;
  float energy[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (owner) {
    energy[0] = a.dk[c];
    energy[1] = a.logp_new[c];
    energy[2] = a.logp[c];
    if (a.de_sum != nullptr) {
      energy[3] = a.de_sum[c];
      energy[4] = a.de_sq_sum[c];
    }
  }
  const float nu = sqrtf((expf(2.f * a.step_size[c] / a.L[c]) - 1.f)
                         / static_cast<float>(a.dim));
  float wr[kSlots][4];   // resident: u, then w = u + nu z
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t grp = first + k * stride;
      zero4(wr[k]);
      if (grp < s.hi) load4<LV>(uc, 4 * grp, a.dim, wr[k]);
    }
  }

  // The device step counter, while u is on its way: thread 0 reads the
  // step and takes the block's ticket in one atomic; the block with the
  // last ticket advances the step and clears the ticket in another. Every
  // block of this launch has taken its ticket, so has read this step,
  // before that.
  __shared__ uint64_t shared_step;
  uint64_t step = a.counter;
  if (a.counter_ptr != nullptr) {
    if (threadIdx.x == 0) {
      const unsigned long long word = atomicAdd(a.counter_ptr, 1ull);
      shared_step = word >> kTicketBits;
      if ((word & ((1ull << kTicketBits) - 1)) == gridDim.x - 1) {
        atomicAdd(a.counter_ptr, (1ull << kTicketBits) - gridDim.x);
      }
    }
    __syncthreads();
    step = shared_step;
  }

  // w = u + nu z for one group, in place
  auto perturb = [&](int64_t grp, float (&w)[4]) {
    float z[4];
    if (zc != nullptr) {
      load4<LV>(zc, 4 * grp, a.dim, z);
    } else {
      normals4(a.seed, chain, step, grp, z);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = fmaf(nu, w[j] == 0.f ? 0.f : z[j], w[j]);
  };

  // pass 1: w and |w|^2 (streaming: w is parked in u_out)
  float nn[1] = {0.f};
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t grp = first + k * stride;
      if (grp < s.hi) perturb(grp, wr[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) nn[0] = fmaf(wr[k][j], wr[k][j], nn[0]);
    }
  } else {
    for (int64_t grp = first; grp < s.hi; grp += stride) {
      float w[4];
      load4<LV>(uc, 4 * grp, a.dim, w);
      perturb(grp, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) nn[0] = fmaf(w[j], w[j], nn[0]);
      store4<LV>(oc, 4 * grp, a.dim, w);
    }
  }
  chain_sum(nn, warp_a, cta_a, a.cluster);
  const float scale = rsqrtf(fmaxf(nn[0], 1e-30f));

  // pass 2: u' = w * scale
  if (a.resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t grp = first + k * stride;
      if (grp < s.hi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wr[k][j] *= scale;
        store4<LV>(oc, 4 * grp, a.dim, wr[k]);
      }
    }
  } else {
    for (int64_t grp = first; grp < s.hi; grp += stride) {
      float w[4];
      load4<LV>(oc, 4 * grp, a.dim, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] *= scale;
      store4<LV>(oc, 4 * grp, a.dim, w);
    }
  }

  // dE = dK - logp' + logp, in the order of mile_tpu/mcmc/mclmc.py
  if (owner) {
    const float de = __fadd_rn(__fsub_rn(energy[0], energy[1]), energy[2]);
    a.de[c] = de;
    if (a.de_sum != nullptr) {
      a.de_sum[c] = __fadd_rn(energy[3], de);
      a.de_sq_sum[c] = __fadd_rn(energy[4], __fmul_rn(de, de));
    }
  }
  if (a.cluster > 1) cg::this_cluster().sync();
}

// ------------------------------------------------------------- launch
// The widest vector load that every row allows: rows start at multiples of
// dim floats from each (aligned) base pointer.
int vector_width(int64_t dim, std::initializer_list<const void*> ptrs) {
  for (int lv : {4, 2}) {
    bool ok = dim % lv == 0;
    for (const void* p : ptrs) {
      ok = ok && reinterpret_cast<uintptr_t>(p) % (4 * lv) == 0;
    }
    if (ok) return lv;
  }
  return 1;
}

bool valid_shape(int32_t n_chains, int64_t dim, int32_t threads,
                 int32_t cluster, int64_t per_cta, int32_t resident) {
  return n_chains > 0 && dim > 1 && threads >= 32 && threads % 32 == 0
         && threads <= kMaxThreads && cluster >= 1 && cluster <= kMaxCluster
         && per_cta * cluster >= (dim + 3) / 4
         && (!resident || per_cta <= static_cast<int64_t>(threads) * kSlots)
         && static_cast<int64_t>(n_chains) * cluster < (1LL << 31);
}

template <typename Args>
int launch(void (*kernel)(Args), const Args& args, int32_t n_chains,
           int32_t threads, int32_t cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_chains) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

int mile_isokinetic_momentum(const float* u, const float* g, const float* sdc,
                             int64_t sdc_stride, const float* step_size,
                             float coef, const float* x, float x_frac,
                             float* x_out, float* u_out, float* dk,
                             int32_t accumulate, int32_t n_chains, int64_t dim,
                             int32_t threads, int32_t cluster, int64_t per_cta,
                             int32_t resident, void* stream) {
  if (!valid_shape(n_chains, dim, threads, cluster, per_cta, resident)
      || (x != nullptr && x_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MomentumArgs args{u, g, sdc, sdc_stride, step_size, coef, x, x_frac,
                          x_out, u_out, dk, accumulate, dim, per_cta,
                          cluster, resident};
  switch (vector_width(dim, {u, g, sdc, x, x_out, u_out})) {
    case 4:
      return launch(isokinetic_momentum_kernel<4>, args, n_chains, threads,
                    cluster, stream);
    case 2:
      return launch(isokinetic_momentum_kernel<2>, args, n_chains, threads,
                    cluster, stream);
    default:
      return launch(isokinetic_momentum_kernel<1>, args, n_chains, threads,
                    cluster, stream);
  }
}

int mile_partial_refresh(const float* u, const float* step_size,
                         const float* L, const float* z, uint64_t seed,
                         uint64_t counter, unsigned long long* counter_ptr,
                         float* u_out, const float* dk,
                         const float* logp_new, const float* logp, float* de,
                         float* de_sum, float* de_sq_sum, int32_t n_chains,
                         int64_t dim, int32_t threads, int32_t cluster,
                         int64_t per_cta, int32_t resident, void* stream) {
  if (!valid_shape(n_chains, dim, threads, cluster, per_cta, resident)
      || (counter_ptr != nullptr
          && static_cast<int64_t>(n_chains) * cluster >= (1LL << kTicketBits))
      || (dk != nullptr && (logp_new == nullptr || logp == nullptr
                            || de == nullptr))
      || ((de_sum == nullptr) != (de_sq_sum == nullptr))
      || (de_sum != nullptr && dk == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RefreshArgs args{u, step_size, L, z, seed, counter, counter_ptr,
                         u_out, dk, logp_new, logp,
                         dk == nullptr ? nullptr : de, de_sum, de_sq_sum,
                         dim, per_cta, cluster, resident};
  switch (vector_width(dim, {u, z, u_out})) {
    case 4:
      return launch(partial_refresh_kernel<4>, args, n_chains, threads,
                    cluster, stream);
    case 2:
      return launch(partial_refresh_kernel<2>, args, n_chains, threads,
                    cluster, stream);
    default:
      return launch(partial_refresh_kernel<1>, args, n_chains, threads,
                    cluster, stream);
  }
}

const char* mile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
