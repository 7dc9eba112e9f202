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
// Design (simple and right first): one thread block per chain (grid = C,
// 256 threads), block-stride loops over dim, and warp-shuffle plus
// shared-memory block reductions. Any dim works: nothing in shared memory
// is sized by dim, so there is no padding and no cap (the TPU kernels
// padded to (8, 128) tiles and fell back to XLA past a VMEM budget).
//
// What bounds them on an H100: each is a few reductions over two to three
// (C, dim) float32 vectors, so the work is bytes, not operations. At the
// main path's (12, 674) a call moves about 130 KB and the bound is tens of
// nanoseconds, far under a launch's own cost; and 12 blocks occupy 12 of
// the 132 SMs. The second and third passes re-read the inputs, which stay
// in L1/L2 at these sizes. Making the kernels fast (several blocks per
// chain, or fusing the three rotations of a step) is later work.
//
// The C interface is plain so that the library is built with nvcc alone
// and bound with ctypes; each entry point launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2 = 0.69314718055994531f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of `v` over the block, returned to every thread. `scratch` holds
// kWarps floats; the trailing barrier lets the caller reuse it at once.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Two block sums at once (kWarps floats of scratch each).
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5] = a;
    scratch[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total.x += scratch[w];
    total.y += scratch[kWarps + w];
  }
  __syncthreads();
  return total;
}

// K1: the exact isokinetic velocity rotation towards the preconditioned
// gradient g' = g * sqrt_diag_cov, for one chain per block.
//   e = g'/max(|g'|, 1e-30), delta = eps |g'| / (d - 1), zeta = exp(-delta)
//   u' = e (1 - zeta)(1 + zeta + (u.e)(1 - zeta)) + 2 zeta u, renormalized
//   dK = (d - 1)(delta - log 2 + log1p(u.e + (1 - u.e) zeta^2))
// `sdc` may be null (identity preconditioner); `sdc_stride` is dim for a
// per-chain (C, dim) preconditioner and 0 for one shared (dim,) vector.
// eps = coef * step_size[c]: coef is the integrator's stage fraction.
__global__ void __launch_bounds__(kThreads) isokinetic_momentum_kernel(
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ sdc, int64_t sdc_stride,
    const float* __restrict__ step_size, float coef,
    float* __restrict__ u_out, float* __restrict__ dk_out, int64_t dim) {
  __shared__ float scratch[2 * kWarps];
  const int64_t c = blockIdx.x;
  const float* uc = u + c * dim;
  const float* gc = g + c * dim;
  const float* sc = sdc == nullptr ? nullptr : sdc + c * sdc_stride;
  float* oc = u_out + c * dim;

  // pass 1: |g'|^2 and u.g'
  float gg = 0.f, ug = 0.f;
  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    const float gi = sc == nullptr ? gc[i] : gc[i] * sc[i];
    gg = fmaf(gi, gi, gg);
    ug = fmaf(uc[i], gi, ug);
  }
  const float2 sums = block_sum2(gg, ug, scratch);
  const float g_norm = sqrtf(sums.x);
  const float inv_norm = 1.f / fmaxf(g_norm, 1e-30f);
  const float ue = sums.y * inv_norm;
  const float dim_m1 = static_cast<float>(dim - 1);
  const float delta = coef * step_size[c] * g_norm / dim_m1;
  const float zeta = expf(-delta);
  // u' (before renormalization) = a * g' + b * u
  const float a = (1.f - zeta) * (1.f + zeta + ue * (1.f - zeta)) * inv_norm;
  const float b = 2.f * zeta;

  // pass 2: |u'|^2
  float nn = 0.f;
  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    const float gi = sc == nullptr ? gc[i] : gc[i] * sc[i];
    const float w = fmaf(a, gi, b * uc[i]);
    nn = fmaf(w, w, nn);
  }
  const float scale = rsqrtf(fmaxf(block_sum(nn, scratch), 1e-30f));

  // pass 3: write the renormalized u'
  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    const float gi = sc == nullptr ? gc[i] : gc[i] * sc[i];
    oc[i] = fmaf(a, gi, b * uc[i]) * scale;
  }
  if (threadIdx.x == 0) {
    dk_out[c] = (delta - kLog2 + log1pf(ue + (1.f - ue) * zeta * zeta))
                * dim_m1;
  }
}

// Philox4x32-10 (Salmon et al., SC'11): a counter-based generator, so any
// element's numbers are computed where they are needed and nothing is
// stored between the two passes of the refresh.
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

// Standard normal for (seed, chain, step counter, element): Box-Muller
// from two 24-bit uniforms, as the TPU kernel drew them (the uniforms are
// exact in float32; the first lies in (0, 1] so its log is finite).
__device__ __forceinline__ float philox_normal(uint64_t seed, uint32_t chain,
                                               uint64_t counter, int64_t i) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(i), chain,
                 static_cast<uint32_t>(counter),
                 static_cast<uint32_t>(counter >> 32)),
      make_uint2(static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(seed >> 32)));
  const float ua = (static_cast<float>(r.x >> 8) + 1.f) * (1.f / 16777216.f);
  const float ub = static_cast<float>(r.y >> 8) * (1.f / 16777216.f);
  return sqrtf(-2.f * logf(ua)) * cospif(2.f * ub);
}

// K3: partial momentum refresh on the sphere, one chain per block.
//   nu = sqrt((exp(2 eps / L) - 1) / d),  u' = (u + nu z) / |u + nu z|
// z is Philox noise, or the injected `z_in` (C, dim) when that is not
// null. Entries where u == 0 get no noise (the TPU kernel's rule for its
// padding lanes, kept so that kernel and plain version agree exactly).
// z is regenerated in the second pass rather than stored.
__global__ void __launch_bounds__(kThreads) partial_refresh_kernel(
    const float* __restrict__ u, const float* __restrict__ step_size,
    const float* __restrict__ L, const float* __restrict__ z_in,
    uint64_t seed, uint64_t counter, float* __restrict__ u_out,
    int64_t dim) {
  __shared__ float scratch[kWarps];
  const int64_t c = blockIdx.x;
  const float* uc = u + c * dim;
  const float* zc = z_in == nullptr ? nullptr : z_in + c * dim;
  float* oc = u_out + c * dim;
  const float nu = sqrtf((expf(2.f * step_size[c] / L[c]) - 1.f)
                         / static_cast<float>(dim));
  const uint32_t chain = static_cast<uint32_t>(c);

  float nn = 0.f;
  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    const float ui = uc[i];
    float zi = zc == nullptr ? philox_normal(seed, chain, counter, i) : zc[i];
    if (ui == 0.f) zi = 0.f;
    const float w = fmaf(nu, zi, ui);
    nn = fmaf(w, w, nn);
  }
  const float scale = rsqrtf(fmaxf(block_sum(nn, scratch), 1e-30f));

  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    const float ui = uc[i];
    float zi = zc == nullptr ? philox_normal(seed, chain, counter, i) : zc[i];
    if (ui == 0.f) zi = 0.f;
    oc[i] = fmaf(nu, zi, ui) * scale;
  }
}

}  // namespace

extern "C" {

int mile_isokinetic_momentum(const float* u, const float* g, const float* sdc,
                             int64_t sdc_stride, const float* step_size,
                             float coef, float* u_out, float* dk_out,
                             int32_t n_chains, int64_t dim, void* stream) {
  isokinetic_momentum_kernel<<<n_chains, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      u, g, sdc, sdc_stride, step_size, coef, u_out, dk_out, dim);
  return static_cast<int>(cudaGetLastError());
}

int mile_partial_refresh(const float* u, const float* step_size,
                         const float* L, const float* z, uint64_t seed,
                         uint64_t counter, float* u_out, int32_t n_chains,
                         int64_t dim, void* stream) {
  partial_refresh_kernel<<<n_chains, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      u, step_size, L, z, seed, counter, u_out, dim);
  return static_cast<int>(cudaGetLastError());
}

const char* mile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
