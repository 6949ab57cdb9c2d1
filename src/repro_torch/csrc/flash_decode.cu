// Flash decode for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode` in
// src/repro/kernels/decode_attention.py (`_kernel`, `_block_update`):
// one-token GQA attention over a KV cache in 512-slot blocks, with a
// per-batch `cache_len` mask (slot j is valid iff j < cache_len and, with a
// window, j >= cache_len - window), fp32 (m, l, acc) merged block by block,
// masked scores at NEG_INF = -1e30 and the output divided by max(l, 1e-30).
//
// Layout: q (B, H, D), k_cache and v_cache (B, Smax, Hkv, D), cache_len
// (B,) int32 in device memory (read by the kernel, so the host never syncs
// on it), o like q; fp32 or bf16.
//
// Bound on the card: the work is reading the valid part of the cache,
// 2*B*cache_len*Hkv*D elements (2*B*Smax*Hkv*D when the cache is full),
// against 3.35 TB/s of HBM (H100 SXM); the 4*B*H*cache_len*D FLOPs are far
// below the compute roof, so the kernel is bound by bytes.
//
// Design.  The TPU grid is (batch, kv block) with the kv blocks walked in
// order and the merge state in VMEM.  Here one block of 256 threads owns one
// (b, kv head) and walks the 512-slot cache blocks in order itself, keeping
// the G = H / Hkv query heads of that kv head together so each cache row is
// read once.  Per cache block: (1) each thread scores two slots for all G
// heads; (2) warp g reduces head g's max and sum and turns its scores into
// probabilities; (3) thread (part, d) sums p * v over its part of the slots
// for column d, and the parts are added in a fixed order.  The merge order
// is fixed (block after block, parts in index order), so a sliced variant
// that runs the same blocks with an explicit carry can be bit-identical to
// this kernel.  Blocks past cache_len and blocks before the window are
// skipped, and masked slots are neither read nor multiplied: in the online
// softmax they give p = exp(-1e30 - m) = 0 once a valid slot is seen, so
// only the valid part of the cache moves.  When no slot is valid the kernel
// walks every block and reproduces the Pallas kernel's uniform average.
// One block per (b, kv head) is few blocks for a small batch: splitting
// the cache across blocks is work for a later change.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kBlockK = 512;   // cache slots per merge step (the Pallas block_k)
constexpr int kMaxGroup = 8;   // query heads per kv head; one warp each in step (2)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ cache_len,
                    T* __restrict__ o, int smax, int h, int hkv, int window, float scale) {
  constexpr int kParts = kThreads / D;  // slot ranges of step (3)
  constexpr int kSlotsPerPart = kBlockK / kParts;
  __shared__ __align__(16) float q_s[kMaxGroup][D];
  __shared__ float sc[kMaxGroup][kBlockK];
  __shared__ float red[kParts][kMaxGroup][D];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], corr_s[kMaxGroup];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv_head = blockIdx.x;
  const int b = blockIdx.y;
  const int group = h / hkv;
  const int len = cache_len[b];

  for (int idx = tid; idx < group * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    q_s[g][d] = repro::to_float(q[(static_cast<size_t>(b) * h + kv_head * group + g) * D + d]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // the cache blocks [blk_lo, blk_hi) that hold a valid slot
  const int n_blk = (smax + kBlockK - 1) / kBlockK;
  const bool none_valid = len <= 0 || (window > 0 && len - window >= smax);
  int blk_lo = 0, blk_hi = n_blk;
  if (!none_valid) {
    blk_hi = (min(len, smax) + kBlockK - 1) / kBlockK;
    if (window > 0) blk_lo = max(0, len - window) / kBlockK;
  }

  const size_t slot_stride = static_cast<size_t>(hkv) * D;
  const T* k_base = k_cache + (static_cast<size_t>(b) * smax * hkv + kv_head) * D;
  const T* v_base = v_cache + (static_cast<size_t>(b) * smax * hkv + kv_head) * D;
  const int d_col = tid % D;
  const int part = tid / D;
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int blk = blk_lo; blk < blk_hi; ++blk) {
    const int c0 = blk * kBlockK;

    // (1) scores of every slot of the block, for the G heads
    for (int jj = tid; jj < kBlockK; jj += kThreads) {
      const int col = c0 + jj;
      if (col >= smax) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) sc[g][jj] = repro::minus_inf();
        continue;
      }
      const bool valid = col < len && (window <= 0 || col >= len - window);
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
      if (valid) {
        const T* krow = k_base + static_cast<size_t>(col) * slot_stride;
#pragma unroll 1
        for (int d0 = 0; d0 < D; d0 += 8) {
          float kx[8];
          repro::load8(krow + d0, kx);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) {
#pragma unroll
              for (int e = 0; e < 8; ++e) s[g] += q_s[g][d0 + e] * kx[e];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) sc[g][jj] = valid ? s[g] * scale : kNegInf;
    }
    __syncthreads();

    // (2) online-softmax merge; warp g owns query head g
    if (warp < group) {
      const int g = warp;
      float mx = repro::minus_inf();
      for (int jj = lane; jj < kBlockK; jj += 32) mx = fmaxf(mx, sc[g][jj]);
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = lane; jj < kBlockK; jj += 32) {
        const float p = expf(sc[g][jj] - m_new);
        sc[g][jj] = p;
        sum += p;
      }
      sum = repro::warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + p @ V, column d_col, parts added in order
    float pv[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) pv[g] = 0.f;
    const int j0 = part * kSlotsPerPart;
    for (int jj = j0; jj < j0 + kSlotsPerPart; ++jj) {
      const int col = c0 + jj;
      if (col >= smax) break;
      bool any = false;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) any |= g < group && sc[g][jj] != 0.f;
      if (!any) continue;  // masked slot: p == 0 for every head
      const float vx = repro::to_float(v_base[static_cast<size_t>(col) * slot_stride + d_col]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) pv[g] += sc[g][jj] * vx;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) red[part][g][d_col] = pv[g];
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float sum = 0.f;
#pragma unroll
          for (int pp = 0; pp < kParts; ++pp) sum += red[pp][g][d_col];
          acc[g] = acc[g] * corr_s[g] + sum;
        }
      }
    }
    __syncthreads();
  }

  if (part == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float denom = fmaxf(l_s[g], 1e-30f);
        o[(static_cast<size_t>(b) * h + kv_head * group + g) * D + d_col] =
            repro::from_float<T>(acc[g] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* cache_len, void* o, int b, int smax, int h, int hkv, int window,
                   float scale, cudaStream_t stream) {
  const dim3 grid(hkv, b);
  flash_decode_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const int*>(cache_len), static_cast<T*>(o), smax, h, hkv, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                  const void* cache_len, void* o, int b, int smax, int h,
                                  int hkv, int d, int dtype, int window, float scale,
                                  void* stream) {
  if (b <= 0 || smax <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k_cache, v_cache, cache_len, o, b, smax, h, hkv, window, scale, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k_cache, v_cache, cache_len, o, b, smax, h, hkv, window, scale,
                              s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, cache_len, o, b, smax, h, hkv, window,
                                     scale, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, cache_len, o, b, smax, h, hkv, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
