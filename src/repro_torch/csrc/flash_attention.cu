// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd`, reached through `flash_attention`
// in src/repro/kernels/flash_attention.py (`_fwd_kernel`, `_block_update`):
// causal or sliding-window GQA attention with an online softmax over key
// tiles, fp32 running max m / sum l / accumulator acc, masked scores at
// NEG_INF = -1e30 and the output divided by max(l, 1e-30).
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, Hkv, D), o like q, all
// contiguous, fp32 or bf16.  Query row i sits at absolute position
// q_offset + i (chunked prefill); key j is visible from it iff
// (!causal || j <= q_offset + i) && (window <= 0 || j > q_offset + i - window).
//
// Bound on the card: 4*B*H*Sq*Sk*D FLOPs (about half of it when causal)
// against 989 TFLOP/s of bf16 tensor cores (H100 SXM), while the inputs
// are only 2*B*Sq*H*D + 2*B*Sk*Hkv*D elements: at a long prefill the
// kernel is bound by operations.
//
// Design.  The TPU walks the kv tiles as the innermost, sequential grid
// axis and keeps (m, l, acc) in VMEM scratch between grid steps.  Here one
// block owns one (b, h, 32-row q tile) and loops over the key tiles itself,
// with (m, l, acc) in registers; blocks run in parallel with no carry
// between them.  The kv head is h / (H / Hkv), read directly: the repeated
// K/V of the Pallas wrapper is never materialized.  Four warps own eight
// query rows each; a 64-key tile of K and V is staged in shared memory as
// fp32 and each lane scores two keys for its warp's eight rows, then
// accumulates two (D = 64) or four (D = 128) output columns.  This first
// version uses fp32 FMA, not the tensor cores: it is right first, and fast
// in a later change.  The ragged q and key edges are masked (a column past
// Sk counts as -inf, i.e. not at all), so no length has to divide a tile.
// Key tiles that every row of the block masks are skipped: they lie after
// the diagonal (causal) or before every row's window, and in the online
// softmax such a tile leaves (m, l, acc) unchanged or is wiped by the
// exp(-1e30 - m) = 0 correction of the first visible key, so the result is
// the one of the full walk.  Only a block holding a row with no visible key
// at all walks every tile, so that the row averages all keys exactly as the
// Pallas kernel's NEG_INF softmax does.
#include <atomic>

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 64;                     // keys per tile, two per lane
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr size_t smem_bytes() {
  // q tile (transposed) + K tile (padded rows) + V tile + per-warp p
  return sizeof(float) *
         (D * kBlockQ + kBlockK * (D + 1) + kBlockK * D + kWarps * kBlockK * kRowsPerWarp);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int sq, int sk, int h, int hkv, int causal, int window,
                 int q_offset, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [D][kBlockQ]
  float* k_s = q_s + D * kBlockQ;        // [kBlockK][D + 1]
  float* v_s = k_s + kBlockK * (D + 1);  // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;        // [kWarps][kBlockK][kRowsPerWarp]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / hkv);

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    float x = 0.f;
    if (row < sq) x = repro::to_float(q[((static_cast<size_t>(b) * sq + row) * h + head) * D + d]);
    q_s[d * kBlockQ + r] = x;
  }

  // the key columns [col_lo, col_hi) this block has to visit
  const int row_lo = q_offset + q0;
  const int row_hi = q_offset + min(q0 + kBlockQ, sq) - 1;
  const bool has_empty_row = window > 0 && row_hi - window + 1 > sk - 1;
  int col_lo = 0, col_hi = sk;
  if (!has_empty_row) {
    if (causal) col_hi = min(sk, row_hi + 1);
    if (window > 0) col_lo = max(0, row_lo - window + 1);
  }
  const int t_lo = col_lo / kBlockK;
  const int t_hi = (col_hi + kBlockK - 1) / kBlockK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const size_t key_stride = static_cast<size_t>(hkv) * D;
  const T* k_base = k + (static_cast<size_t>(b) * sk * hkv + kv_head) * D;
  const T* v_base = v + (static_cast<size_t>(b) * sk * hkv + kv_head) * D;
  const float* q_w = q_s + warp * kRowsPerWarp;
  float* p_w = p_s + warp * kBlockK * kRowsPerWarp;
  const int row_w = row_lo + warp * kRowsPerWarp;  // absolute row of r = 0

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * kBlockK;
    __syncthreads();  // q_s is written; the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      float kx = 0.f, vx = 0.f;
      if (c0 + j < sk) {
        const size_t off = static_cast<size_t>(c0 + j) * key_stride + d;
        kx = repro::to_float(k_base[off]);
        vx = repro::to_float(v_base[off]);
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // scores of keys c0 + lane and c0 + lane + 32 for the warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_w + d * kBlockQ);
      const float4 qb = *reinterpret_cast<const float4*>(q_w + d * kBlockQ + 4);
      const float qr[kRowsPerWarp] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float k0 = k_s[lane * (D + 1) + d];
      const float k1 = k_s[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r][0] += qr[r] * k0;
        s[r][1] += qr[r] * k1;
      }
    }

    // mask, then the online-softmax update of every row
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row_w + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (col >= sk) {
          x = repro::minus_inf();
        } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
          x = kNegInf;
        }
        s[r][c] = x;
      }
      const float m_new = fmaxf(m[r], repro::warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + repro::warp_sum(p0 + p1);
      m[r] = m_new;
      s[r][0] = p0;
      s[r][1] = p1;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float* dst = p_w + (lane + 32 * c) * kRowsPerWarp;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    __syncwarp();

    // acc = acc * corr + p @ V
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(p_w + j * kRowsPerWarp);
      const float4 pb = *reinterpret_cast<const float4*>(p_w + j * kRowsPerWarp + 4);
      const float pr[kRowsPerWarp] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vx = v_s[j * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] += pr[r] * vx;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* dst = o + ((static_cast<size_t>(b) * sq + row) * h + head) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[lane + 32 * c] = repro::from_float<T>(acc[r][c] / denom);
  }
}

// The tiles need more than the default 48 KiB of dynamic shared memory.  The
// limit is an attribute of each template instance on each device: it is set
// at the first launch on a device (devices 0-63 are remembered), not at
// every launch.
template <typename T, int D>
cudaError_t allow_smem(int smem) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                   int h, int hkv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem<T, D>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, h, hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int b, int sq, int sk, int h, int hkv, int d,
                                         int dtype, int causal, int window, int q_offset,
                                         float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, q_offset, scale, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, b, sq, sk, h, hkv, causal, window, q_offset, scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, q_offset,
                                     scale, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, b, sq, sk, h, hkv, causal, window, q_offset,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
