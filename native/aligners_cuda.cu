// GPU kernels for the cover-song aligners (qmax / dmax / constrained
// Smith-Waterman), called from JAX through its foreign function interface.
//
// Same recurrences, masks and floating-point operation order as the XLA
// scan in `acoss_jax/ops/alignment.py` and the C++ oracle in
// `alignment_cpu.cpp`, so identical CRPs give identical fp32 scores.
//
// Layout: one thread block per pair. Each thread owns C = 4 consecutive
// columns of the DP row and keeps, in registers, windows of the last DP
// rows and CRP rows over its columns plus the 3 columns to their left
// (every predecessor of cell (i, j) lies at columns j-3..j). The block
// loops over all rows of the pair; per row, each thread publishes its
// new DP values in shared memory, one barrier, and reads its left
// neighbour's last 3 values (double-buffered, so one barrier per row).
// The CRP is read once, as 4-byte words, prefetched one row ahead.
// Rows past the pair's m_len are never visited.
//
// Build (sm_90a, Hopper):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> aligners_cuda.cu \
//        -o libacoss_aligners.so

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kCols = 4;                 // DP columns per thread
constexpr int kWin = kCols + 3;          // + 3 halo columns on the left
constexpr int kMaxThreads = 1024;
constexpr int kMaxN = kCols * kMaxThreads;

enum Mode { kQmax = 0, kDmax = 1, kSw = 2 };

struct Params {
  float gap;        // qmax / dmax: gap_onset == gap_extension
  float go, ge;     // sw: gap opening / extension
  float match, mismatch;
};

__device__ __forceinline__ void unpack(uint32_t left, uint32_t own,
                                       float (&s)[kWin]) {
  // s[k] = S[i, j0 - 3 + k]; bytes are little-endian within a word
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s[k] = static_cast<float>((left >> (8 * (k + 1))) & 0xffu);
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    s[3 + k] = static_cast<float>((own >> (8 * k)) & 0xffu);
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
align_kernel(const uint8_t* __restrict__ S, const int32_t* __restrict__ m_len,
             const int32_t* __restrict__ n_len, int M, int N, Params p,
             float* __restrict__ out) {
  constexpr int LO = (MODE == kDmax) ? 3 : 2;   // first valid row / column
  extern __shared__ float4 xch[];               // [2][blockDim.x]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int j0 = t * kCols;
  const int m = min(m_len[b], M);
  const int n = min(n_len[b], N);
  if (m <= LO || n <= LO) {                     // whole block exits together
    if (t == 0) out[b] = 0.0f;
    return;
  }
  const uint8_t* Sb = S + static_cast<size_t>(b) * M * N;
  const bool has_cols = j0 < N;

  // Windows over columns j0-3 .. j0+3 (index k <-> column j0 - 3 + k).
  float D1[kWin] = {}, D2[kWin] = {}, D3[kWin] = {};
  float S0[kWin], S1[kWin] = {}, S2[kWin] = {};

  auto load_row = [&](int i, uint32_t& left, uint32_t& own) {
    left = own = 0u;
    if (has_cols) {
      const uint8_t* row = Sb + static_cast<size_t>(i) * N;
      own = *reinterpret_cast<const uint32_t*>(row + j0);
      if (j0 >= kCols)
        left = *reinterpret_cast<const uint32_t*>(row + j0 - kCols);
    }
  };

  uint32_t nxt_left, nxt_own;
  load_row(0, nxt_left, nxt_own);
  float best = 0.0f;

  for (int i = 0; i < m; ++i) {
    unpack(nxt_left, nxt_own, S0);
    if (i + 1 < m) load_row(i + 1, nxt_left, nxt_own);

    float Dn[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int k = c + 3;
      const int j = j0 + c;
      float v;
      if (MODE == kQmax) {
        const float pre = fmaxf(fmaxf(D1[k - 1], D2[k - 1]), D1[k - 2]);
        v = S0[k] > 0.0f ? pre + 1.0f : fmaxf(pre - p.gap, 0.0f);
      } else if (MODE == kDmax) {
        const float p1 = D1[k - 1];
        const float p2 = D2[k - 1] + S1[k];
        const float p3 = D1[k - 2] + S0[k - 1];
        const float p4 = (D3[k - 1] + S2[k]) + S1[k];
        const float p5 = (D1[k - 3] + S0[k - 2]) + S0[k - 1];
        const float m5 = fmaxf(fmaxf(fmaxf(p1, p2), p3), fmaxf(p4, p5));
        v = S0[k] > 0.0f ? m5 + 1.0f : fmaxf(m5 - p.gap, 0.0f);
      } else {
        const bool cur = S0[k] > 0.0f;
        const float ms = cur ? p.match : p.mismatch;
        const float e1 = cur ? 0.0f : (S1[k - 1] > 0.0f ? p.go : p.ge);
        const float e2 = cur ? 0.0f : (S2[k - 1] > 0.0f ? p.go : p.ge);
        const float e3 = cur ? 0.0f : (S1[k - 2] > 0.0f ? p.go : p.ge);
        const float d1 = (D1[k - 1] + ms) + e1;
        const float d2 = (D2[k - 1] + ms) + e2;
        const float d3 = (D1[k - 2] + ms) + e3;
        v = fmaxf(fmaxf(fmaxf(d1, d2), d3), 0.0f);
      }
      const bool valid = i >= LO && j >= LO && j < n;
      Dn[c] = valid ? v : 0.0f;
      best = fmaxf(best, Dn[c]);
    }

    float4* buf = xch + (i & 1) * T;
    buf[t] = make_float4(Dn[0], Dn[1], Dn[2], Dn[3]);
    __syncthreads();
    const float4 lf = t > 0 ? buf[t - 1] : make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      if (MODE == kDmax) D3[k] = D2[k];
      D2[k] = D1[k];
      S2[k] = S1[k];
      S1[k] = S0[k];
    }
    D1[0] = lf.y; D1[1] = lf.z; D1[2] = lf.w;
#pragma unroll
    for (int c = 0; c < kCols; ++c) D1[3 + c] = Dn[c];
  }

  // block max of the per-thread running maxima
  __shared__ float warp_best[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if ((t & 31) == 0) warp_best[t >> 5] = best;
  __syncthreads();
  if (t == 0) {
    float r = 0.0f;
    for (int w = 0; w < T / 32; ++w) r = fmaxf(r, warp_best[w]);
    out[b] = r;
  }
}

template <int MODE>
ffi::Error launch(cudaStream_t stream, ffi::Buffer<ffi::U8> S,
                  ffi::Buffer<ffi::S32> m_len, ffi::Buffer<ffi::S32> n_len,
                  ffi::ResultBuffer<ffi::F32> out, Params p) {
  const auto dims = S.dimensions();
  if (dims.size() < 2)
    return ffi::Error::InvalidArgument("S must be (..., M, N)");
  const int64_t M = dims[dims.size() - 2];
  const int64_t N = dims[dims.size() - 1];
  const int64_t B = (M * N == 0) ? 0 : S.element_count() / (M * N);
  if (N % kCols != 0 || N > kMaxN)
    return ffi::Error::InvalidArgument(
        "N must be a multiple of 4 and at most 4096");
  if (m_len.element_count() != B || n_len.element_count() != B ||
      out->element_count() != B)
    return ffi::Error::InvalidArgument("lengths / output must have B entries");
  if (B == 0) return ffi::Error::Success();
  const int threads = static_cast<int>(((N / kCols + 31) / 32) * 32);
  align_kernel<MODE><<<static_cast<unsigned>(B), threads,
                       2 * threads * sizeof(float4), stream>>>(
      S.typed_data(), m_len.typed_data(), n_len.typed_data(),
      static_cast<int>(M), static_cast<int>(N), p, out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error qmax_impl(cudaStream_t stream, ffi::Buffer<ffi::U8> S,
                     ffi::Buffer<ffi::S32> m_len, ffi::Buffer<ffi::S32> n_len,
                     ffi::ResultBuffer<ffi::F32> out, float gap) {
  return launch<kQmax>(stream, S, m_len, n_len, out, Params{gap, 0, 0, 0, 0});
}

ffi::Error dmax_impl(cudaStream_t stream, ffi::Buffer<ffi::U8> S,
                     ffi::Buffer<ffi::S32> m_len, ffi::Buffer<ffi::S32> n_len,
                     ffi::ResultBuffer<ffi::F32> out, float gap) {
  return launch<kDmax>(stream, S, m_len, n_len, out, Params{gap, 0, 0, 0, 0});
}

ffi::Error sw_impl(cudaStream_t stream, ffi::Buffer<ffi::U8> S,
                   ffi::Buffer<ffi::S32> m_len, ffi::Buffer<ffi::S32> n_len,
                   ffi::ResultBuffer<ffi::F32> out, float gap_opening,
                   float gap_extension, float match_score,
                   float mismatch_score) {
  return launch<kSw>(stream, S, m_len, n_len, out,
                     Params{0, gap_opening, gap_extension, match_score,
                            mismatch_score});
}

}  // namespace

#define ACOSS_ALIGN_ARGS                                  \
  ffi::Ffi::Bind()                                        \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()           \
      .Arg<ffi::Buffer<ffi::U8>>()                        \
      .Arg<ffi::Buffer<ffi::S32>>()                       \
      .Arg<ffi::Buffer<ffi::S32>>()                       \
      .Ret<ffi::Buffer<ffi::F32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(AcossQmax, qmax_impl,
                              ACOSS_ALIGN_ARGS.Attr<float>("gap"));
XLA_FFI_DEFINE_HANDLER_SYMBOL(AcossDmax, dmax_impl,
                              ACOSS_ALIGN_ARGS.Attr<float>("gap"));
XLA_FFI_DEFINE_HANDLER_SYMBOL(AcossSw, sw_impl,
                              ACOSS_ALIGN_ARGS.Attr<float>("gap_opening")
                                  .Attr<float>("gap_extension")
                                  .Attr<float>("match_score")
                                  .Attr<float>("mismatch_score"));
