// Parent gather: the port's K4, the k2/s2 transposed (up) conv.
//
//   out[f, :] = src[parent[f], :] @ W[parity[f]]      (parent -1: zero row)
//
// Every fine row has exactly one coarse parent and one of 8 parities, so
// this is one gathered row times one of eight [Cin, Cout] matrices per row.
//
// Replaces (TPU kernel): openpcseg_tpu/ops/pallas_updown.py:_parent_kernel
// with want_dw=False (launched by _run from _up2_fwd_pl, entry
// pallas_conv_up2). The TPU kernel stages parent windows and selects rows
// with a one-hot matmul; here each block gathers its parent rows directly.
// It is NOT run as a K = 8 gather-GEMM: 7 of the 8 offsets miss on every
// row, which would multiply the tensor-core work by eight.
//
// What bounds it on the H100: the W[parity] reads and the FMA issue rate.
// A block owns PM fine rows x PN output channels. Per PK-channel step it
// stages its PM gathered parent rows (f32, channel-major so a warp reads a
// broadcast) and the PK x PN slice of each W[p] whose parity p occurs in
// the block (a bit mask skips the others) in shared memory; each thread
// then accumulates 16 output channels of one row in f32 registers from
// 4 x 16-byte shared loads per input channel. Plain FMA keeps the
// per-row choice of matrix simple; the work (2 * N * Cin * Cout, about
// 5 GFLOP for the four decoder ups of mk34 on a full scan) is small beside
// the submanifold convs. Tile edges (rows, Cin, Cout) are masked.
#include "common.cuh"

namespace {

constexpr int PM = 64;        // fine rows per block
constexpr int PN = 64;        // output channels per block
constexpr int PK = 16;        // input channels per step
constexpr int THREADS = 256;  // thread t: row t / 4, channels (t % 4) * 16..
constexpr int COLS = 16;      // output channels per thread

__global__ void __launch_bounds__(THREADS)
parent_gemm_kernel(const __nv_bfloat16* __restrict__ src,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ parent,
                   const int* __restrict__ parity, float* __restrict__ out,
                   int n_out, int cin, int cout) {
  __shared__ __align__(16) float w_s[8][PK][PN];
  __shared__ float a_s[PK][PM];
  __shared__ int par_s[PM];
  __shared__ int src_s[PM];
  __shared__ unsigned int mask_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * PM;
  const int col0 = blockIdx.y * PN;
  if (tid == 0) mask_s = 0u;
  __syncthreads();
  if (tid < PM) {
    const int r = row0 + tid;
    const int p = r < n_out ? parent[r] : -1;
    const int q = p >= 0 ? (parity[r] & 7) : 0;
    src_s[tid] = p;
    par_s[tid] = q;
    if (p >= 0) atomicOr(&mask_s, 1u << q);
  }
  __syncthreads();
  const unsigned int mask = mask_s;

  const int r = tid / 4;
  const int cg = (tid % 4) * COLS;
  float acc[COLS];
#pragma unroll
  for (int e = 0; e < COLS; ++e) acc[e] = 0.0f;

  if (mask != 0u) {
    for (int c0 = 0; c0 < cin; c0 += PK) {
      for (int v = tid; v < PM * PK; v += THREADS) {
        const int rr = v / PK;
        const int c = v % PK;
        const int s = src_s[rr];
        float x = 0.0f;
        if (s >= 0 && c0 + c < cin) x = opcs::to_f32(src[(size_t)s * cin + c0 + c]);
        a_s[c][rr] = x;
      }
      for (int v = tid; v < 8 * PK * PN; v += THREADS) {
        const int p = v / (PK * PN);
        if (!((mask >> p) & 1u)) continue;
        const int c = (v / PN) % PK;
        const int j = v % PN;
        float x = 0.0f;
        if (c0 + c < cin && col0 + j < cout)
          x = opcs::to_f32(w[((size_t)p * cin + c0 + c) * cout + col0 + j]);
        w_s[p][c][j] = x;
      }
      __syncthreads();
      const int q = par_s[r];
#pragma unroll
      for (int c = 0; c < PK; ++c) {
        const float a = a_s[c][r];
        const float4* wr = reinterpret_cast<const float4*>(&w_s[q][c][cg]);
#pragma unroll
        for (int e = 0; e < COLS / 4; ++e) {
          const float4 wv = wr[e];
          acc[4 * e + 0] += a * wv.x;
          acc[4 * e + 1] += a * wv.y;
          acc[4 * e + 2] += a * wv.z;
          acc[4 * e + 3] += a * wv.w;
        }
      }
      __syncthreads();
    }
  }

  const int row = row0 + r;
  if (row < n_out) {
#pragma unroll
    for (int e = 0; e < COLS; ++e) {
      const int j = col0 + cg + e;
      if (j < cout) out[(size_t)row * cout + j] = acc[e];
    }
  }
}

}  // namespace

// src [n_src, cin] bf16, w [8, cin, cout] bf16, parent / parity [n_out]
// int32 (parent -1 = no parent), out [n_out, cout] f32. All contiguous.
OPCS_API int opcs_parent_gemm_bf16(const void* src, const void* w,
                                   const void* parent, const void* parity,
                                   void* out, int n_out, int cin, int cout,
                                   void* stream) {
  if (n_out > 0 && cout > 0) {
    dim3 grid(opcs::ceil_div(n_out, PM), opcs::ceil_div(cout, PN));
    parent_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)src, (const __nv_bfloat16*)w,
        (const int*)parent, (const int*)parity, (float*)out, n_out, cin,
        cout);
  }
  return (int)cudaGetLastError();
}
