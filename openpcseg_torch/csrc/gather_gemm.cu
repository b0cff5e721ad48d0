// Gather-GEMM over a dense kernel map: the port's K1 and K3.
//
//   out[n, :] = sum_{k < K} sum_{c < Cin} feats[kmap[k, n], c] * W[k, c, :]
//
// with kmap[k, n] == -1 meaning "no input at this offset" (adds zero).
//
// Replaces (TPU kernels):
//   K1  openpcseg_tpu/ops/pallas_conv.py:_fwd_kernel (launched by _run_fwd,
//       entry pallas_window_subm_conv): the 3x3x3 submanifold conv, K = 27.
//   K3  openpcseg_tpu/ops/pallas_updown.py:_pair_kernel with want_dw=False
//       (launched by _run from _down2_fwd, entry pallas_conv_down2): the
//       k2/s2 strided down conv, K = 8.
// The TPU kernels stage a z-window table (w3), per-block window plans and a
// one-hot-as-matmul row selection, because row gathers are slow on a TPU.
// None of that is carried over: on Hopper a block gathers its rows directly.
//
// What bounds it on the H100: the row gathers. A block owns BM output rows x
// BN output channels; for each offset k it reads BM row indices, gathers BM
// rows of Cin bf16 (16-byte vector loads where Cin % 8 == 0, else per
// element: the 4-channel stem), and multiplies them against W[k] on the
// tensor cores (nvcuda::wmma bf16 16x16x16, f32 accumulation in registers).
// The arithmetic (2 * hits * Cin * Cout) is far below the card's bf16 rate;
// the gathered bytes (hits * Cin * 2, re-read once per BN column block) and
// the per-k barriers are what the time is made of. What the design does:
//   - an offset whose BM indices all miss is skipped by the whole block
//     (__syncthreads_or), so empty kernel-map tiles cost one index load;
//   - the output tile stays in registers across all K offsets and is
//     written once, as f32 (the TPU kernels' output type,
//     pallas_conv.py:451 / pallas_updown.py:318);
//   - tile edges (rows >= N, channels >= Cin or >= Cout) are masked, so
//     96 / 192 / 384-channel layers and Cin = 4 need no padded copies.
// Left for later: cp.async / TMA double buffering, wgmma, a BN that
// matches Cout, and sharing one gather across the column blocks.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per step
constexpr int THREADS = 128; // 4 warps as 2 x 2, each owning 32 x 32
constexpr int A_LD = BK + 8; // padded leading dims (multiples of 8 bf16,
constexpr int B_LD = BN + 8; //  keep every wmma pointer 32-byte aligned)
constexpr int C_LD = BN + 4;

__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ kmap, float* __restrict__ out,
                   int n_out, int num_k, int cin, int cout) {
  __shared__ __align__(128) __nv_bfloat16 a_s[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 b_s[BK * B_LD];
  __shared__ __align__(128) float c_s[BM * C_LD];
  __shared__ int rows_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const bool vec_a = (cin % 8) == 0;
  const bool vec_b = (cout % 8) == 0;
  const bool warp_live = col0 + wn * 32 < cout;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k = 0; k < num_k; ++k) {
    int mine = -1;
    if (tid < BM) {
      const int r = row0 + tid;
      mine = r < n_out ? kmap[(size_t)k * n_out + r] : -1;
      rows_s[tid] = mine;
    }
    // the barrier also publishes rows_s; skip offsets the whole tile misses
    if (!__syncthreads_or(mine >= 0)) continue;

    const __nv_bfloat16* wk = w + (size_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // A tile: BM gathered rows x BK channels, zero on a miss / past Cin
      for (int v = tid; v < BM * (BK / 8); v += THREADS) {
        const int r = v / (BK / 8);
        const int cv = (v % (BK / 8)) * 8;
        const int src = rows_s[r];
        const int c = c0 + cv;
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (src >= 0 && c < cin) {
          const __nv_bfloat16* p = feats + (size_t)src * cin + c;
          if (vec_a) {
            val.u = *reinterpret_cast<const uint4*>(p);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c + e < cin) val.h[e] = p[e];
          }
        }
        *reinterpret_cast<uint4*>(&a_s[r * A_LD + cv]) = val.u;
      }
      // B tile: W[k][c0:c0+BK, col0:col0+BN], zero past Cin / Cout
      for (int v = tid; v < BK * (BN / 8); v += THREADS) {
        const int kr = v / (BN / 8);
        const int cv = (v % (BN / 8)) * 8;
        const int c = c0 + kr;
        const int j = col0 + cv;
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (c < cin && j < cout) {
          const __nv_bfloat16* p = wk + (size_t)c * cout + j;
          if (vec_b) {
            val.u = *reinterpret_cast<const uint4*>(p);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (j + e < cout) val.h[e] = p[e];
          }
        }
        *reinterpret_cast<uint4*>(&b_s[kr * B_LD + cv]) = val.u;
      }
      __syncthreads();
      if (warp_live) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], &a_s[(wm * 32 + i * 16) * A_LD + kk],
                                   A_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], &b_s[kk * B_LD + wn * 32 + j * 16],
                                   B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if (warp_live) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &c_s[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j],
            C_LD, wmma::mem_row_major);
  }
  __syncthreads();
  for (int v = tid; v < BM * BN; v += THREADS) {
    const int r = v / BN;
    const int j = v % BN;
    if (row0 + r < n_out && col0 + j < cout)
      out[(size_t)(row0 + r) * cout + col0 + j] = c_s[r * C_LD + j];
  }
}

}  // namespace

// feats [n_in, cin] bf16, w [num_k, cin, cout] bf16, kmap [num_k, n_out]
// int32 (-1 miss, else < n_in), out [n_out, cout] f32. All contiguous.
OPCS_API int opcs_gather_gemm_bf16(const void* feats, const void* w,
                                   const void* kmap, void* out, int n_out,
                                   int num_k, int cin, int cout,
                                   void* stream) {
  if (n_out > 0 && cout > 0) {
    dim3 grid(opcs::ceil_div(n_out, BM), opcs::ceil_div(cout, BN));
    gather_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w,
        (const int*)kmap, (float*)out, n_out, num_k, cin, cout);
  }
  return (int)cudaGetLastError();
}
