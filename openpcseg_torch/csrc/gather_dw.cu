// Gathered weight gradient: the dW half of the port's K2, K5 and K6.
//
//   dW[k, :, :] = sum_{n < N} A[ia[k, n], :]^T  B[ib[k, n], :]
//
// A [*, Ca] and B [*, Cb] are bf16; either index array may be absent (the
// identity, ia[k, n] = n), and an index of -1 on either side drops the
// pair. dW [K, Ca, Cb] is float32. Every weight gradient of a sparse conv
// is this sum over its own kernel map:
//   subm (K2): A = feats gathered by kmap [27, N],  B = dout;
//   down (K6): A = fine feats gathered by the down map [8, Nc], B = dout;
//   up   (K5): A = coarse feats, B = fine dout gathered by the coarse
//              level's down map [8, Nc] (the one-hot up map would leave 7
//              of every 8 gathered rows empty).
//
// Replaces the dW accumulation of the TPU kernels
//   K2 openpcseg_tpu/ops/pallas_conv.py:_bwd_kernel (via _run_bwd),
//   K5 openpcseg_tpu/ops/pallas_updown.py:_pair_kernel, want_dw=True,
//   K6 openpcseg_tpu/ops/pallas_updown.py:_parent_kernel, want_dw=True,
// which carry dwacc in VMEM from one grid step to the next. On Hopper the
// blocks run in no order, so nothing carries over between them: the
// reduction over N is split into chunks, each block writes the float32
// partial sum of its chunk, and a second pass in this file sums the chunks
// in a fixed order. dW is therefore bit-identical from run to run (no
// atomics anywhere).
//
// What bounds it on the H100: the row gathers, as in gather_gemm.cu. A
// block owns a TM x TN tile of one dW[k] and one chunk of N; per TK rows it
// loads TK index pairs, skips the step when every pair misses
// (__syncthreads_or), gathers TK rows of A and of B into shared memory
// (16-byte loads where the width is a multiple of 8, else per element:
// the 4-channel stem) and runs wmma bf16 16x16x16 with A^T read as a
// column-major fragment and f32 accumulation in registers. The wrapper
// sizes the chunks so that the grid fills the card while the partial
// buffer stays bounded (ops/subm_conv.py gather_dw).
// Left for later: fusing dW with the dfeats pass over one gathered tile (as
// the TPU kernels do), cp.async double buffering, wgmma.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TM = 64;        // dW rows (A channels) per block
constexpr int TN = 64;        // dW columns (B channels) per block
constexpr int TK = 32;        // N rows per step
constexpr int THREADS = 128;  // 4 warps as 2 x 2, each owning 32 x 32
constexpr int A_LD = TM + 8;  // padded leading dims (multiples of 8 bf16
constexpr int B_LD = TN + 8;  //  keep every wmma pointer 32-byte aligned)
constexpr int C_LD = TN + 4;

// Gather TK rows [c0, c0 + 64) of x (width c) by rows_s into dst [TK][LD].
template <int LD>
__device__ __forceinline__ void gather_tile(
    const __nv_bfloat16* __restrict__ x, const int* rows_s, int c, int c0,
    bool vec, __nv_bfloat16* dst, int tid) {
  for (int v = tid; v < TK * 8; v += THREADS) {
    const int r = v / 8;
    const int cv = (v % 8) * 8;
    const int src = rows_s[r];
    const int ch = c0 + cv;
    opcs::Bf16x8 val;
    val.u = make_uint4(0, 0, 0, 0);
    if (src >= 0 && ch < c) {
      const __nv_bfloat16* p = x + (size_t)src * c + ch;
      if (vec) {
        val.u = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ch + e < c) val.h[e] = p[e];
      }
    }
    *reinterpret_cast<uint4*>(&dst[r * LD + cv]) = val.u;
  }
}

__global__ void __launch_bounds__(THREADS)
gather_dw_kernel(const __nv_bfloat16* __restrict__ a,
                 const int* __restrict__ ia,
                 const __nv_bfloat16* __restrict__ b,
                 const int* __restrict__ ib, float* __restrict__ out, int n,
                 int num_k, int ca, int cb, int rows_per_chunk) {
  __shared__ __align__(128) __nv_bfloat16 a_s[TK * A_LD];
  __shared__ __align__(128) __nv_bfloat16 b_s[TK * B_LD];
  __shared__ __align__(128) float c_s[TM * C_LD];
  __shared__ int ra_s[TK];
  __shared__ int rb_s[TK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int tiles_n = opcs::ceil_div(cb, TN);
  const int ca0 = (blockIdx.x / tiles_n) * TM;
  const int cb0 = (blockIdx.x % tiles_n) * TN;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int n0 = chunk * rows_per_chunk;
  const int n1 = min(n, n0 + rows_per_chunk);
  const bool vec_a = (ca % 8) == 0;
  const bool vec_b = (cb % 8) == 0;
  const bool warp_live = ca0 + wm * 32 < ca && cb0 + wn * 32 < cb;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = n0; s < n1; s += TK) {
    bool ok = false;
    if (tid < TK) {
      const int r = s + tid;
      int ra = -1, rb = -1;
      if (r < n1) {
        ra = ia ? ia[(size_t)k * n + r] : r;
        rb = ib ? ib[(size_t)k * n + r] : r;
      }
      ok = ra >= 0 && rb >= 0;
      ra_s[tid] = ok ? ra : -1;
      rb_s[tid] = ok ? rb : -1;
    }
    // the barrier also publishes the rows; skip steps where all pairs miss
    if (!__syncthreads_or(ok)) continue;

    gather_tile<A_LD>(a, ra_s, ca, ca0, vec_a, a_s, tid);
    gather_tile<B_LD>(b, rb_s, cb, cb0, vec_b, b_s, tid);
    __syncthreads();
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        // a_s is [n][ca]: read as A^T [ca][n] it is column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &a_s[kk * A_LD + wm * 32 + i * 16],
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
  // this chunk's slice of the [n_chunks, K, Ca, Cb] partials (or of dW
  // itself when there is one chunk); warps past Ca / Cb stored nothing,
  // and their columns are masked here
  float* dst = out + ((size_t)chunk * num_k + k) * ca * cb;
  for (int v = tid; v < TM * TN; v += THREADS) {
    const int r = v / TN;
    const int j = v % TN;
    if (ca0 + r < ca && cb0 + j < cb)
      dst[(size_t)(ca0 + r) * cb + cb0 + j] = c_s[r * C_LD + j];
  }
}

// out[i] = sum over chunks c = 0, 1, ... in that order of partial[c][i]
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, long total,
                                  int n_chunks) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += partial[c * total + i];
    out[i] = s;
  }
}

}  // namespace

// a [*, ca] bf16, ia [K, n] int32 or NULL (identity), b [*, cb] bf16,
// ib [K, n] int32 or NULL, partial [n_chunks, K, ca, cb] f32 scratch (unused
// and may be NULL when n_chunks == 1), out [K, ca, cb] f32. Chunk c covers
// rows [c * rows_per_chunk, (c + 1) * rows_per_chunk) of n. All contiguous.
OPCS_API int opcs_gather_dw_bf16(const void* a, const void* ia, const void* b,
                                 const void* ib, void* partial, void* out,
                                 int n, int num_k, int ca, int cb,
                                 int rows_per_chunk, int n_chunks,
                                 void* stream) {
  if (num_k <= 0 || ca <= 0 || cb <= 0) return (int)cudaGetLastError();
  if (n_chunks < 1 || rows_per_chunk < 1 ||
      (long)n_chunks * rows_per_chunk < n || (n_chunks > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = n_chunks > 1 ? (float*)partial : (float*)out;
  dim3 grid(opcs::ceil_div(ca, TM) * opcs::ceil_div(cb, TN), num_k, n_chunks);
  gather_dw_kernel<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)a, (const int*)ia, (const __nv_bfloat16*)b,
      (const int*)ib, dst, n, num_k, ca, cb, rows_per_chunk);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const long total = (long)num_k * ca * cb;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  sum_chunks_kernel<<<blocks, 256, 0, st>>>((const float*)partial,
                                            (float*)out, total, n_chunks);
  return (int)cudaGetLastError();
}
