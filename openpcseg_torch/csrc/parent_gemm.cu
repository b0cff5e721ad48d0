// Parent gather: the port's K4 (k2/s2 transposed conv) and K6's dfeats.
//
//   out[f, :] = src[parent[f], :] @ W[parity[f]]      (no parent: zero row)
//
// Every fine row has at most one coarse parent, at one of 8 parities.
//
// Replaces (TPU kernel): openpcseg_tpu/ops/pallas_updown.py:219
// _parent_kernel, launched by _run, with
//   want_dw=False  K4, the up conv (_up2_fwd_pl, entry pallas_conv_up2);
//   want_dw=True   its dfeats half is K6's data gradient (_down2_bwd):
//                  dfeats[i] = dout[parent i] @ W[parity i]^T, called here
//                  with W^T (dW is gather_dw.cu).
// The TPU kernel stages parent windows and selects rows with a one-hot
// matmul, because row gathers are slow there. Here a block gathers rows.
//
// What bounds it on the H100: bytes. A fine row costs 2 * Cin * Cout flops
// for 2 * Cin bytes gathered and 4 * Cout bytes written (32 flop/B at
// 96 -> 96, 85 at 256 -> 256, far below the card's ~295 bf16 flop/B), and
// the f32 output is about two thirds of the traffic. The floor at the
// mk34 shapes is about 8-15 us per call at 3.35 TB/s.
//
// What the design does about it. The rows come grouped by parity: the
// level's ParityPlan (core/geometry.py build_parity_plan, built once per
// step) lists the fine rows of parity 0..7 and then the parentless ones
// (group 8), with ascending source and destination rows in each group,
// and cuts each group into tiles of BM rows. So one block = one tile of
// one parity p:
//   - it stages ONE W[p] slice per channel step, not eight, and loads its
//     BM source and destination row indices once;
//   - the gathered src rows and the W[p] slice come in as 16-byte cp.async
//     copies (zero-filled past a group's end, Cin or Cout) into a ring of
//     STAGES shared-memory stages, so the next steps' loads are in flight
//     while the tensor cores work on this one;
//   - the product runs in bf16 on the tensor cores (nvcuda::wmma 16x16x16,
//     f32 accumulators in registers) over a BN that covers Cout up to 256,
//     so each source row is gathered once (wider Cout: more column blocks);
//   - the epilogue goes through shared memory (aliasing the drained ring)
//     and writes whole f32 rows to their destination with 16-byte stores;
//     group-8 tiles only write zeros. Every output row has exactly one
//     writer: no atomics, the result repeats bit for bit, and the wrapper
//     allocates `out` with torch.empty.
// The grid is sized from the capacity (ceil(N_fine / BM) + 9 tiles, the
// plan's max_tiles); blocks past the plan's last tile exit at once.
// Ragged Cin / Cout (not multiples of 8) take plain element loads instead
// of cp.async, and a Cout not a multiple of 4 element stores.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // fine rows per tile (== the plan's tile_rows)
constexpr int BK = 32;        // input channels per pipeline step
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps as 4 (rows) x 2 (columns)
constexpr int GROUPS = 9;     // 8 parities + the parentless rows
constexpr int A_LD = BK + 8;  // padded leading dims (multiples of 8 bf16
                              //  keep every wmma pointer 32-byte aligned)
constexpr int MAX_NF = 8;     // BN = 32 * NF <= 256

__host__ __device__ constexpr int bn_of(int nf) { return 32 * nf; }
__host__ __device__ constexpr int b_ld(int nf) { return bn_of(nf) + 8; }
__host__ __device__ constexpr int c_ld(int nf) { return bn_of(nf) + 4; }
__host__ __device__ constexpr int a_stage() { return BM * A_LD; }
__host__ __device__ constexpr int b_stage(int nf) { return BK * b_ld(nf); }
__host__ __device__ constexpr size_t smem_bytes(int nf) {
  // the ring, or the f32 epilogue tile that reuses it, whichever is larger
  return (size_t)STAGES * (a_stage() + b_stage(nf)) * 2 >
                 (size_t)BM * c_ld(nf) * 4
             ? (size_t)STAGES * (a_stage() + b_stage(nf)) * 2
             : (size_t)BM * c_ld(nf) * 4;
}

using opcs::cp_async16;
using opcs::cp_async_commit;
using opcs::cp_async_wait;

// NF: 16-column wmma fragments per warp; the block covers BN = 32 * NF
// output channels from column col0 = blockIdx.y * BN.
template <int NF>
__global__ void __launch_bounds__(THREADS)
parent_gemm_kernel(const __nv_bfloat16* __restrict__ src,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ src_rows,
                   const int* __restrict__ dst_rows,
                   const int* __restrict__ group_off,
                   const int* __restrict__ tile_off, float* __restrict__ out,
                   int cin, int cout) {
  constexpr int BN = bn_of(NF);
  constexpr int B_LD = b_ld(NF);
  constexpr int C_LD = c_ld(NF);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + STAGES * a_stage();
  float* c_s = reinterpret_cast<float*>(smem);
  __shared__ int src_s[BM];
  __shared__ int dst_s[BM];

  // this block's tile: group g is the last whose first tile is <= t
  // (empty groups share their successor's first tile and are passed over)
  const int t = blockIdx.x;
  if (t >= tile_off[GROUPS]) return;
  int g = 0;
#pragma unroll
  for (int q = 1; q < GROUPS; ++q) g += t >= tile_off[q];
  const int row0 = group_off[g] + (t - tile_off[g]) * BM;
  const int rows = min(BM, group_off[g + 1] - row0);
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  if (tid < BM) {
    src_s[tid] = tid < rows ? src_rows[row0 + tid] : -1;
    dst_s[tid] = tid < rows ? dst_rows[row0 + tid] : -1;
  }
  __syncthreads();
  const bool vec_out = (cout % 4) == 0;

  if (g == GROUPS - 1) {  // rows without a parent: zeros
    for (int v = tid; v < BM * (BN / 4); v += THREADS) {
      const int r = v / (BN / 4);
      const int j = col0 + (v % (BN / 4)) * 4;
      const int d = dst_s[r];
      if (d < 0 || j >= cout) continue;
      float* o = out + (size_t)d * cout + j;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int e = 0; e < 4 && j + e < cout; ++e) o[e] = 0.0f;
      }
    }
    return;
  }

  const __nv_bfloat16* wp = w + (size_t)g * cin * cout;
  const bool vec_a = (cin % 8) == 0;
  const bool vec_b = (cout % 8) == 0;
  const int nk = opcs::ceil_div(cin, BK);

  // stage `st` <- A: BM gathered rows x BK channels; B: W[g] rows
  // c0..c0+BK x columns col0..col0+BN. Zero past the tile, Cin and Cout.
  auto load = [&](int kt, int st) {
    const int c0 = kt * BK;
    __nv_bfloat16* as = a_s + st * a_stage();
    __nv_bfloat16* bs = b_s + st * b_stage(NF);
    for (int v = tid; v < BM * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8);
      const int cv = (v % (BK / 8)) * 8;
      const int s = src_s[r];
      const int c = c0 + cv;
      __nv_bfloat16* dst = as + r * A_LD + cv;
      if (vec_a) {
        const bool ok = s >= 0 && c < cin;
        cp_async16(dst, ok ? src + (size_t)s * cin + c : src, ok);
      } else {
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (s >= 0)
          for (int e = 0; e < 8 && c + e < cin; ++e)
            val.h[e] = src[(size_t)s * cin + c + e];
        *reinterpret_cast<uint4*>(dst) = val.u;
      }
    }
    for (int v = tid; v < BK * (BN / 8); v += THREADS) {
      const int kr = v / (BN / 8);
      const int cv = (v % (BN / 8)) * 8;
      const int c = c0 + kr;
      const int j = col0 + cv;
      __nv_bfloat16* dst = bs + kr * B_LD + cv;
      if (vec_b) {
        const bool ok = c < cin && j < cout;
        cp_async16(dst, ok ? wp + (size_t)c * cout + j : wp, ok);
      } else {
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (c < cin)
          for (int e = 0; e < 8 && j + e < cout; ++e)
            val.h[e] = wp[(size_t)c * cout + j + e];
        *reinterpret_cast<uint4*>(dst) = val.u;
      }
    }
  };

  const int warp = tid / 32;
  const int wm = warp / 2;           // rows wm*16 .. +16
  const int wn = warp % 2;           // columns wn*BN/2 .. +BN/2
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt, nxt % STAGES);
    cp_async_commit();            // (an empty group keeps the count)
    const __nv_bfloat16* as = a_s + (kt % STAGES) * a_stage();
    const __nv_bfloat16* bs = b_s + (kt % STAGES) * b_stage(NF);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, as + (wm * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * B_LD + wn * (BN / 2) + j * 16,
                               B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained and read: reuse it as c_s

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(c_s + (wm * 16) * C_LD + wn * (BN / 2) + j * 16,
                            acc[j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * (BN / 4); v += THREADS) {
    const int r = v / (BN / 4);
    const int jj = (v % (BN / 4)) * 4;
    const int j = col0 + jj;
    const int d = dst_s[r];
    if (d < 0 || j >= cout) continue;
    const float* cv = c_s + r * C_LD + jj;
    float* o = out + (size_t)d * cout + j;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(cv);
    } else {
      for (int e = 0; e < 4 && j + e < cout; ++e) o[e] = cv[e];
    }
  }
}

template <int NF>
int launch(const void* src, const void* w, const void* src_rows,
           const void* dst_rows, const void* group_off, const void* tile_off,
           void* out, int cin, int cout, int max_tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(NF);
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        parent_gemm_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(max_tiles, opcs::ceil_div(cout, bn_of(NF)));
  parent_gemm_kernel<NF><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)src, (const __nv_bfloat16*)w,
      (const int*)src_rows, (const int*)dst_rows, (const int*)group_off,
      (const int*)tile_off, (float*)out, cin, cout);
  return (int)cudaGetLastError();
}

}  // namespace

// src [n_src, cin] bf16, w [8, cin, cout] bf16, src_rows / dst_rows
// [n_out] int32, group_off / tile_off [10] int32 (a ParityPlan built with
// tile_rows == BM), out [n_out, cout] f32, every row written. All
// contiguous. max_tiles bounds tile_off[9] (the grid's x size).
OPCS_API int opcs_parent_gemm_bf16(const void* src, const void* w,
                                   const void* src_rows, const void* dst_rows,
                                   const void* group_off,
                                   const void* tile_off, void* out, int cin,
                                   int cout, int max_tiles, int tile_rows,
                                   void* stream) {
  if (tile_rows != BM) return (int)cudaErrorInvalidValue;
  if (max_tiles <= 0 || cout <= 0) return (int)cudaGetLastError();
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, int, int, int,
                         cudaStream_t);
  static constexpr Launch by_nf[MAX_NF] = {launch<1>, launch<2>, launch<3>,
                                           launch<4>, launch<5>, launch<6>,
                                           launch<7>, launch<8>};
  const int nf = opcs::ceil_div(cout, 32);
  return by_nf[(nf < MAX_NF ? nf : MAX_NF) - 1](
      src, w, src_rows, dst_rows, group_off, tile_off, out, cin, cout,
      max_tiles, (cudaStream_t)stream);
}
