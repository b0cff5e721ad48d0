// Gather-GEMM over a dense kernel map: the port's K1 and K3, and the data
// gradients of K2 and K5.
//
//   out[n, :] = sum_{k < K} sum_{c < Cin} feats[kmap[k', n], c] * W[k, c, :]
//
// with k' = k, or k' = K - 1 - k when `reverse` is set (the submanifold
// data gradient reads the offset-reversed map without a flipped copy), and
// kmap[k', n] == -1 meaning "no input at this offset" (adds zero).
//
// Replaces (TPU kernels):
//   K1  openpcseg_tpu/ops/pallas_conv.py:_fwd_kernel (launched by _run_fwd,
//       entry pallas_window_subm_conv): the 3x3x3 submanifold conv, K = 27;
//       its backward _bwd_kernel's data gradient (K2) is this kernel over
//       the reversed map with W[k]^T;
//   K3  openpcseg_tpu/ops/pallas_updown.py:_pair_kernel with want_dw=False
//       (launched by _run from _down2_fwd, entry pallas_conv_down2): the
//       k2/s2 strided down conv, K = 8; with want_dw=True its data gradient
//       (K5, the up conv's backward) is this kernel over the coarse level's
//       down map with W[k]^T.
// The TPU kernels stage a z-window table (w3), per-block window plans and a
// one-hot-as-matmul row selection, because row gathers are slow on a TPU.
// None of that is carried over: on Hopper a block gathers its rows directly.
//
// What bounds it on the H100: bytes. At L0 96 -> 96 of a 131,072-point scan
// the map (10.6 MB), the rows read once, W and the f32 output (37.7 MB) are
// 60.8 MB, 18.1 us at 3.35 TB/s, against 4.6 GFLOP of hits (4.7 us at 989
// TFLOP/s) on ray-cast scan 0; chip_smoke.py computes this bound for every
// case. An
// output-stationary tile multiplies all its rows at every live offset,
// though most of them miss there, and reads W[k] again for every row tile,
// so the tensor cores and the loads, not the bytes of the bound, set the
// time (tools/scripts/torch_gather_gemm_breakdown.py times each part).
// What the design does:
//   - one block = BM output rows (128 on the large levels, 64 on the small
//     ones) x BN columns, 8 warps; BN covers Cout up to 128 (BM 128) or 256
//     (BM 64), so each gathered row enters shared memory once per offset.
//     Where the capacity gives fewer than TARGET_BLOCKS row tiles (the deep
//     levels), Cout is split into more column blocks so that the card
//     fills: there W dominates and each column block streams its part;
//   - warps tile the block as 4 x 2 (BM 128) or 2 x 4 (BM 64), each owning
//     32 rows (two 16-row fragments) and BN / 2 or BN / 4 columns;
//   - the block loads its whole index slice kmap[0:K, rows] into shared
//     memory once and lists its live offsets (those with any hit); the
//     pipeline walks only the live (offset, BK-channel) steps, and a tile
//     without any hit (the padding rows) writes zeros and exits;
//   - gathered rows and the W[k] slice arrive by 16-byte cp.async
//     (zero-filled on a miss) into a ring of 2 stages (3 at BK 64), so the
//     next steps' loads are in flight while the tensor cores (nvcuda::wmma
//     bf16 16x16x16, f32 accumulators in registers across all offsets)
//     work; a step is 64 channels deep where Cin allows, else 32;
//   - on the small levels few tiles carry voxels while each walks 27
//     offsets x Cin / BK steps in series, so the wrapper may split a tile's
//     live offsets among `splits` blocks (grid z): each writes a float32
//     partial tile, and the one that finishes last (an atomic counter per
//     tile decides which, nothing else is atomic) sums the partials in
//     split order;
//   - the epilogue writes whole f32 rows through shared memory (aliasing
//     the drained ring) with 16-byte stores: one writer per element, and
//     the same sums in the same order on every run.
// The sum order over (offset, channel) depends on the shapes only (through
// the splits), so the result repeats bit for bit.
// Ragged Cin / Cout (not multiples of 8: the 4-channel stem) take element
// loads instead of cp.async, and a Cout not a multiple of 4 element stores.
// Occupancy: opcs_gather_gemm_config reports the tiling, the dynamic shared
// memory and the blocks per SM of a launch, and chip_smoke.py logs them
// beside ptxas's registers and spills: 29-109 KB of shared memory and 2-4
// blocks per SM at the main-path shapes; 59-134 registers over the 16
// instances (98 at most in those the main path launches), no spills.
// Left for later: compacting each offset's hit rows (the dense tiles do
// several times the MMAs of the hits), wgmma, TMA multicast of W[k] to the
// row tiles of a cluster, fusing the data and weight gradients
// over one gathered tile (the TPU kernels do), fusing the BN / ReLU
// epilogue.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int MF = 2;            // 16-row fragments per warp (32 rows)
constexpr int THREADS = 256;     // 8 warps
constexpr int MAX_K = 32;        // offsets per map (27 or 8 here)
constexpr int TARGET_BLOCKS = 512;  // row x column blocks to aim for
constexpr int BIG_ROW_TILES = 256;  // BM 128 when it still gives this many

// WM: warps along the rows (4: BM 128, 2: BM 64), the other 8 / WM along
// the columns; NF: 16-column fragments per warp; BK: input channels per
// pipeline step (32 or 64), with a ring of 2 or 3 stages (at BK 32 a third
// stage costs the SM a block, which gains more than the deeper ring).
template <int WM, int NF, int BK>
struct Tile {
  static constexpr int WN = 8 / WM;
  static constexpr int BM = 16 * MF * WM;
  static constexpr int BN = 16 * NF * WN;
  static constexpr int STAGES = BK == 64 ? 3 : 2;
  static constexpr int A_LD = BK + 8;  // padded leading dims (multiples of 8
  static constexpr int B_LD = BN + 8;  //  bf16: every wmma pointer 32-byte
  static constexpr int C_LD = BN + 4;  //  aligned)
  static constexpr int A_STAGE = BM * A_LD;
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr size_t RING = (size_t)STAGES * (A_STAGE + B_STAGE) * 2;
  static constexpr size_t EPI = (size_t)BM * C_LD * 4;
  // the ring (or the f32 epilogue tile that reuses it), then the indices
  static constexpr size_t IDX_OFF = RING > EPI ? RING : EPI;
  static size_t smem(int num_k) { return IDX_OFF + (size_t)num_k * BM * 4; }
};

template <int WM, int NF, int BK>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ kmap, float* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int n_out, int num_k, int cin, int cout, int reverse,
                   int splits, int vec_a, int vec_b) {
  using T = Tile<WM, NF, BK>;
  constexpr int BM = T::BM;
  constexpr int BN = T::BN;
  constexpr int STAGES = T::STAGES;
  constexpr int A_LD = T::A_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + STAGES * T::A_STAGE;
  float* c_s = reinterpret_cast<float*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + T::IDX_OFF);  // [num_k][BM]
  __shared__ int live_flag_s[MAX_K];
  __shared__ int live_s[MAX_K];
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  if (tid < MAX_K) live_flag_s[tid] = 0;
  __syncthreads();
  // the block's index slice, once; an offset is live if any row hits
  for (int v = tid; v < num_k * BM; v += THREADS) {
    const int k = v / BM;
    const int r = row0 + v % BM;
    const int km = reverse ? num_k - 1 - k : k;
    const int i = r < n_out ? kmap[(size_t)km * n_out + r] : -1;
    idx_s[v] = i;
    if (i >= 0) live_flag_s[k] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < num_k; ++k)
      if (live_flag_s[k]) live_s[n++] = k;
    n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const bool vec_out = (cout % 4) == 0;

  if (n_live == 0) {  // no hit at all (padding rows): zero rows, once
    if (blockIdx.z != 0) return;
    for (int v = tid; v < BM * (BN / 4); v += THREADS) {
      const int r = row0 + v / (BN / 4);
      const int j = col0 + (v % (BN / 4)) * 4;
      if (r >= n_out || j >= cout) continue;
      float* o = out + (size_t)r * cout + j;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int e = 0; e < 4 && j + e < cout; ++e) o[e] = 0.0f;
      }
    }
    return;
  }

  // this split's share of the live offsets: [kk0, kk1) of live_s
  const int kk0 = (int)((long)blockIdx.z * n_live / splits);
  const int kk1 = (int)((long)(blockIdx.z + 1) * n_live / splits);
  const int nkc = opcs::ceil_div(cin, BK);
  const int steps = (kk1 - kk0) * nkc;

  // stage `st` <- step s: A = BM gathered rows x BK channels at the s-th
  // live offset, B = W[k] rows c0..c0+BK x columns col0..col0+BN; zero on a
  // miss and past Cin / Cout
  auto load = [&](int s, int st) {
    const int kk = s / nkc;
    const int c0 = (s - kk * nkc) * BK;
    const int k = live_s[kk0 + kk];
    const int* rows = idx_s + k * BM;
    const __nv_bfloat16* wk = w + (size_t)k * cin * cout;
    __nv_bfloat16* as = a_s + st * T::A_STAGE;
    __nv_bfloat16* bs = b_s + st * T::B_STAGE;
    for (int v = tid; v < BM * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8);
      const int cv = (v % (BK / 8)) * 8;
      const int src = rows[r];
      const int c = c0 + cv;
      __nv_bfloat16* dst = as + r * A_LD + cv;
      if (vec_a) {
        const bool ok = src >= 0 && c < cin;
        opcs::cp_async16(dst, ok ? feats + (size_t)src * cin + c : feats, ok);
      } else {
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (src >= 0)
          for (int e = 0; e < 8 && c + e < cin; ++e)
            val.h[e] = feats[(size_t)src * cin + c + e];
        *reinterpret_cast<uint4*>(dst) = val.u;
      }
    }
    for (int v = tid; v < BK * (BN / 8); v += THREADS) {
      const int kr = v / (BN / 8);
      const int cv = (v % (BN / 8)) * 8;
      const int c = c0 + kr;
      const int j = col0 + cv;
      __nv_bfloat16* dst = bs + kr * T::B_LD + cv;
      if (vec_b) {
        const bool ok = c < cin && j < cout;
        opcs::cp_async16(dst, ok ? wk + (size_t)c * cout + j : wk, ok);
      } else {
        opcs::Bf16x8 val;
        val.u = make_uint4(0, 0, 0, 0);
        if (c < cin)
          for (int e = 0; e < 8 && j + e < cout; ++e)
            val.h[e] = wk[(size_t)c * cout + j + e];
        *reinterpret_cast<uint4*>(dst) = val.u;
      }
    }
  };

  const int warp = tid / 32;
  const int wm = warp / T::WN;  // rows wm * 32 .. + 32
  const int wn = warp % T::WN;  // columns wn * 16 NF .. + 16 NF
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, st);
    opcs::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    opcs::cp_async_wait<STAGES - 2>();  // step s has landed (this thread)
    __syncthreads();                    // ... everyone's; stage s-1 is free
    const int nxt = s + STAGES - 1;
    if (nxt < steps) load(nxt, nxt % STAGES);
    opcs::cp_async_commit();            // (an empty group keeps the count)
    const __nv_bfloat16* as = a_s + (s % STAGES) * T::A_STAGE;
    const __nv_bfloat16* bs = b_s + (s % STAGES) * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[MF];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 16 * MF + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * T::B_LD + wn * 16 * NF + j * 16,
                               T::B_LD);
#pragma unroll
        for (int i = 0; i < MF; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  opcs::cp_async_wait<0>();
  __syncthreads();  // the ring is drained and read: reuse it as c_s

#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(
          c_s + (wm * 16 * MF + i * 16) * T::C_LD + wn * 16 * NF + j * 16,
          acc[i][j], T::C_LD, wmma::mem_row_major);
  __syncthreads();
  // one split: the tile is the result. Several: each writes its partial
  // tile, and the split that finishes last (a counter per tile) sums all
  // partials in split order into `out`, so the sum is the same whichever
  // finishes last
  const size_t plane = (size_t)n_out * cout;
  float* dst = splits == 1 ? out : partial + blockIdx.z * plane;
  for (int v = tid; v < BM * (BN / 4); v += THREADS) {
    const int r = v / (BN / 4);
    const int jj = (v % (BN / 4)) * 4;
    const int j = col0 + jj;
    if (row0 + r >= n_out || j >= cout) continue;
    const float* cv = c_s + r * T::C_LD + jj;
    float* o = dst + (size_t)(row0 + r) * cout + j;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(cv);
    } else {
      for (int e = 0; e < 4 && j + e < cout; ++e) o[e] = cv[e];
    }
  }
  if (splits == 1) return;
  __shared__ int last_s;
  __threadfence();  // this block's partial is visible before it counts
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(&counters[blockIdx.x * gridDim.y + blockIdx.y], 1) ==
             splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int v = tid; v < BM * BN; v += THREADS) {
    const int r = row0 + v / BN;
    const int j = col0 + v % BN;
    if (r >= n_out || j >= cout) continue;
    const size_t at = (size_t)r * cout + j;
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += __ldcg(partial + z * plane + at);
    out[at] = sum;
  }
}

// The tiling of a launch, from the shapes alone: wm (4: BM 128, 2: BM 64),
// nf (BN = 32 nf or 64 nf), bk (64 where Cin is a multiple of 64, else 32)
// and the grid.
struct Plan {
  int wm, nf, bk, row_blocks, col_blocks;
};

Plan plan_of(int n_out, int cin, int cout) {
  Plan p;
  const bool big = opcs::ceil_div(n_out, 128) >= BIG_ROW_TILES;
  p.wm = big ? 4 : 2;
  p.bk = cin % 64 == 0 ? 64 : 32;
  const int per_nf = big ? 32 : 64;  // columns per unit of nf
  constexpr int max_nf = 4;
  p.row_blocks = opcs::ceil_div(n_out, 32 * p.wm);
  // enough column blocks for BN <= per_nf * max_nf; more (down to 64
  // columns) while the row tiles alone stay under TARGET_BLOCKS
  int cols = opcs::ceil_div(TARGET_BLOCKS, p.row_blocks);
  cols = cols < opcs::ceil_div(cout, 64) ? cols : opcs::ceil_div(cout, 64);
  const int need = opcs::ceil_div(cout, per_nf * max_nf);
  cols = cols > need ? cols : need;
  p.nf = opcs::ceil_div(opcs::ceil_div(cout, cols), per_nf);
  p.col_blocks = opcs::ceil_div(cout, per_nf * p.nf);
  return p;
}

template <int WM, int NF, int BK>
int launch(const void* feats, const void* w, const void* kmap, void* out,
           void* partial, void* counters, int n_out, int num_k, int cin,
           int cout, int reverse, int splits, cudaStream_t stream,
           int* info) {
  using T = Tile<WM, NF, BK>;
  static bool cap_set = false;  // above 48 KB needs the opt-in, once
  if (!cap_set) {
    const int e = opcs::set_smem_cap(gather_gemm_kernel<WM, NF, BK>,
                                     T::smem(MAX_K));
    if (e != 0) return e;
    cap_set = true;
  }
  if (info) {  // the configuration query: no launch
    info[0] = T::BM;
    info[1] = T::BN;
    info[2] = (int)T::smem(num_k);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[3], gather_gemm_kernel<WM, NF, BK>, THREADS, T::smem(num_k));
  }
  const dim3 grid(opcs::ceil_div(n_out, T::BM), opcs::ceil_div(cout, T::BN),
                  splits);
  const int vec_a = cin % 8 == 0 && (uintptr_t)feats % 16 == 0;
  const int vec_b = cout % 8 == 0 && (uintptr_t)w % 16 == 0;
  gather_gemm_kernel<WM, NF, BK><<<grid, THREADS, T::smem(num_k), stream>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w,
      (const int*)kmap, (float*)out, (float*)partial, (int*)counters, n_out,
      num_k, cin, cout, reverse, splits, vec_a, vec_b);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                       void*, int, int, int, int, int, int, cudaStream_t,
                       int*);
// [wm == 4][nf - 1][bk == 64]
constexpr Launch BY_TILE[2][4][2] = {
    {{launch<2, 1, 32>, launch<2, 1, 64>}, {launch<2, 2, 32>, launch<2, 2, 64>},
     {launch<2, 3, 32>, launch<2, 3, 64>}, {launch<2, 4, 32>, launch<2, 4, 64>}},
    {{launch<4, 1, 32>, launch<4, 1, 64>}, {launch<4, 2, 32>, launch<4, 2, 64>},
     {launch<4, 3, 32>, launch<4, 3, 64>}, {launch<4, 4, 32>, launch<4, 4, 64>}}};

int dispatch(const void* feats, const void* w, const void* kmap, void* out,
             void* partial, void* counters, int n_out, int num_k, int cin,
             int cout, int reverse, int splits, cudaStream_t stream,
             int* info) {
  const Plan p = plan_of(n_out, cin, cout);
  const Launch fn = BY_TILE[p.wm == 4][p.nf - 1][p.bk == 64];
  return fn(feats, w, kmap, out, partial, counters, n_out, num_k, cin, cout,
            reverse, splits, stream, info);
}

}  // namespace

// feats [n_in, cin] bf16, w [num_k, cin, cout] bf16, kmap [num_k, n_out]
// int32 (-1 miss, else < n_in), out [n_out, cout] f32, every row written;
// reverse != 0 reads map row num_k - 1 - k for W[k]. splits > 1 divides
// each tile's live offsets among that many blocks: then partial is
// [splits, n_out, cout] f32 scratch and counters int32 scratch, zero, of at
// least ceil(n_out / 64) * ceil(cout / 32) entries (both may be NULL when
// splits == 1). All contiguous.
OPCS_API int opcs_gather_gemm_bf16(const void* feats, const void* w,
                                   const void* kmap, void* out, void* partial,
                                   void* counters, int n_out, int num_k,
                                   int cin, int cout, int reverse, int splits,
                                   void* stream) {
  if (num_k < 1 || num_k > MAX_K || splits < 1 ||
      (splits > 1 && (!partial || !counters)))
    return (int)cudaErrorInvalidValue;
  if (n_out <= 0 || cout <= 0) return (int)cudaGetLastError();
  return dispatch(feats, w, kmap, out, partial, counters, n_out, num_k, cin,
                  cout, reverse, splits, (cudaStream_t)stream, nullptr);
}

// The launch configuration opcs_gather_gemm_bf16 picks for these shapes:
// info = {BM, BN, dynamic shared memory bytes, blocks per SM, row blocks,
// column blocks, channels per step}.
OPCS_API int opcs_gather_gemm_config(int n_out, int num_k, int cin, int cout,
                                     int* info) {
  if (num_k < 1 || num_k > MAX_K || n_out <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n_out, cin, cout);
  info[4] = p.row_blocks;
  info[5] = p.col_blocks;
  info[6] = p.bk;
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n_out,
                  num_k, cin, cout, 0, 1, nullptr, info);
}
