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
// What bounds it on the H100: bytes. At L0 96 x 96 (K = 27) of ray-cast
// scan 0 (131,072 points) the map (10.6 MB), the rows of A and B read once
// and dW are 35.5 MB, 10.6 us at 3.35 TB/s, against 4.6 GFLOP (4.7 us at
// 989 TFLOP/s); chip_smoke.py computes this bound for every case. Most
// (k, n) pairs miss (a voxel has a few neighbours of 27), so a kernel that
// steps over n in fixed batches gathers mostly empty rows, and one with
// small channel tiles gathers each row once per tile. What the design
// does:
//   - full steps: a block owns one TM x TN tile of one dW[k] and one chunk
//     of n. It first compacts its chunk's live pairs (both indices >= 0)
//     into shared memory, SEG rows at a time (a warp ballot and a prefix
//     over the warps keep the pairs in n order), so every MMA step carries
//     TK real pairs. No host plan and no host sync; the order of the f32
//     sums is fixed by the shapes;
//   - wide tiles: TM up to 128 (Ca) by TN up to 128 (Cb) in 8 warps, so at
//     Ca, Cb <= 128 each row of A and B is gathered once per pair;
//     channels past Ca / Cb are never loaded (they only reach dW entries
//     that are not written);
//   - the ring: the gathered rows arrive by 16-byte cp.async into STAGES
//     shared-memory stages over the compacted pairs (zero-filled past the
//     last pair), and the tensor cores (nvcuda::wmma bf16 16x16x16, A^T
//     read as a column-major fragment, f32 accumulators in registers) run
//     step s while the next steps' rows are in flight.
// The blocks' work is uneven: the submanifold map's centre offset pairs
// every valid row, the others far fewer, and chunks of
// padding rows none. The wrapper (ops/subm_conv.py dw_chunks) therefore
// cuts n into many chunks, about eight waves of blocks on the 132 SMs,
// while the partials stay within 64 MB (27 offsets) or 20 MB (8); their
// second pass is a fixed-order sum.
// Occupancy: opcs_gather_dw_config reports the tile, the dynamic shared
// memory and the blocks per SM, and chip_smoke.py logs them beside ptxas's
// registers and spills: 45-86 KB, 2-5 blocks per SM, at most 122
// registers, no spills.
// Left for later: fusing dW with the data-gradient pass over one gathered
// tile (the TPU kernels do), wgmma, and cutting the work by pairs rather
// than by rows (the centre offset's blocks are still the longest).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TK = 32;        // compacted pairs per pipeline step
constexpr int STAGES = 4;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps as 2 (Ca) x 4 (Cb)
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 2048;     // rows compacted at a time

// FM: 16-row fragments per warp (TM = 32 FM Ca channels); FN: 16-column
// fragments per warp (TN = 64 FN Cb channels).
template <int FM, int FN>
struct Tile {
  static constexpr int TM = 32 * FM;
  static constexpr int TN = 64 * FN;
  static constexpr int A_LD = TM + 8;  // padded leading dims (multiples of
  static constexpr int B_LD = TN + 8;  //  8 bf16: 32-byte aligned wmma)
  static constexpr int C_LD = TN + 4;
  static constexpr int A_STAGE = TK * A_LD;
  static constexpr int B_STAGE = TK * B_LD;
  static constexpr size_t RING = (size_t)STAGES * (A_STAGE + B_STAGE) * 2;
  static constexpr size_t EPI = (size_t)TM * C_LD * 4;
  // the ring (or the f32 epilogue tile that reuses it), then the pairs
  static constexpr size_t PAIRS_OFF = RING > EPI ? RING : EPI;
  static constexpr size_t SMEM = PAIRS_OFF + (size_t)2 * SEG * 4;
};

// Gather rows of x [*, c] (rows_s[p] for the TK pairs from p0; -1, or a pair
// past `count`, gives a zero row) at channels c0 .. c0 + W into dst [TK][LD].
template <int W, int LD>
__device__ __forceinline__ void gather_rows(
    const __nv_bfloat16* __restrict__ x, const int* rows_s, int p0,
    int count, int c, int c0, bool vec, __nv_bfloat16* dst, int tid) {
  for (int v = tid; v < TK * (W / 8); v += THREADS) {
    const int r = v / (W / 8);
    const int cv = (v % (W / 8)) * 8;
    const int ch = c0 + cv;
    if (ch >= c) continue;  // feeds only dW entries that are not written
    const int p = p0 + r;
    const int src = p < count ? rows_s[p] : -1;
    __nv_bfloat16* d = dst + r * LD + cv;
    if (vec) {
      opcs::cp_async16(d, src >= 0 ? x + (size_t)src * c + ch : x, src >= 0);
    } else {
      opcs::Bf16x8 val;
      val.u = make_uint4(0, 0, 0, 0);
      if (src >= 0)
        for (int e = 0; e < 8 && ch + e < c; ++e)
          val.h[e] = x[(size_t)src * c + ch + e];
      *reinterpret_cast<uint4*>(d) = val.u;
    }
  }
}

template <int FM, int FN>
__global__ void __launch_bounds__(THREADS)
gather_dw_kernel(const __nv_bfloat16* __restrict__ a,
                 const int* __restrict__ ia,
                 const __nv_bfloat16* __restrict__ b,
                 const int* __restrict__ ib, float* __restrict__ out, int n,
                 int num_k, int ca, int cb, int rows_per_chunk, int vec_a,
                 int vec_b) {
  using T = Tile<FM, FN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + STAGES * T::A_STAGE;
  float* c_s = reinterpret_cast<float*>(smem);
  int* pa_s = reinterpret_cast<int*>(smem + T::PAIRS_OFF);  // [SEG]
  int* pb_s = pa_s + SEG;                                   // [SEG]
  __shared__ int warp_cnt_s[WARPS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // Ca rows wm * 16 FM .. + 16 FM
  const int wn = warp % 4;  // Cb columns wn * 16 FN .. + 16 FN
  const int tiles_n = opcs::ceil_div(cb, T::TN);
  const int ca0 = (blockIdx.x / tiles_n) * T::TM;
  const int cb0 = (blockIdx.x % tiles_n) * T::TN;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int n0 = chunk * rows_per_chunk;
  const int n1 = min(n, n0 + rows_per_chunk);
  const int* iak = ia ? ia + (size_t)k * n : nullptr;
  const int* ibk = ib ? ib + (size_t)k * n : nullptr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int seg0 = n0; seg0 < n1; seg0 += SEG) {
    const int seg1 = min(n1, seg0 + SEG);
    // compact the segment's live pairs, in n order
    int count = 0;  // the same in every thread
    for (int r0 = seg0; r0 < seg1; r0 += THREADS) {
      const int r = r0 + tid;
      int ra = -1, rb = -1;
      if (r < seg1) {
        ra = iak ? iak[r] : r;
        rb = ibk ? ibk[r] : r;
      }
      const bool ok = ra >= 0 && rb >= 0;
      const unsigned live = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_cnt_s[warp] = __popc(live);
      __syncthreads();
      int pos = count + __popc(live & ((1u << lane) - 1u));
      int total = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) {
        const int cnt = warp_cnt_s[q];
        pos += q < warp ? cnt : 0;
        total += cnt;
      }
      if (ok) {
        pa_s[pos] = ra;
        pb_s[pos] = rb;
      }
      count += total;
      __syncthreads();  // publishes the pairs; warp_cnt_s is free again
    }
    const int steps = opcs::ceil_div(count, TK);

    auto load = [&](int s, int st) {
      gather_rows<T::TM, T::A_LD>(a, pa_s, s * TK, count, ca, ca0, vec_a,
                                  a_s + st * T::A_STAGE, tid);
      gather_rows<T::TN, T::B_LD>(b, pb_s, s * TK, count, cb, cb0, vec_b,
                                  b_s + st * T::B_STAGE, tid);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps) load(st, st);
      opcs::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      opcs::cp_async_wait<STAGES - 2>();  // step s has landed (this thread)
      __syncthreads();                    // ... everyone's; s-1 is free
      const int nxt = s + STAGES - 1;
      if (nxt < steps) load(nxt, nxt % STAGES);
      opcs::cp_async_commit();
      const __nv_bfloat16* as = a_s + (s % STAGES) * T::A_STAGE;
      const __nv_bfloat16* bs = b_s + (s % STAGES) * T::B_STAGE;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        // as is [pair][ca]: read as A^T [ca][pair] it is column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              fa[i], as + kk * T::A_LD + wm * 16 * FM + i * 16, T::A_LD);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(
              fb, bs + kk * T::B_LD + wn * 16 * FN + j * 16, T::B_LD);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    opcs::cp_async_wait<0>();
    __syncthreads();  // ring and pair list drained: free for what follows
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          c_s + (wm * 16 * FM + i * 16) * T::C_LD + wn * 16 * FN + j * 16,
          acc[i][j], T::C_LD, wmma::mem_row_major);
  __syncthreads();
  // this chunk's slice of the [n_chunks, K, Ca, Cb] partials (or of dW
  // itself when there is one chunk), masked to Ca x Cb
  float* dst = out + ((size_t)chunk * num_k + k) * ca * cb;
  const bool vec_out = (cb % 4) == 0;
  for (int v = tid; v < T::TM * (T::TN / 4); v += THREADS) {
    const int r = v / (T::TN / 4);
    const int jj = (v % (T::TN / 4)) * 4;
    const int j = cb0 + jj;
    if (ca0 + r >= ca || j >= cb) continue;
    const float* cv = c_s + r * T::C_LD + jj;
    float* o = dst + (size_t)(ca0 + r) * cb + j;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(cv);
    } else {
      for (int e = 0; e < 4 && j + e < cb; ++e) o[e] = cv[e];
    }
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

template <int FM, int FN>
int launch(const void* a, const void* ia, const void* b, const void* ib,
           void* dst, int n, int num_k, int ca, int cb, int rows_per_chunk,
           int n_chunks, cudaStream_t stream, int* info) {
  using T = Tile<FM, FN>;
  static bool cap_set = false;  // above 48 KB needs the opt-in, once
  if (!cap_set) {
    const int e = opcs::set_smem_cap(gather_dw_kernel<FM, FN>, T::SMEM);
    if (e != 0) return e;
    cap_set = true;
  }
  if (info) {  // the configuration query: no launch
    info[0] = T::TM;
    info[1] = T::TN;
    info[2] = (int)T::SMEM;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[3], gather_dw_kernel<FM, FN>, THREADS, T::SMEM);
  }
  const dim3 grid(opcs::ceil_div(ca, T::TM) * opcs::ceil_div(cb, T::TN),
                  num_k, n_chunks);
  const int vec_a = ca % 8 == 0 && (uintptr_t)a % 16 == 0;
  const int vec_b = cb % 8 == 0 && (uintptr_t)b % 16 == 0;
  gather_dw_kernel<FM, FN><<<grid, THREADS, T::SMEM, stream>>>(
      (const __nv_bfloat16*)a, (const int*)ia, (const __nv_bfloat16*)b,
      (const int*)ib, (float*)dst, n, num_k, ca, cb, rows_per_chunk, vec_a,
      vec_b);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       void*, int, int, int, int, int, int, cudaStream_t,
                       int*);
constexpr Launch BY_TILE[4][2] = {{launch<1, 1>, launch<1, 2>},
                                  {launch<2, 1>, launch<2, 2>},
                                  {launch<3, 1>, launch<3, 2>},
                                  {launch<4, 1>, launch<4, 2>}};

// TM = 32 FM covers Ca up to 128, TN = 64 FN covers Cb up to 128; wider
// widths take more tiles
Launch launch_of(int ca, int cb) {
  const int fm = opcs::ceil_div(ca, 32) < 4 ? opcs::ceil_div(ca, 32) : 4;
  const int fn = opcs::ceil_div(cb, 64) < 2 ? opcs::ceil_div(cb, 64) : 2;
  return BY_TILE[fm - 1][fn - 1];
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
  int err = launch_of(ca, cb)(a, ia, b, ib, dst, n, num_k, ca, cb,
                              rows_per_chunk, n_chunks, st, nullptr);
  if (err != 0 || n_chunks == 1) return err;
  const long total = (long)num_k * ca * cb;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  sum_chunks_kernel<<<blocks, 256, 0, st>>>((const float*)partial,
                                            (float*)out, total, n_chunks);
  return (int)cudaGetLastError();
}

// The tile opcs_gather_dw_bf16 picks for these widths: info = {TM, TN,
// dynamic shared memory bytes, blocks per SM}.
OPCS_API int opcs_gather_dw_config(int ca, int cb, int* info) {
  if (ca <= 0 || cb <= 0) return (int)cudaErrorInvalidValue;
  return launch_of(ca, cb)(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1,
                           ca, cb, 1, 1, nullptr, info);
}
