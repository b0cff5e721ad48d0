// Trilinear devoxelize: the port's K7 (forward) and K8 (its transpose).
//
//   K7: out[p, :] = sum_{c < K} w[c, p] * vox[idx[c, p], :]   (idx -1: skip)
//   K8: dvox[v, :] = sum_{(c, p): idx[c, p] = v} w[c, p] * dout[p, :]
//
// K is 8 for the trilinear tables, 4 for RPVNet's bilinear range-to-point
// tables (ops/range_fusion.py bilinear_table: the 2 x 2 pixels around each
// point of a range feature map, float32) and 1 for the point-to-voxel and
// point-to-pixel tables (core/geometry.py p2v_table: K8 over one is a
// mean's sum, K7 its backward's gather).
//
// K7 replaces (TPU kernel): openpcseg_tpu/ops/pallas_devox.py:_fwd_kernel
// (launched by _run_fwd, entry pallas_devoxelize). The TPU kernel folds the
// 8 corners into 4 z-adjacent columns and selects voxel rows inside VMEM
// windows with a one-hot matmul; here each point gathers its corner rows
// directly.
//
// What bounds K7 on the H100: device-memory bytes. Each point reads up to
// K voxel rows of C channels (most from L2: neighbouring points share
// corners) and writes one row; 2 flops per loaded element. The design:
// - a warp owns a tile of 8 consecutive points and reads their corner
//   table [K, 8] (indices and f32 weights) with lanes over points: lane
//   h * 8 + j loads corners h and h + 4 of point j (those below K), 32-byte
//   sectors, every byte used; shuffles hand each point its K (index,
//   weight);
// - C / VEC lanes serve one point (16-byte vectors of 8 bf16 or 4 f32), so
//   a warp serves G = 32 / (C / VEC) points at once where C is narrow (two
//   at C = 128 in bf16) and no lane idles;
// - each lane walks the point's corners in order with one row load in
//   flight, at 40 registers, so that many warps per SM hide the latency
//   (issuing all 8 loads first, the 8 rows held in registers, ran slower
//   on the card); the sum stays in f32 registers until one cast to the
//   feature type and one 16-byte store per lane
//   (pallas_devox.py:434 casts the same way). Padding points (every corner
//   -1) store zero rows.
//
// K8 replaces openpcseg_tpu/ops/pallas_devox.py:_bwd_kernel (launched by
// _run_bwd from _devox_pallas_bwd), which walks point windows per voxel
// block with a window plan (build_rev_plan) and one-hot matmuls. Here the
// transpose is a gather too, over tables the geometry pass builds once per
// step (core/geometry.py devox_table): the CSR of idx by voxel (ops/
// voxelize.py devox_transpose_table: ptr [V + 1], point [KN], weight [KN],
// each voxel's (corner, point) contributors in (corner, point) order), and
// its cut into segments of at most `chunk` contributors (devox_segments:
// seg_ptr [V + 1], the first segment of each voxel, at least one each;
// seg_voxel [V + ceil(KN / chunk)], the voxel of each segment, -1 past the
// last).
//
// What bounds K8 on the H100: bytes, mostly from L2. Each valid point's
// dout row is read once per corner that hits (3.5 times on average at
// level 4); the contributors of one voxel are the points of its 8
// neighbouring cells, so the re-reads come from L2. A level-4 voxel has up
// to about 1,300 contributors, so a warp per voxel lasted as long as the
// longest list. The design bounds every serial chain:
// - a warp owns one segment, at most `chunk` contributors: it reads 32
//   (point, weight) pairs with one coalesced load a lane, hands each to
//   its lanes by shuffle, and sums w * dout in f32 in contributor order;
//   at narrow C the G lane groups take every G-th contributor and a fixed
//   butterfly of shuffles adds their sums;
// - a voxel of one segment (most, and every empty or padding voxel) is
//   written by that warp; a voxel of several writes one f32 partial row
//   per segment, and the warp that finishes last (an arrival counter per
//   voxel, the only atomic) adds the partials in segment order.
// Every dvox row is written exactly once, the sums are f32 with one cast
// at the store, and the result repeats bit for bit: which warp finishes
// last changes nothing in the order of the sum. Cut this way the level-4
// case runs at the rate L2 serves the re-read rows. Reading each row once
// instead (summing per level cell the 8 corner rows of its points, then
// per voxel the rows of its 8 cells) was tried: its 8 f32 accumulators a
// channel held the warps to a few per SM, and its f32 corner rows cost
// more than the re-reads at level 2.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 8;  // K7: points per warp tile
constexpr unsigned FULL = 0xffffffffu;

// VEC features at p as f32: 8 bf16 or 4 f32 in one 16-byte load, or one.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    opcs::Bf16x8 v;
    v.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = opcs::to_f32(v.h[e]);
  } else if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = opcs::to_f32(p[0]);
  }
}

// VEC f32 values stored at p in the feature type: one 16-byte store.
template <typename T, int VEC>
__device__ __forceinline__ void store_as(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    opcs::Bf16x8 v;
#pragma unroll
    for (int e = 0; e < 8; ++e) v.h[e] = opcs::from_f32<T>(x[e]);
    *reinterpret_cast<uint4*>(p) = v.u;
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = opcs::from_f32<T>(x[0]);
  }
}

// K8's f32 partial rows: VEC values stored, or added from L2 (__ldcg: the
// rows were written by other warps, never cached in this SM's L1).
template <int VEC>
__device__ __forceinline__ void store_partial(float* p, const float (&a)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]);
  } else {
    p[0] = a[0];
  }
}

template <int VEC>
__device__ __forceinline__ void add_partial(const float* p, float (&a)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + e));
      a[e] += v.x;
      a[e + 1] += v.y;
      a[e + 2] += v.z;
      a[e + 3] += v.w;
    }
  } else {
    a[0] += __ldcg(p);
  }
}

// K7. G points at a time per warp, L = 32 / G lanes each; K corners (1, 4
// or 8) a point.
template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(THREADS)
devox_kernel(const T* __restrict__ vox, const int* __restrict__ idx,
             const float* __restrict__ w, T* __restrict__ out, int n,
             int c) {
  constexpr int L = 32 / G;
  const int lane = threadIdx.x % 32;
  const int g = lane / L;
  const int sub = lane % L;
  const int tiles = opcs::ceil_div(n, TILE);
  for (int t = blockIdx.x * WARPS + threadIdx.x / 32; t < tiles;
       t += gridDim.x * WARPS) {
    const int p0 = t * TILE;
    // lane h * TILE + j holds corners h and h + 4 of point p0 + j (K 4:
    // corner h only; K 1: lanes 0-7 hold the one corner)
    const int pl = p0 + lane % TILE;
    const int h = lane / TILE;
    int i_lo = -1, i_hi = -1;
    float w_lo = 0.0f, w_hi = 0.0f;
    if (pl < n && h < K) {
      i_lo = __ldg(idx + (size_t)h * n + pl);
      w_lo = __ldg(w + (size_t)h * n + pl);
    }
    if (pl < n && h + 4 < K) {
      i_hi = __ldg(idx + (size_t)(h + 4) * n + pl);
      w_hi = __ldg(w + (size_t)(h + 4) * n + pl);
    }
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += G) {
      const int j = j0 + g;
      int ci[K];
      float cw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int src = (k % 4) * TILE + j;
        ci[k] = __shfl_sync(FULL, k < 4 ? i_lo : i_hi, src);
        cw[k] = __shfl_sync(FULL, k < 4 ? w_lo : w_hi, src);
      }
      const int p = p0 + j;
      if (p >= n) continue;
      for (int ch = sub * VEC; ch < c; ch += L * VEC) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (ci[k] < 0) continue;
          float x[VEC];
          load_f32<T, VEC>(vox + (size_t)ci[k] * c + ch, x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += cw[k] * x[e];
        }
        store_as<T, VEC>(out + (size_t)p * c + ch, acc);
      }
    }
  }
}

template <typename T, int VEC, int G, int K>
int launch(const void* vox, const void* idx, const void* w, void* out, int n,
           int c, void* stream) {
  if (n > 0 && c > 0) {
    const int blocks = opcs::ceil_div(opcs::ceil_div(n, TILE), WARPS);
    devox_kernel<T, VEC, G, K><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)vox, (const int*)idx, (const float*)w, (T*)out, n, c);
  }
  return (int)cudaGetLastError();
}

// K8. One segment per warp; G lane groups of L = 32 / G lanes each take
// every G-th contributor of the segment.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(THREADS)
devox_bwd_kernel(const T* __restrict__ dout, const int* __restrict__ ptr,
                 const int* __restrict__ point, const float* __restrict__ w,
                 const int* __restrict__ seg_ptr,
                 const int* __restrict__ seg_voxel, float* partial,
                 int* counters, T* __restrict__ dvox, int n_seg, int c,
                 int chunk) {
  constexpr int L = 32 / G;
  const int lane = threadIdx.x % 32;
  const int g = lane / L;
  const int sub = lane % L;
  for (int s = blockIdx.x * WARPS + threadIdx.x / 32; s < n_seg;
       s += gridDim.x * WARPS) {
    const int v = seg_voxel[s];
    if (v < 0) continue;
    const int s0 = seg_ptr[v];
    const int ns = seg_ptr[v + 1] - s0;
    const int beg = ptr[v] + (s - s0) * chunk;
    const int end = min(beg + chunk, ptr[v + 1]);
    for (int ch0 = 0; ch0 < c; ch0 += L * VEC) {
      const int ch = ch0 + sub * VEC;
      const bool live = ch < c;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      for (int b0 = beg; b0 < end; b0 += 32) {
        int my_p = 0;
        float my_w = 0.0f;
        if (b0 + lane < end) {
          my_p = point[b0 + lane];
          my_w = w[b0 + lane];
        }
        const int cnt = min(32, end - b0);  // warp-uniform
#pragma unroll 8
        for (int q0 = 0; q0 < cnt; q0 += G) {
          const int q = q0 + g;
          const int p = __shfl_sync(FULL, my_p, q);
          const float wq = __shfl_sync(FULL, my_w, q);
          if (!live || q >= cnt) continue;
          float x[VEC];
          load_f32<T, VEC>(dout + (size_t)p * c + ch, x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += wq * x[e];
        }
      }
      // the G groups' sums, by a fixed butterfly: every group ends with
      // the same bits (f32 addition commutes), group 0 stores them
#pragma unroll
      for (int off = 16; off >= L; off >>= 1)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] += __shfl_xor_sync(FULL, acc[e], off);
      if (g != 0 || !live) continue;
      if (ns == 1)
        store_as<T, VEC>(dvox + (size_t)v * c + ch, acc);
      else
        store_partial<VEC>(partial + (size_t)s * c + ch, acc);
    }
    if (ns == 1) continue;
    // several segments: the last to arrive adds the partials in order
    __threadfence();  // this warp's partial row is visible before it counts
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(&counters[v], 1) == ns - 1;
    if (!__shfl_sync(FULL, last, 0)) continue;
    __threadfence();
    for (int ch = lane * VEC; ch < c; ch += 32 * VEC) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll 4
      for (int z = s0; z < s0 + ns; ++z)
        add_partial<VEC>(partial + (size_t)z * c + ch, acc);
      store_as<T, VEC>(dvox + (size_t)v * c + ch, acc);
    }
  }
}

template <typename T, int VEC, int G>
int launch_bwd(const void* dout, const void* ptr, const void* point,
               const void* w, const void* seg_ptr, const void* seg_voxel,
               void* partial, void* counters, void* dvox, int n_seg, int c,
               int chunk, void* stream) {
  if (n_seg > 0 && c > 0) {
    const int blocks = opcs::ceil_div(n_seg, WARPS);
    devox_bwd_kernel<T, VEC, G><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)dout, (const int*)ptr, (const int*)point, (const float*)w,
        (const int*)seg_ptr, (const int*)seg_voxel, (float*)partial,
        (int*)counters, (T*)dvox, n_seg, c, chunk);
  }
  return (int)cudaGetLastError();
}

// Points (K7) or contributors (K8) a warp serves at once: as many as
// 32 lanes hold rows of ceil(c / VEC) lanes, up to 4.
int groups_of(int c, int vec) {
  const int lanes = opcs::ceil_div(c, vec);
  return lanes <= 8 ? 4 : lanes <= 16 ? 2 : 1;
}

template <typename T, int VEC, int K>
int dispatch_g(const void* vox, const void* idx, const void* w, void* out,
               int n, int c, void* stream) {
  switch (groups_of(c, VEC)) {
    case 4: return launch<T, VEC, 4, K>(vox, idx, w, out, n, c, stream);
    case 2: return launch<T, VEC, 2, K>(vox, idx, w, out, n, c, stream);
    default: return launch<T, VEC, 1, K>(vox, idx, w, out, n, c, stream);
  }
}

template <typename T, int VEC>
int dispatch(const void* vox, const void* idx, const void* w, void* out,
             int n, int c, int k, void* stream) {
  if (k == 8) return dispatch_g<T, VEC, 8>(vox, idx, w, out, n, c, stream);
  if (k == 4) return dispatch_g<T, VEC, 4>(vox, idx, w, out, n, c, stream);
  if (k == 1) return dispatch_g<T, VEC, 1>(vox, idx, w, out, n, c, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
int dispatch_bwd(const void* dout, const void* ptr, const void* point,
                 const void* w, const void* seg_ptr, const void* seg_voxel,
                 void* partial, void* counters, void* dvox, int n_seg, int c,
                 int chunk, void* stream) {
  switch (groups_of(c, VEC)) {
    case 4:
      return launch_bwd<T, VEC, 4>(dout, ptr, point, w, seg_ptr, seg_voxel,
                                   partial, counters, dvox, n_seg, c, chunk,
                                   stream);
    case 2:
      return launch_bwd<T, VEC, 2>(dout, ptr, point, w, seg_ptr, seg_voxel,
                                   partial, counters, dvox, n_seg, c, chunk,
                                   stream);
    default:
      return launch_bwd<T, VEC, 1>(dout, ptr, point, w, seg_ptr, seg_voxel,
                                   partial, counters, dvox, n_seg, c, chunk,
                                   stream);
  }
}

}  // namespace

// vox [n_vox, c], idx [k, n] int32 (-1 miss), w [k, n] f32, out [n, c],
// k 8, 4 or 1; vox and out share the feature type. All contiguous.
OPCS_API int opcs_devox_bf16(const void* vox, const void* idx, const void* w,
                             void* out, int n, int c, int k, void* stream) {
  if (c % 8 == 0)
    return dispatch<__nv_bfloat16, 8>(vox, idx, w, out, n, c, k, stream);
  return dispatch<__nv_bfloat16, 1>(vox, idx, w, out, n, c, k, stream);
}

OPCS_API int opcs_devox_f32(const void* vox, const void* idx, const void* w,
                            void* out, int n, int c, int k, void* stream) {
  if (c % 4 == 0)
    return dispatch<float, 4>(vox, idx, w, out, n, c, k, stream);
  return dispatch<float, 1>(vox, idx, w, out, n, c, k, stream);
}

// dout [n, c]; the CSR transpose ptr [n_vox + 1], point [m], w [m] int32 /
// int32 / f32; its segments seg_ptr [n_vox + 1] and seg_voxel [n_seg]
// int32, each segment at most `chunk` contributors; partial [n_seg, c] f32
// scratch; counters [n_vox] int32, zero; dvox [n_vox, c]. dout and dvox
// share the feature type. All contiguous.
OPCS_API int opcs_devox_bwd_bf16(const void* dout, const void* ptr,
                                 const void* point, const void* w,
                                 const void* seg_ptr, const void* seg_voxel,
                                 void* partial, void* counters, void* dvox,
                                 int n_seg, int c, int chunk, void* stream) {
  if (c % 8 == 0)
    return dispatch_bwd<__nv_bfloat16, 8>(dout, ptr, point, w, seg_ptr,
                                          seg_voxel, partial, counters, dvox,
                                          n_seg, c, chunk, stream);
  return dispatch_bwd<__nv_bfloat16, 1>(dout, ptr, point, w, seg_ptr,
                                        seg_voxel, partial, counters, dvox,
                                        n_seg, c, chunk, stream);
}

OPCS_API int opcs_devox_bwd_f32(const void* dout, const void* ptr,
                                const void* point, const void* w,
                                const void* seg_ptr, const void* seg_voxel,
                                void* partial, void* counters, void* dvox,
                                int n_seg, int c, int chunk, void* stream) {
  if (c % 4 == 0)
    return dispatch_bwd<float, 4>(dout, ptr, point, w, seg_ptr, seg_voxel,
                                  partial, counters, dvox, n_seg, c, chunk,
                                  stream);
  return dispatch_bwd<float, 1>(dout, ptr, point, w, seg_ptr, seg_voxel,
                                partial, counters, dvox, n_seg, c, chunk,
                                stream);
}
