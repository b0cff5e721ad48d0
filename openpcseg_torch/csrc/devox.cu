// Trilinear devoxelize: the port's K7 (forward) and K8 (its transpose).
//
//   K7: out[p, :] = sum_{c < 8} w[c, p] * vox[idx[c, p], :]   (idx -1: skip)
//   K8: dvox[v, :] = sum_{(c, p): idx[c, p] = v} w[c, p] * dout[p, :]
//
// Replaces (TPU kernel): openpcseg_tpu/ops/pallas_devox.py:_fwd_kernel
// (launched by _run_fwd, entry pallas_devoxelize). The TPU kernel folds the
// 8 corners into 4 z-adjacent columns and selects voxel rows inside VMEM
// windows with a one-hot matmul; here each point gathers its corner rows
// directly.
//
// What bounds it on the H100: device-memory bytes. Each point reads up to
// 8 voxel rows of C channels and writes one row; there are 2 flops per
// loaded element, so the kernel is a pure gather. The design keeps every
// load coalesced: one warp owns one point and its 32 lanes walk the
// channels (16-byte vectors of 8 bf16 where C % 8 == 0), the point's 8
// indices and f32 weights are read once by 8 lanes and broadcast with
// shuffles, and the sum stays in f32 registers until one cast to the
// feature type at the store (pallas_devox.py:434 casts the same way).
//
// K8 replaces openpcseg_tpu/ops/pallas_devox.py:_bwd_kernel (launched by
// _run_bwd from _devox_pallas_bwd), which walks point windows per voxel
// block with a window plan (build_rev_plan) and one-hot matmuls. Here the
// transpose is a gather too, over a table the geometry pass builds once
// per step (ops/voxelize.py devox_transpose_table): the (corner, point)
// contributors of every voxel, sorted by voxel with a stable sort, as a CSR
// (ptr [V + 1], point [8N], weight [8N]). One warp owns one voxel: it reads
// 32 contributors at a time with one coalesced load per lane, broadcasts
// each (point, weight) with a shuffle, and its lanes walk the channels of
// the point's dout row (16-byte vectors of 8 bf16 where C % 8 == 0),
// summing w * dout in f32 registers in table order; one cast to the
// feature type at the store. No atomics, so dvox is bit-identical from run
// to run, and every voxel row (empty ones too) is written exactly once.
// What bounds it on the H100: device-memory bytes. Each valid point's dout
// row is read once per corner that hits (up to 8 times); contributors of
// one voxel are neighbouring points in key order, so most of those re-reads
// come from L2. Per voxel the walk is serial: at level 4 a voxel has about
// 50 contributors, and the many voxels in flight (one warp each) hide the
// latency of that chain.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
devox_kernel(const T* __restrict__ vox, const int* __restrict__ idx,
             const float* __restrict__ w, T* __restrict__ out, int n,
             int c) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int p = blockIdx.x * WARPS + warp; p < n; p += gridDim.x * WARPS) {
    int my_i = -1;
    float my_w = 0.0f;
    if (lane < 8) {
      my_i = idx[(size_t)lane * n + p];
      my_w = w[(size_t)lane * n + p];
    }
    int ci[8];
    float cw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ci[k] = __shfl_sync(0xffffffffu, my_i, k);
      cw[k] = __shfl_sync(0xffffffffu, my_w, k);
    }
    for (int ch = lane * VEC; ch < c; ch += 32 * VEC) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (ci[k] < 0) continue;
        const T* row = vox + (size_t)ci[k] * c + ch;
        if constexpr (VEC == 8) {
          opcs::Bf16x8 v;
          v.u = *reinterpret_cast<const uint4*>(row);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] += cw[k] * opcs::to_f32(v.h[e]);
        } else if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(row);
          acc[0] += cw[k] * v.x;
          acc[1] += cw[k] * v.y;
          acc[2] += cw[k] * v.z;
          acc[3] += cw[k] * v.w;
        } else {
          acc[0] += cw[k] * opcs::to_f32(row[0]);
        }
      }
      T* dst = out + (size_t)p * c + ch;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = opcs::from_f32<T>(acc[e]);
    }
  }
}

template <typename T, int VEC>
int launch(const void* vox, const void* idx, const void* w, void* out, int n,
           int c, void* stream) {
  if (n > 0 && c > 0) {
    const int blocks = opcs::ceil_div(n, WARPS);
    devox_kernel<T, VEC><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)vox, (const int*)idx, (const float*)w, (T*)out, n, c);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
devox_bwd_kernel(const T* __restrict__ dout, const int* __restrict__ ptr,
                 const int* __restrict__ point, const float* __restrict__ w,
                 T* __restrict__ dvox, int n_vox, int c) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int v = blockIdx.x * WARPS + warp; v < n_vox; v += gridDim.x * WARPS) {
    const int beg = ptr[v];
    const int end = ptr[v + 1];
    for (int ch0 = 0; ch0 < c; ch0 += 32 * VEC) {
      const int ch = ch0 + lane * VEC;
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
#pragma unroll 4
        for (int q = 0; q < cnt; ++q) {
          const int p = __shfl_sync(0xffffffffu, my_p, q);
          const float wq = __shfl_sync(0xffffffffu, my_w, q);
          if (!live) continue;
          const T* row = dout + (size_t)p * c + ch;
          if constexpr (VEC == 8) {
            opcs::Bf16x8 x;
            x.u = *reinterpret_cast<const uint4*>(row);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] += wq * opcs::to_f32(x.h[e]);
          } else if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(row);
            acc[0] += wq * x.x;
            acc[1] += wq * x.y;
            acc[2] += wq * x.z;
            acc[3] += wq * x.w;
          } else {
            acc[0] += wq * opcs::to_f32(row[0]);
          }
        }
      }
      if (live) {
        T* dst = dvox + (size_t)v * c + ch;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = opcs::from_f32<T>(acc[e]);
      }
    }
  }
}

template <typename T, int VEC>
int launch_bwd(const void* dout, const void* ptr, const void* point,
               const void* w, void* dvox, int n_vox, int c, void* stream) {
  if (n_vox > 0 && c > 0) {
    const int blocks = opcs::ceil_div(n_vox, WARPS);
    devox_bwd_kernel<T, VEC><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)dout, (const int*)ptr, (const int*)point, (const float*)w,
        (T*)dvox, n_vox, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vox [n_vox, c], idx [8, n] int32 (-1 miss), w [8, n] f32, out [n, c];
// vox and out share the feature type. All contiguous.
OPCS_API int opcs_devox_bf16(const void* vox, const void* idx, const void* w,
                             void* out, int n, int c, void* stream) {
  if (c % 8 == 0)
    return launch<__nv_bfloat16, 8>(vox, idx, w, out, n, c, stream);
  return launch<__nv_bfloat16, 1>(vox, idx, w, out, n, c, stream);
}

OPCS_API int opcs_devox_f32(const void* vox, const void* idx, const void* w,
                            void* out, int n, int c, void* stream) {
  if (c % 4 == 0) return launch<float, 4>(vox, idx, w, out, n, c, stream);
  return launch<float, 1>(vox, idx, w, out, n, c, stream);
}

// dout [n, c], ptr [n_vox + 1] int32, point [m] int32, w [m] f32 (the CSR
// transpose table, ptr[n_vox] <= m), dvox [n_vox, c]; dout and dvox share
// the feature type. All contiguous.
OPCS_API int opcs_devox_bwd_bf16(const void* dout, const void* ptr,
                                 const void* point, const void* w, void* dvox,
                                 int n_vox, int c, void* stream) {
  if (c % 8 == 0)
    return launch_bwd<__nv_bfloat16, 8>(dout, ptr, point, w, dvox, n_vox, c,
                                        stream);
  return launch_bwd<__nv_bfloat16, 1>(dout, ptr, point, w, dvox, n_vox, c,
                                      stream);
}

OPCS_API int opcs_devox_bwd_f32(const void* dout, const void* ptr,
                                const void* point, const void* w, void* dvox,
                                int n_vox, int c, void* stream) {
  if (c % 4 == 0)
    return launch_bwd<float, 4>(dout, ptr, point, w, dvox, n_vox, c, stream);
  return launch_bwd<float, 1>(dout, ptr, point, w, dvox, n_vox, c, stream);
}
