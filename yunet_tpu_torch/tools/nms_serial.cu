// The serial greedy NMS: one thread block per image, one IoU pass and one
// block barrier for every candidate. It was csrc/nms.cu's design before
// the bitmask kernel (an IoU mask in parallel, then a one-warp scan)
// replaced it. No path of the port runs it: chip_smoke.py builds it and
// times it beside csrc/nms.cu, through its own copy of the wrapper it
// had, as the yardstick of the redesign. Keep it as it is.
//
// Semantics as csrc/nms.cu: candidates sorted by score, descending, the
// first counts[b] of image b valid; box j > i is suppressed when box i is
// alive and IoU(i, j) > iou_thr; keep[b][j] = alive(j) && j < counts[b].
// The image's boxes, areas and flags sit in shared memory (24 B a box, so
// at most 9,685 candidates within a block's 227 KB). The IoU rounds as
// the plain version's (explicit _rn operations, built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes,
                  const int* __restrict__ counts, int k, float iou_thr,
                  uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                   // k
  float* sarea = reinterpret_cast<float*>(sbox + k);     // k
  int* ssupp = reinterpret_cast<int*>(sarea + k);        // k

  const int b = blockIdx.x;
  const float4* img = boxes + static_cast<size_t>(b) * k;
  const int n = min(max(counts[b], 0), k);

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 bx = img[j];
    sbox[j] = bx;
    sarea[j] = box_area(bx);
    ssupp[j] = 0;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // ssupp[i] was last written before the previous barrier, so every
    // thread reads the same value and takes the same branch.
    if (!ssupp[i]) {
      const float4 bi = sbox[i];
      const float ai = sarea[i];
      for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
        const float4 bj = sbox[j];
        const float iw = __fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x));
        const float ih = __fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y));
        const float inter = __fmul_rn(fmaxf(iw, 0.f), fmaxf(ih, 0.f));
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(sarea[j], ai), inter), 1e-9f);
        if (__fdiv_rn(inter, uni) > iou_thr) ssupp[j] = 1;
      }
    }
    __syncthreads();
  }

  uint8_t* out = keep + static_cast<size_t>(b) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    out[j] = (j < n && !ssupp[j]) ? 1 : 0;
}

}  // namespace

extern "C" {

// Shared memory one image of k candidates needs.
size_t yunet_nms_smem_bytes(int k) {
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) +
                                   sizeof(int));
}

// boxes: (batch, k, 4) f32, sorted by score per image; counts: (batch,)
// i32; keep: (batch, k) u8 output. All device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch.
int yunet_greedy_nms(const void* boxes, const void* counts, int batch, int k,
                     float iou_thr, void* keep, void* stream) {
  const size_t smem = yunet_nms_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_nms_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(counts), k,
      iou_thr, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
