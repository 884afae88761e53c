// Fused ConvDPUnit in the channels-major layout: x (H, Cin, W*N) with the
// batch N minor, out (H, Cout, W*N): 1x1 pointwise (+b1) -> 3x3 depthwise
// (+bd) -> optional ReLU, stride 1, SAME padding.
//
// Replaces the TPU kernel yunet_tpu/ops/convdp_cm_pallas.py:_fwd_kernel
// (line 57, through fused_conv_dp_cm_impl), which only
// tools/misc/bench_convdp_cm.py reaches.
//
// Numerics, as the TPU kernel's (convdp_cm_pallas.py:71-112): y1 = (w1 in
// x's dtype) . x + b1, summed in f32 and rounded to x's dtype, zero outside
// the image; then the 9-tap stencil in f32, + bd, optional ReLU, rounded
// once to x's dtype. (The NHWC kernel of convdp.cu keeps y1 in f32.)
//
// Design. The layout puts the batch in the fastest axis, so a warp of 32
// threads takes 32 neighbouring images of one (row, channel, column) and
// reads them coalesced. A block owns kCols output columns, kLanes images
// and up to kRowsPerBlock rows, and walks down its rows with a ring of
// three y1 rows in shared memory: for each output row it stages the next
// x row's (kCols + 2)-column halo, computes that y1 row into the ring, and
// runs the stencil from the ring's three rows. y1 never reaches device
// memory, and each y1 value is computed (kCols + 2) / kCols times, plus
// two rows a block.
//
// What bounds it on the H100. The bytes are x read and the output written
// once (419 MB each at the bench shape 64 -> 64, 160^2, N = 128, bf16). The
// pointwise product, Cin multiply-adds per y1 value, runs as scalar f32
// FMAs that read both operands from shared memory, so the kernel is bound
// by shared-memory loads; its 211 KB of shared memory at 64 -> 64 allow
// one block of 8 warps per SM, too few to hide their latency. The levers
// for a later change are register blocking over output channels, the ring
// stored in x's dtype (y1 is rounded to it anyway), and mma.sync/wgmma for
// the pointwise product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;           // output columns a block
constexpr int kWp = kCols + 2;     // with the left and right halo
constexpr int kLanes = 32;         // images a block (the minor axis)
constexpr int kRowsPerBlock = 32;  // output rows a block walks
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convdp_cm_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ wd,
                 const float* __restrict__ bd, T* __restrict__ out, int h,
                 int w, int n, int cin, int cout, int relu) {
  extern __shared__ float smem[];
  const int xrow = kWp * cin * kLanes, yrow = kWp * cout * kLanes;
  float* sx = smem;                  // one x row's halo [col][ci][lane]
  float* ring = sx + xrow;           // three y1 rows [slot][col][co][lane]
  float* sw1 = ring + 3 * yrow;      // cin * cout, in x's dtype
  float* sb1 = sw1 + cin * cout;     // cout
  float* swd = sb1 + cout;           // 9 * cout, tap-major
  float* sbd = swd + 9 * cout;       // cout

  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = blockIdx.x * kCols, n0 = blockIdx.y * kLanes;
  const int h0 = blockIdx.z * kRowsPerBlock;
  const int h1 = min(h0 + kRowsPerBlock, h);
  const size_t wn = static_cast<size_t>(w) * n;
  for (int e = tid; e < cin * cout; e += nt) sw1[e] = round_to<T>(w1[e]);
  for (int e = tid; e < 9 * cout; e += nt) swd[e] = wd[e];
  for (int e = tid; e < cout; e += nt) {
    sb1[e] = b1[e];
    sbd[e] = bd[e];
  }

  // y1 of row g (any g; zero off the image) into ring slot g mod 3
  auto y1_row = [&](int g) {
    __syncthreads();  // the last reads of sx and of this slot are done
    const bool row_ok = g >= 0 && g < h;
    for (int e = tid; e < xrow; e += nt) {
      const int lane = e % kLanes, rest = e / kLanes;
      const int ci = rest % cin, col = rest / cin;
      const int gc = c0 - 1 + col, nn = n0 + lane;
      float v = 0.f;
      if (row_ok && gc >= 0 && gc < w && nn < n)
        v = to_f32(x[(static_cast<size_t>(g) * cin + ci) * wn +
                     static_cast<size_t>(gc) * n + nn]);
      sx[e] = v;
    }
    __syncthreads();
    float* slot = ring + ((g + 3) % 3) * yrow;
    for (int e = tid; e < yrow; e += nt) {
      const int lane = e % kLanes, rest = e / kLanes;
      const int co = rest % cout, col = rest / cout;
      const int gc = c0 - 1 + col;
      float v = 0.f;
      if (row_ok && gc >= 0 && gc < w) {
        const float* xp = sx + col * cin * kLanes + lane;
        float acc = 0.f;
        for (int ci = 0; ci < cin; ++ci)
          acc += xp[ci * kLanes] * sw1[ci * cout + co];
        v = round_to<T>(acc + sb1[co]);
      }
      slot[e] = v;
    }
  };

  y1_row(h0 - 1);
  y1_row(h0);
  for (int r = h0; r < h1; ++r) {
    y1_row(r + 1);
    __syncthreads();
    for (int e = tid; e < kCols * cout * kLanes; e += nt) {
      const int lane = e % kLanes, rest = e / kLanes;
      const int co = rest % cout, col = rest / cout;
      const int gc = c0 + col, nn = n0 + lane;
      if (gc >= w || nn >= n) continue;
      float acc = 0.f;
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const float* slot = ring + ((r + 2 + ty) % 3) * yrow;
#pragma unroll
        for (int tx = 0; tx < 3; ++tx)
          acc += slot[((col + tx) * cout + co) * kLanes + lane] *
                 swd[(ty * 3 + tx) * cout + co];
      }
      acc += sbd[co];
      if (relu) acc = fmaxf(acc, 0.f);
      out[(static_cast<size_t>(r) * cout + co) * wn +
          static_cast<size_t>(gc) * n + nn] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* wd,
           const void* bd, void* out, int h, int w, int n, int cin, int cout,
           int relu, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convdp_cm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + kCols - 1) / kCols, (n + kLanes - 1) / kLanes,
                  (h + kRowsPerBlock - 1) / kRowsPerBlock);
  convdp_cm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), h, w, n, cin,
      cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (cin -> cout) unit.
size_t yunet_convdp_cm_smem_bytes(int cin, int cout) {
  return sizeof(float) *
         (static_cast<size_t>(kWp) * kLanes * (cin + 3 * static_cast<size_t>(cout)) +
          static_cast<size_t>(cin) * cout + 11 * static_cast<size_t>(cout));
}

// x: (h, cin, w*n) f32 or bf16 (bf16 != 0), n minor; w1: (cin, cout), b1:
// (cout), wd: (9, cout) tap-major (dy*3+dx), bd: (cout), all f32; out: (h,
// cout, w*n) in x's dtype. All device pointers; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch.
int yunet_convdp_cm_forward(const void* x, const void* w1, const void* b1,
                            const void* wd, const void* bd, void* out, int h,
                            int w, int n, int cin, int cout, int relu,
                            int bf16, void* stream) {
  const size_t smem = yunet_convdp_cm_smem_bytes(cin, cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, w1, b1, wd, bd, out, h, w, n, cin, cout,
                                 relu, smem, s);
  return launch<float>(x, w1, b1, wd, bd, out, h, w, n, cin, cout, relu,
                       smem, s);
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
