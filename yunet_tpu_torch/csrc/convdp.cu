// Fused inference ConvDPUnit: 1x1 pointwise (+b1) -> 3x3 depthwise (+bd)
// -> optional ReLU, NHWC, stride 1, SAME padding, BN already folded into
// the depthwise weights.
//
// Replaces the TPU kernel yunet_tpu/ops/convdp_pallas.py:_kernel (line 29,
// through fused_conv_dp).
//
// The design keeps the pointwise result y1 on chip: each block takes one
// image's tile of kRows x kCols output pixels, stages the (kRows+2) x
// (kCols+2) x Cin halo input and the weights in shared memory, computes y1
// for the whole halo tile into shared memory, then runs the 9-tap stencil
// from there. Device memory sees x (read once, plus the halo) and the
// output (written once); unfused, y1 (N*H*W*Cout) would make a round trip
// through device memory between the two convs.
//
// What bounds it on the H100. The arithmetic (at most 64 + 9 MACs per
// output value in YuNet) is far below the card's FLOP-per-byte balance
// point, so a full card would be bound by bytes. At YuNet's batch-1
// shapes it is not full: the grid is (ceil(W/16), ceil(H/8), N), so a
// 20x20 level launches 6 blocks and a 40x40 level 15, on 132 SMs, and
// each thread runs the pointwise step as a serial chain of Cin
// multiply-adds that reads both operands from shared memory. The kernel
// is bound by latency and by how few blocks it runs: measured on an H100,
// about 30-46 us a launch, nearly the same at 320x320 as at 640x640.
// The levers for a later change are more blocks per launch at batch 1
// (smaller tiles, Cout split across blocks) and register-blocked (or
// wgmma) pointwise MACs.
//
// y1 positions outside the image are zeroed: the depthwise conv pads its
// input (y1) with zeros, and pw(0) + b1 = b1 != 0 (convdp_pallas.py:38-45).
// y1 and the accumulator stay f32 for both f32 and bf16 inputs; the output
// is rounded once to the input's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 16;
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
__global__ void __launch_bounds__(kThreads)
convdp_kernel(const T* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ wd,
              const float* __restrict__ bd, T* __restrict__ out, int h, int w,
              int cin, int cout, int relu) {
  constexpr int hp = kRows + 2, wp = kCols + 2, npos = hp * wp;
  extern __shared__ float smem[];
  float* sx = smem;                   // npos * cin   halo input
  float* sy = sx + npos * cin;        // npos * cout  pointwise result y1
  float* sw1 = sy + npos * cout;      // cin * cout
  float* sb1 = sw1 + cin * cout;      // cout
  float* swd = sb1 + cout;            // 9 * cout
  float* sbd = swd + 9 * cout;        // cout

  const int img = blockIdx.z;
  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < cin * cout; e += nt) sw1[e] = w1[e];
  for (int e = tid; e < 9 * cout; e += nt) swd[e] = wd[e];
  for (int e = tid; e < cout; e += nt) {
    sb1[e] = b1[e];
    sbd[e] = bd[e];
  }
  // halo input, zero outside the image; channel-fastest so neighbouring
  // threads read neighbouring addresses of the NHWC row
  const T* xi = x + static_cast<size_t>(img) * h * w * cin;
  for (int e = tid; e < npos * cin; e += nt) {
    const int pos = e / cin, c = e - pos * cin;
    const int gr = r0 - 1 + pos / wp, gc = c0 - 1 + pos % wp;
    float v = 0.f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      v = to_f32(xi[(static_cast<size_t>(gr) * w + gc) * cin + c]);
    sx[e] = v;
  }
  __syncthreads();

  // pointwise conv over the halo tile; zero in the padding ring
  for (int e = tid; e < npos * cout; e += nt) {
    const int pos = e / cout, co = e - pos * cout;
    const int gr = r0 - 1 + pos / wp, gc = c0 - 1 + pos % wp;
    float acc = 0.f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
      const float* xp = sx + pos * cin;
      for (int ci = 0; ci < cin; ++ci) acc += xp[ci] * sw1[ci * cout + co];
      acc += sb1[co];
    }
    sy[e] = acc;
  }
  __syncthreads();

  // 3x3 depthwise stencil from shared memory
  T* oi = out + static_cast<size_t>(img) * h * w * cout;
  for (int e = tid; e < kRows * kCols * cout; e += nt) {
    const int p = e / cout, co = e - p * cout;
    const int r = p / kCols, c = p - r * kCols;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= h || gc >= w) continue;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc += sy[((r + dy) * wp + c + dx) * cout + co] *
               swd[(dy * 3 + dx) * cout + co];
    acc += sbd[co];
    if (relu) acc = fmaxf(acc, 0.f);
    oi[(static_cast<size_t>(gr) * w + gc) * cout + co] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* wd,
           const void* bd, void* out, int n, int h, int w, int cin, int cout,
           int relu, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convdp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, n);
  convdp_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), h, w, cin, cout,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (cin -> cout) unit.
size_t yunet_convdp_smem_bytes(int cin, int cout) {
  const int npos = (kRows + 2) * (kCols + 2);
  return sizeof(float) * (static_cast<size_t>(npos) * (cin + cout) +
                          static_cast<size_t>(cin) * cout + 11 * cout);
}

// x: (n, h, w, cin) f32 or bf16 (bf16 != 0); w1: (cin, cout), b1: (cout),
// wd: (9, cout) tap-major (dy*3+dx), bd: (cout), all f32; out: (n, h, w,
// cout) in x's dtype. All device pointers; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch.
int yunet_convdp_forward(const void* x, const void* w1, const void* b1,
                         const void* wd, const void* bd, void* out, int n,
                         int h, int w, int cin, int cout, int relu, int bf16,
                         void* stream) {
  const size_t smem = yunet_convdp_smem_bytes(cin, cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, w1, b1, wd, bd, out, n, h, w, cin, cout,
                                 relu, smem, s);
  return launch<float>(x, w1, b1, wd, bd, out, n, h, w, cin, cout, relu,
                       smem, s);
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
