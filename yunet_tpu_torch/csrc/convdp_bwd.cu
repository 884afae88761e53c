// Backward of the trainable fused ConvDPUnit z = dw3x3(pw1x1(x) + b1) + bd
// (NHWC, stride 1, SAME padding, no ReLU):
//
//   dy1 = corr(dz, rot180 wd)      dx  = dy1 . w1^T
//   dw1 = x^T . dy1                db1 = sum dy1
//   dwd[t] = sum y1_shift_t * dz   dbd = sum dz
//
// Replaces the TPU kernel yunet_tpu/ops/convdp_pallas_impl.py:bwd_kernel
// (line 61, through convdp_train_pallas.py:_bwd). Its forward is the
// inference kernel of convdp.cu with relu off.
//
// Numerics, as the TPU kernel's: y1 is recomputed from x, not stored, with
// w1 cast to x's dtype and y1 rounded to x's dtype (bf16 in the shipped
// config; _masked_y1, convdp_pallas_impl.py:24-41), and zero outside the
// image. dx = dy1 . w1^T takes the f32 w1 and the f32 dy1 and is rounded
// once to x's dtype. The four parameter gradients are f32 sums over all
// N*H*W positions.
//
// Design. Each block walks a fixed set of image tiles of kRows x kCols
// positions (tile = blockIdx.x, blockIdx.x + gridDim.x, ...). For a tile it
// stages the (kRows+2) x (kCols+2) halo of x and dz in shared memory,
// recomputes y1 on the halo, sums the tile's dwd and dbd, forms dy1 for
// the tile (in y1's place), writes dx, and sums the tile's dw1 and db1.
// Each thread owns fixed gradient elements and adds the tile's sum to its
// running block sum in shared memory. At the end every block writes its
// sums to a row of `partial`, and a second launch adds the rows in block
// order. Nothing uses atomics: the grid is fixed by the shapes, so the
// gradients are the same from run to run.
//
// What bounds it on the H100. The bytes are x and dz read and dx written
// once (plus the halos); the arithmetic is three Cin x Cout products per
// position (the y1 recompute, dx and dw1), which on the tensor cores would
// sit under the bytes. Here they run as scalar f32 multiply-adds that read
// both operands from shared memory, so the kernel is bound by
// shared-memory loads, and at 64 -> 64 its 188 KB of shared memory allow
// one block per SM. The levers for a later change are register-blocked or
// mma.sync/wgmma products and a smaller footprint for more blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 16;
constexpr int kHp = kRows + 2, kWp = kCols + 2;
constexpr int kNpos = kHp * kWp;    // halo positions of a tile
constexpr int kTile = kRows * kCols;
constexpr int kThreads = 512;
// blocks of the tile launch: 4 per SM of an H100, fixed so that the order
// of the sums depends on the shapes alone
constexpr int kMaxBlocks = 4 * 132;

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
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// layout of a block's sums and of a row of `partial`:
// dw1 (cin x cout) | db1 (cout) | dwd (9 x cout) | dbd (cout)
__host__ __device__ inline int acc_len(int cin, int cout) {
  return cin * cout + 11 * cout;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convdp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ wd, T* __restrict__ dx,
                  float* __restrict__ partial, int n, int h, int w, int cin,
                  int cout) {
  extern __shared__ float smem[];
  float* sx = smem;                   // kNpos * cin    x halo
  float* sdz = sx + kNpos * cin;      // kNpos * cout   dz halo
  float* sy = sdz + kNpos * cout;     // kNpos * cout   y1 halo, then dy1
  float* sdy = sy;                    // kTile * cout   (y1's place)
  float* sw1 = sy + kNpos * cout;     // cin * cout     w1 in x's dtype
  float* sw1t = sw1 + cin * cout;     // cout * cin     w1^T, f32
  float* sb1 = sw1t + cin * cout;     // cout
  float* swd = sb1 + cout;            // 9 * cout
  float* sacc = swd + 9 * cout;       // acc_len       the block's sums

  const int tid = threadIdx.x, nt = blockDim.x;
  const int nacc = acc_len(cin, cout);
  for (int e = tid; e < cin * cout; e += nt) {
    const float v = w1[e];
    const int ci = e / cout, co = e - ci * cout;
    sw1[e] = round_to<T>(v);
    sw1t[co * cin + ci] = v;
  }
  for (int e = tid; e < 9 * cout; e += nt) swd[e] = wd[e];
  for (int e = tid; e < cout; e += nt) sb1[e] = b1[e];
  for (int e = tid; e < nacc; e += nt) sacc[e] = 0.f;

  const int tiles_w = (w + kCols - 1) / kCols;
  const int tiles_img = tiles_w * ((h + kRows - 1) / kRows);
  const int tiles = n * tiles_img;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int img = tile / tiles_img, rem = tile - img * tiles_img;
    const int r0 = (rem / tiles_w) * kRows, c0 = (rem % tiles_w) * kCols;
    const size_t base = static_cast<size_t>(img) * h * w;
    __syncthreads();  // the last tile's reads of sx and sdy are done

    // the halos of x and dz, zero outside the image
    for (int e = tid; e < kNpos * cin; e += nt) {
      const int pos = e / cin, c = e - pos * cin;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      float v = 0.f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w)
        v = to_f32(x[(base + static_cast<size_t>(gr) * w + gc) * cin + c]);
      sx[e] = v;
    }
    for (int e = tid; e < kNpos * cout; e += nt) {
      const int pos = e / cout, c = e - pos * cout;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      float v = 0.f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w)
        v = to_f32(dz[(base + static_cast<size_t>(gr) * w + gc) * cout + c]);
      sdz[e] = v;
    }
    __syncthreads();

    // y1 on the halo, rounded to x's dtype; zero outside the image
    for (int e = tid; e < kNpos * cout; e += nt) {
      const int pos = e / cout, co = e - pos * cout;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      float v = 0.f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
        const float* xp = sx + pos * cin;
        float acc = 0.f;
        for (int ci = 0; ci < cin; ++ci) acc += xp[ci] * sw1[ci * cout + co];
        v = round_to<T>(acc + sb1[co]);
      }
      sy[e] = v;
    }
    __syncthreads();

    // dwd (taps t < 9) and dbd (t == 9) over the tile's positions; dz is
    // zero on tile positions past the image's edge
    for (int e = tid; e < 10 * cout; e += nt) {
      const int t = e / cout, co = e - t * cout;
      const int ty = t / 3, tx = t - ty * 3;
      float acc = 0.f;
      for (int r = 0; r < kRows; ++r)
        for (int c = 0; c < kCols; ++c) {
          const float g = sdz[((r + 1) * kWp + c + 1) * cout + co];
          acc += t < 9 ? sy[((r + ty) * kWp + c + tx) * cout + co] * g : g;
        }
      sacc[cin * cout + cout + e] += acc;
    }
    __syncthreads();  // y1 is dead: dy1 takes its place

    // dy1[a, b] = sum_t wd[t] * dz[a + 1 - ty, b + 1 - tx]; zero on tile
    // positions past the image's edge
    for (int e = tid; e < kTile * cout; e += nt) {
      const int p = e / cout, co = e - p * cout;
      const int r = p / kCols, c = p - r * kCols;
      float acc = 0.f;
      if (r0 + r < h && c0 + c < w) {
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
            acc += sdz[((r + 2 - ty) * kWp + c + 2 - tx) * cout + co] *
                   swd[(ty * 3 + tx) * cout + co];
      }
      sdy[e] = acc;
    }
    __syncthreads();

    // dx = dy1 . w1^T with the f32 w1, rounded once to x's dtype
    for (int e = tid; e < kTile * cin; e += nt) {
      const int p = e / cin, ci = e - p * cin;
      const int r = p / kCols, c = p - r * kCols;
      const int gr = r0 + r, gc = c0 + c;
      if (gr >= h || gc >= w) continue;
      const float* dyp = sdy + p * cout;
      float acc = 0.f;
      for (int co = 0; co < cout; ++co) acc += dyp[co] * sw1t[co * cin + ci];
      dx[(base + static_cast<size_t>(gr) * w + gc) * cin + ci] =
          from_f32<T>(acc);
    }
    // dw1 (ci < cin) and db1 (ci == cin) over the tile's positions
    for (int e = tid; e < (cin + 1) * cout; e += nt) {
      const int ci = e / cout, co = e - ci * cout;
      float acc = 0.f;
      for (int p = 0; p < kTile; ++p) {
        const float g = sdy[p * cout + co];
        acc += ci < cin
                   ? sx[((p / kCols + 1) * kWp + p % kCols + 1) * cin + ci] * g
                   : g;
      }
      sacc[e] += acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < nacc; e += nt)
    partial[static_cast<size_t>(blockIdx.x) * nacc + e] = sacc[e];
}

// out[e] = sum over the rows of partial, in row order
__global__ void reduce_rows(const float* __restrict__ partial,
                           float* __restrict__ out, int rows, int len) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float acc = 0.f;
  for (int b = 0; b < rows; ++b) acc += partial[static_cast<size_t>(b) * len + e];
  out[e] = acc;
}

template <typename T>
int launch(const void* x, const void* dz, const void* w1, const void* b1,
           const void* wd, void* dx, float* partial, float* grads, int n,
           int h, int w, int cin, int cout, int blocks, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convdp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  convdp_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(wd), static_cast<T*>(dx), partial, n, h, w,
      cin, cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int len = acc_len(cin, cout);
  reduce_rows<<<(len + 255) / 256, 256, 0, stream>>>(partial, grads, blocks,
                                                      len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of the tile launch needs for a (cin -> cout)
// unit.
size_t yunet_convdp_bwd_smem_bytes(int cin, int cout) {
  return sizeof(float) *
         (static_cast<size_t>(kNpos) * (cin + 2 * cout) +
          2 * static_cast<size_t>(cin) * cout + 10 * static_cast<size_t>(cout) +
          static_cast<size_t>(acc_len(cin, cout)));
}

// Blocks of the tile launch, i.e. rows of `partial`, for an (n, h, w) input.
int yunet_convdp_bwd_blocks(int n, int h, int w) {
  const long long tiles = static_cast<long long>(n) *
                          ((h + kRows - 1) / kRows) *
                          ((w + kCols - 1) / kCols);
  return static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

// Length of a row of `partial` and of `grads`.
int yunet_convdp_bwd_acc_len(int cin, int cout) { return acc_len(cin, cout); }

// x: (n, h, w, cin) and dz: (n, h, w, cout), f32 or bf16 (bf16 != 0); w1:
// (cin, cout), b1: (cout), wd: (9, cout) tap-major (dy*3+dx), all f32; dx:
// (n, h, w, cin) in x's dtype; partial: yunet_convdp_bwd_blocks(n, h, w) x
// acc_len f32 scratch; grads: acc_len f32, written as dw1 | db1 | dwd | dbd.
// All device pointers; stream is a cudaStream_t. Returns the first nonzero
// cudaGetLastError() of the two launches, or 0.
int yunet_convdp_backward(const void* x, const void* dz, const void* w1,
                          const void* b1, const void* wd, void* dx,
                          void* partial, void* grads, int n, int h, int w,
                          int cin, int cout, int bf16, void* stream) {
  const size_t smem = yunet_convdp_bwd_smem_bytes(cin, cout);
  const int blocks = yunet_convdp_bwd_blocks(n, h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* g = static_cast<float*>(grads);
  if (bf16)
    return launch<__nv_bfloat16>(x, dz, w1, b1, wd, dx, p, g, n, h, w, cin,
                                 cout, blocks, smem, s);
  return launch<float>(x, dz, w1, b1, wd, dx, p, g, n, h, w, cin, cout,
                       blocks, smem, s);
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
