// Fused inference ConvDPUnit: 1x1 pointwise (+b1) -> 3x3 depthwise (+bd)
// -> optional ReLU, NHWC, stride 1, SAME padding, BN already folded into
// the depthwise weights.
//
// Replaces the TPU kernel yunet_tpu/ops/convdp_pallas.py:_kernel (line 29,
// through fused_conv_dp).
//
// Both routes keep the pointwise result y1 on chip: a block takes one
// image's tile of kRows x kCols output pixels, stages the (kRows+2) x
// (kCols+2) halo of x in shared memory, computes y1 for the whole halo
// tile into shared memory, then runs the 9-tap stencil from there. Device
// memory sees x (read once, plus the halo) and the output (written once);
// unfused, y1 (N*H*W*Cout) would make a round trip between the two convs.
//
// Numerics, as the TPU kernel's: w1, b1, wd and bd are f32; y1 and the
// accumulator stay f32 for both f32 and bf16 inputs; y1 positions outside
// the image are zeroed (the depthwise conv pads y1 with zeros, and pw(0) +
// b1 = b1 != 0; convdp_pallas.py:38-45); the output is rounded once to the
// input's dtype.
//
// What bounds it on the H100: bytes. At 64 -> 64 a position reads 128 and
// writes 128 bytes of bf16 and needs 2 * 64 * (3 * 64 + 10) operations with
// the three pointwise passes of the bf16 route below, about 100 a byte,
// under the bf16 tensor cores' ~295.
//
// bf16 route (convdp_mma_kernel, at most 64 channels each side: every
// YuNet unit). The pointwise product runs on the tensor cores as mma.sync
// m16n8k16 (bf16 in, f32 accumulate), x staged in bf16 by 16-byte cp.async
// copies where Cin allows, rows padded by 8 elements so that ldmatrix
// meets no bank conflicts. x is exact in bf16, but w1 is f32: one bf16
// pass would round w1 to 8 bits, which is not this function. So each
// block splits w1 into three bf16 parts, hi = bf16(w1), mid = bf16(w1 -
// hi) and lo = bf16(w1 - hi - mid), whose sum is w1 exactly, held as B
// fragments in registers. Every product x * part is exact in f32, so y1
// differs from an f32 sum only in the order of the sums: the hi products
// go a k-step at a time into a fresh accumulator that is added in f32,
// mid and lo (2^-8 and 2^-16 of w1) chain in a second accumulator.
// Emulated on the CPU against the plain version at the 29 units of a
// 320^2 and of a 640^2 forward (tests/test_torch_convdp.py), the excess
// over one bf16 ulp of the output is at most 0.29 units of 2^-24 * S (S,
// per output channel, is sum_t |wd[t]| * (max|x| * sum_ci |w1[ci]| +
// |b1|)), as small as with f64-exact products; hi + lo alone gives 9.99
// and 13.3. The check on the card allows 2. The epilogue adds b1, zeroes
// the ring and keeps y1 in f32 in shared memory; the 9-tap pass (+ bd,
// ReLU) runs on the CUDA cores, each thread owning a pair of channels and
// sliding its 3x3 window along a run of one row in registers, and stores
// bf16x2.
// Cin and Cout are padded with zeros to 16, 32 or 64 (one instantiation
// each); a block computes NB of the padded Cout channels: all of them,
// or, when a launch has fewer tiles than kFillBlocks, a 16-channel slice,
// so that a small image (YuNet's 20x20 to 80x80 levels at batch 1) still
// gives the card a few hundred blocks. At 64 -> 64 a block takes 78 KB of
// shared memory, so two share an SM.
//
// As built it is not at the byte bound: on an H100 (700 W; PERF.md) 64 ->
// 64 at 160^2 b16 takes about 0.15 ms against 0.031 ms of bytes (the
// library's 1x1 + depthwise pair: 0.31 ms). A block loads its halo, then
// computes, then stores, and the two blocks of an SM overlap only each
// other. At batch 1 a launch takes a few microseconds of the card and is
// set by launch latency and the wrapper's host time.
//
// f32 route (convdp_kernel, also bf16 above 64 channels, which no preset
// reaches): scalar f32 multiply-adds from shared memory, the pointwise
// step a serial chain of Cin multiply-adds per (position, channel); 109
// KB a block at 64 -> 64. Grid (ceil(W/16), ceil(H/8), N).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// -- bf16 route: tensor-core pointwise ---------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWp = kCols + 2;
constexpr int kNpos = (kRows + 2) * kWp;  // halo positions of a tile
constexpr int kTile = kRows * kCols;
constexpr int kHaloRows = 192;            // kNpos rounded up to 16 MMA rows
constexpr int kMaxMmaChannels = 64;
// a launch with fewer tiles than this (two blocks on each of an H100's
// 132 SMs) gives each block a 16-channel slice of Cout
constexpr int kFillBlocks = 2 * 132;

// channels padded to an MMA tile: 16, 32 or 64
inline int pad_channels(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : 64; }

// shared memory of one block: the x halo (kHaloRows x CINP+8, bf16) and
// y1 (kNpos x NB+8, f32; the 8 floats of padding put the rows g and g+1
// of an accumulator fragment in different banks)
constexpr size_t mma_smem_bytes(int cinp, int nb) {
  return sizeof(bf16) * kHaloRows * (cinp + 8) +
         sizeof(float) * kNpos * (nb + 8);
}

// v = hi + mid + lo exactly, each part bf16: v has 24 significant bits,
// each residual is exact in f32 and holds 8 fewer
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a . b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the halo of the tile at (r0, c0) of x (channels c, padded to CP with
// zeros) into s (row stride STRIDE); zero outside the image
template <int CP, int STRIDE>
__device__ __forceinline__ void load_halo(bf16* s, const bf16* __restrict__ g,
                                          bool vec, size_t base, int r0,
                                          int c0, int h, int w, int c) {
  if (vec) {  // c % 8 == 0 and g 16-byte aligned
    constexpr int kChunks = CP / 8;
    for (int e = threadIdx.x; e < kNpos * kChunks; e += kThreads) {
      const int pos = e / kChunks, ch = (e - pos * kChunks) * 8;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      const bool ok = gr >= 0 && gr < h && gc >= 0 && gc < w && ch < c;
      cp_async16(s + pos * STRIDE + ch,
                 ok ? g + (base + static_cast<size_t>(gr) * w + gc) * c + ch
                    : g,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < kNpos * CP; e += kThreads) {
      const int pos = e / CP, ch = e - pos * CP;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      bf16 v = __float2bfloat16_rn(0.f);
      if (gr >= 0 && gr < h && gc >= 0 && gc < w && ch < c)
        v = g[(base + static_cast<size_t>(gr) * w + gc) * c + ch];
      s[pos * STRIDE + ch] = v;
    }
  }
}

// One block: tile blockIdx.x / slices, output channels [cb, cb + NB) with
// cb = NB * (blockIdx.x % slices).
template <int CINP, int NB>
__global__ void __launch_bounds__(kThreads, 2)
convdp_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ wd,
                  const float* __restrict__ bd, bf16* __restrict__ out,
                  int h, int w, int cin, int cout, int slices, int relu) {
  constexpr int SX = CINP + 8;  // row strides: bf16 elements, floats
  constexpr int SY = NB + 8;
  constexpr int NT = NB / 8;    // n-tiles of the block's channels
  constexpr int KT = CINP / 16;  // k-steps
  constexpr int NP = NB / 2;    // channel pairs of the 9-tap pass
  constexpr int TPC = kThreads / NP;  // threads per pair
  constexpr int SEG = kTile / TPC;    // positions per thread, in one row
  static_assert(8 % NT == 0 && TPC % kRows == 0 && kCols % SEG == 0,
                "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);               // x halo
  float* sy = reinterpret_cast<float*>(sx + kHaloRows * SX);  // y1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x / slices;
  const int cb = (blockIdx.x - tile * slices) * NB;
  const int tiles_w = (w + kCols - 1) / kCols;
  const int tiles_img = tiles_w * ((h + kRows - 1) / kRows);
  const int img = tile / tiles_img, rem = tile - img * tiles_img;
  const int r0 = (rem / tiles_w) * kRows, c0 = (rem % tiles_w) * kCols;
  const size_t base = static_cast<size_t>(img) * h * w;

  // the halo's copies fly while the weights are split. Its padding rows
  // feed only discarded MMA rows.
  for (int e = tid; e < (kHaloRows - kNpos) * SX; e += kThreads)
    sx[kNpos * SX + e] = __float2bfloat16_rn(0.f);
  load_halo<CINP, SX>(
      sx, x, cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0,
      base, r0, c0, h, w, cin);

  // B fragments of w1 as (k = ci, n = co), n-tile ny of the block's
  // channels, in three parts; b1 of this thread's y1 columns yc, yc + 1
  const int ny = warp % NT, yc = ny * 8 + 2 * t4;
  const bool live = cb + ny * 8 < cout;  // the n-tile holds a channel
  uint32_t bh[KT][2], bm[KT][2], bl[KT][2];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = ks * 16 + 2 * t4 + 8 * half, co = cb + ny * 8 + g;
      bf16 h0, m0, l0, h1, m1, l1;
      split3(k < cin && co < cout ? w1[k * cout + co] : 0.f, h0, m0, l0);
      split3(k + 1 < cin && co < cout ? w1[(k + 1) * cout + co] : 0.f, h1,
             m1, l1);
      bh[ks][half] = pack(h0, h1);
      bm[ks][half] = pack(m0, m1);
      bl[ks][half] = pack(l0, l1);
    }
  }
  float bias[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    bias[j] = cb + yc + j < cout ? b1[cb + yc + j] : 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // y1 on the halo (rows: halo positions, k: ci, n: the block's co):
  // the hi products a k-step at a time into a fresh accumulator, added in
  // f32; mid and lo chained in another. + b1, zero outside the image.
  if (live) {
    for (int mt = warp / NT; mt < kHaloRows / 16; mt += 8 / NT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, sx + (mt * 16 + (lane & 15)) * SX + ks * 16 +
                       (lane >> 4) * 8);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, a, bh[ks][0], bh[ks][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += part[q];
        mma_bf16(small, a, bl[ks][0], bl[ks][1]);
        mma_bf16(small, a, bm[ks][0], bm[ks][1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = mt * 16 + g + 8 * half;
        if (pos >= kNpos) continue;
        const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
        float2 v = make_float2(0.f, 0.f);
        if (gr >= 0 && gr < h && gc >= 0 && gc < w)
          v = make_float2(acc[2 * half] + small[2 * half] + bias[0],
                          acc[2 * half + 1] + small[2 * half + 1] + bias[1]);
        *reinterpret_cast<float2*>(sy + pos * SY + yc) = v;
      }
    }
  }
  __syncthreads();

  // the 9-tap pass: channels co, co + 1 (local 2 * pr) over SEG positions
  // of tile row r from column cs; halo row i, column j of the window is
  // halo position (r + i, cs + c + j)
  const int pr = tid % NP, s = tid / NP;
  const int co = cb + 2 * pr;
  if (co >= cout) return;
  const bool two = co + 1 < cout;
  const int r = s % kRows, cs = (s / kRows) * SEG;
  float2 wdr[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    wdr[t] = make_float2(wd[t * cout + co], two ? wd[t * cout + co + 1] : 0.f);
  const float2 bdr = make_float2(bd[co], two ? bd[co + 1] : 0.f);
  const float* syc = sy + 2 * pr;
  float2 win[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      win[i][j] = *reinterpret_cast<const float2*>(
          syc + ((r + i) * kWp + cs + j) * SY);
  const int gr = r0 + r;
  bf16* orow = out + (base + static_cast<size_t>(gr) * w) * cout + co;
#pragma unroll
  for (int c = 0; c < SEG; ++c) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      win[i][2] = *reinterpret_cast<const float2*>(
          syc + ((r + i) * kWp + cs + c + 2) * SY);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      a0 += win[t / 3][t % 3].x * wdr[t].x;
      a1 += win[t / 3][t % 3].y * wdr[t].y;
    }
    a0 += bdr.x;
    a1 += bdr.y;
    if (relu) {
      a0 = fmaxf(a0, 0.f);
      a1 = fmaxf(a1, 0.f);
    }
    const int gc = c0 + cs + c;
    if (gr < h && gc < w) {
      bf16* o = orow + static_cast<size_t>(gc) * cout;
      if (cout % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a0, a1);
      } else {
        o[0] = __float2bfloat16_rn(a0);
        if (two) o[1] = __float2bfloat16_rn(a1);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      win[i][0] = win[i][1];
      win[i][1] = win[i][2];
    }
  }
}

template <int CINP, int NB>
int launch_mma(const void* x, const void* w1, const void* b1, const void* wd,
               const void* bd, void* out, int h, int w, int cin, int cout,
               int blocks, int slices, int relu, cudaStream_t stream) {
  auto kernel = convdp_mma_kernel<CINP, NB>;
  constexpr size_t smem = mma_smem_bytes(CINP, NB);
  // set once per instantiation (the process's card): room for the
  // dynamic shared memory, and all of the SM's 228 KB as shared memory so
  // that two blocks fit (a hint)
  static const cudaError_t attrs = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<bf16*>(out), h, w, cin,
      cout, slices, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int CINP>
int dispatch_mma(int nb, const void* x, const void* w1, const void* b1,
                 const void* wd, const void* bd, void* out, int h, int w,
                 int cin, int cout, int blocks, int slices, int relu,
                 cudaStream_t s) {
  switch (nb) {
    case 16:
      return launch_mma<CINP, 16>(x, w1, b1, wd, bd, out, h, w, cin, cout,
                                  blocks, slices, relu, s);
    case 32:
      return launch_mma<CINP, 32>(x, w1, b1, wd, bd, out, h, w, cin, cout,
                                  blocks, slices, relu, s);
    default:
      return launch_mma<CINP, 64>(x, w1, b1, wd, bd, out, h, w, cin, cout,
                                  blocks, slices, relu, s);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the f32 route needs for a (cin -> cout) unit.
size_t yunet_convdp_smem_bytes(int cin, int cout) {
  const int npos = (kRows + 2) * (kCols + 2);
  return sizeof(float) * (static_cast<size_t>(npos) * (cin + cout) +
                          static_cast<size_t>(cin) * cout + 11 * cout);
}

// The most input or output channels the bf16 route takes.
int yunet_convdp_mma_max_channels() { return kMaxMmaChannels; }

// The f32 route. x: (n, h, w, cin) f32 or bf16 (bf16 != 0); w1: (cin,
// cout), b1: (cout), wd: (9, cout) tap-major (dy*3+dx), bd: (cout), all
// f32; out: (n, h, w, cout) in x's dtype. All device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch.
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

// The bf16 route, the same arguments with x and out bf16, at most
// yunet_convdp_mma_max_channels() channels each side. One block for each
// of the n * ceil(h/8) * ceil(w/16) tiles (the caller keeps that under
// 2^31), times ceil(cout/16) slices below kFillBlocks tiles.
int yunet_convdp_forward_mma(const void* x, const void* w1, const void* b1,
                             const void* wd, const void* bd, void* out, int n,
                             int h, int w, int cin, int cout, int relu,
                             void* stream) {
  if (cin < 1 || cout < 1 || cin > kMaxMmaChannels ||
      cout > kMaxMmaChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(n) *
                          ((h + kRows - 1) / kRows) *
                          ((w + kCols - 1) / kCols);
  const int coutp = pad_channels(cout);
  const int nb = coutp > 16 && tiles < kFillBlocks ? 16 : coutp;
  const int slices = (cout + nb - 1) / nb;
  const int blocks = static_cast<int>(tiles * slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pad_channels(cin)) {
    case 16:
      return dispatch_mma<16>(nb, x, w1, b1, wd, bd, out, h, w, cin, cout,
                              blocks, slices, relu, s);
    case 32:
      return dispatch_mma<32>(nb, x, w1, b1, wd, bd, out, h, w, cin, cout,
                              blocks, slices, relu, s);
    default:
      return dispatch_mma<64>(nb, x, w1, b1, wd, bd, out, h, w, cin, cout,
                              blocks, slices, relu, s);
  }
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
