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
// What bounds it on the H100: bytes. At the bench shape (64 -> 64, 160^2,
// N = 128, bf16) the unit reads x and writes the output once, 839 MB, and
// does 31 GFLOP (pointwise and taps): 37 operations a byte, far under the
// ~295 a byte at which the bf16 tensor cores would set the pace. What
// matters is keeping loads in flight and y1 off device memory.
//
// bf16 route (convdp_cm_mma_kernel; bf16 with at most 64 channels a side:
// the bench shape and every YuNet width). This function rounds w1 to bf16,
// and a bf16 x bf16 product is exact in f32, so one mma.sync m16n8k16 pass
// (bf16 in, f32 accumulate, chained over the 16-deep k-steps) computes
// y1's products exactly; only the order of the sums differs from the
// scalar route's. A = bf16(w1)^T (16 Cout x 16 Cin tiles) is built once a
// block and held in registers; B is the x row, staged in shared memory
// as [ci][column][image] rows padded by 8 elements (no bank conflicts for
// ldmatrix.trans). Cin and Cout are padded with zeros to 16, 32 or 64
// (one instantiation each).
//   A block tile is kMmaCols = 8 output columns (10 with the halo: 1.25x)
// by kMmaImages = 16 images. Its warps are (Cout/16 m-tiles) x (two image
// groups of 8), so a warp's mma n-tile is 8 images at one column, and a
// thread holds y1 for channels (g, g + 8) and images (2t, 2t + 1) at every
// column of the halo: the 9 taps need no shuffle and no shared memory.
// The warp walks down the rows keeping three y1 rows in registers as
// packed bf16x2 (exact: y1 is rounded to bf16 anyway); the taps run as f32
// fmaf in tap order t = 0..8, as the plain version sums them. x rows
// arrive by 16-byte cp.async into a ring of kStages rows, kStages - 1 rows
// ahead of the one being computed (element loads where N is not a
// multiple of 8).
//   Device memory sees each (row, channel, column) of a tile as a 32-byte
// run, and the runs of the image tiles beside it sit next to it. Read at
// different times, such short runs kept the loads and stores far under
// the card's memory rate. So the grid is persistent and ordered for it:
// block (nt, walker) takes image tile nt, and every walker, a set of all
// the image tiles of a column tile, walks an equal run of (column tile,
// row) units.
// All blocks are resident from the start and do the same work, so the
// image tiles of a column tile read and write the same rows at about the
// same time, and the card sees whole 256-byte runs (at N = 128). A run
// that crosses into the next column tile restarts its walk there (two
// halo rows). The kernel takes no register cap (one 256-thread block an
// SM at 64 -> 64): under a cap of 128 the y1 rows spill.
//   As built, on an H100 (700 W; PERF.md) the bench shape takes
// about 0.60 ms, 2.4x its 0.2504 ms byte bound and a third of the
// library's 1x1 + depthwise pair (1.91 ms). The first version, whose
// concurrent blocks held unrelated image tiles, took 1.76 ms. What is left
// is mostly the 9-tap pass on the CUDA cores (nine f32 FMAs and a bf16
// unpack an output), which one block of 8 warps an SM overlaps with the
// loads only in part. Tried and not kept: a cluster barrier a row (slower
// than none), a deeper ring, unpacking each y1 column once for three
// outputs (slower), and a cap of 128 registers for two blocks an SM
// (spills).
//
// f32 route (convdp_cm_kernel, also bf16 above 64 channels, which no
// preset reaches): the first port's kernel. A warp of 32 threads takes 32
// neighbouring images of one (row, channel, column); a block owns kCols
// output columns, kLanes images and up to kRowsPerBlock rows and walks
// down them with a ring of three f32 y1 rows in shared memory; the
// pointwise product is a serial chain of scalar FMAs from shared memory
// (211 KB a block at 64 -> 64, one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

// -- bf16 route: tensor-core pointwise, stencil in registers ----------------

using bf16 = __nv_bfloat16;

constexpr int kMmaCols = 8;                    // output columns a tile
constexpr int kMmaHalo = kMmaCols + 2;         // with the halo
constexpr int kMmaImages = 16;                 // images a tile: two groups
constexpr int kStages = 3;                     // x rows in shared memory
constexpr int kSX = kMmaHalo * kMmaImages + 8;  // stage row stride (bf16)
constexpr int kMaxMmaChannels = 64;

// channels padded to an MMA tile: 16, 32 or 64
inline int pad_channels(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : 64; }

constexpr size_t mma_smem_bytes(int cinp) {
  return sizeof(bf16) * kStages * cinp * kSX;
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 rounded to bf16 (RN), lo in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices, transposed; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc (channel g: images 2t, 2t+1; channel g+8: the same) += the taps
// 3 ty .. 3 ty + 2 of one y1 row at halo columns c .. c+2, in tap order
__device__ __forceinline__ void taps(float (&acc)[4],
                                     const uint32_t (&y)[kMmaHalo][2], int c,
                                     const float (&wd0)[9],
                                     const float (&wd1)[9], int ty) {
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    const uint32_t u0 = y[c + tx][0], u1 = y[c + tx][1];
    const float w0 = wd0[3 * ty + tx], w1 = wd1[3 * ty + tx];
    acc[0] = __fmaf_rn(lo_f32(u0), w0, acc[0]);
    acc[1] = __fmaf_rn(hi_f32(u0), w0, acc[1]);
    acc[2] = __fmaf_rn(lo_f32(u1), w1, acc[2]);
    acc[3] = __fmaf_rn(hi_f32(u1), w1, acc[3]);
  }
}

// Block (nt, walker): images 16 nt .. 16 nt + 15; the units [walker * per,
// (walker + 1) * per) of the list of (column tile, row) units, column tile
// major. Warp (mt, ig): output channels 16 mt .. 16 mt + 15, images 8 ig ..
// 8 ig + 7 of the block's.
template <int KT, int MT>
__global__ void __launch_bounds__(64 * MT, 1)
convdp_cm_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ wd,
                     const float* __restrict__ bd, bf16* __restrict__ out,
                     int h, int w, int n, int cin, int cout, int relu,
                     long long units, long long per, int vec) {
  constexpr int CINP = 16 * KT, NT = 64 * MT;
  constexpr int kStage = CINP * kSX;  // elements of one stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp >> 1, ig = warp & 1;
  const int co0 = mt * 16 + g, co1 = co0 + 8;
  const bool ok0 = co0 < cout, ok1 = co1 < cout;
  const int tiles_w = (w + kMmaCols - 1) / kMmaCols;
  const size_t wn = static_cast<size_t>(w) * n;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the padding channels' rows of every stage: zero, never loaded
  for (int e = tid; e < kStages * (CINP - cin) * kSX; e += NT) {
    const int s = e / ((CINP - cin) * kSX);
    sx[s * kStage + cin * kSX + (e - s * (CINP - cin) * kSX)] = zero;
  }

  // A fragments of bf16(w1)^T (m: co, k: ci), this warp's m-tile
  uint32_t a[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = q & 1 ? co1 : co0, k = ks * 16 + 2 * t4 + (q >> 1) * 8;
      const bool ok = co < cout;
      a[ks][q] = pack(
          __float2bfloat16_rn(ok && k < cin ? w1[k * cout + co] : 0.f),
          __float2bfloat16_rn(ok && k + 1 < cin ? w1[(k + 1) * cout + co]
                                                : 0.f));
    }
  }
  const float bias0 = ok0 ? b1[co0] : 0.f, bias1 = ok1 ? b1[co1] : 0.f;
  float wd0[9], wd1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wd0[t] = ok0 ? wd[t * cout + co0] : 0.f;
    wd1[t] = ok1 ? wd[t * cout + co1] : 0.f;
  }
  const float bd0 = ok0 ? bd[co0] : 0.f, bd1 = ok1 ? bd[co1] : 0.f;

  const int n0 = blockIdx.x * kMmaImages;
  const long long end = min(units, (blockIdx.y + 1) * per);
  for (long long u = blockIdx.y * per; u < end;) {
    const long long ct = u / h;
    const int r0 = static_cast<int>(u - ct * h);
    const int r1 =
        static_cast<int>(min(static_cast<long long>(h), r0 + (end - u)));
    u += r1 - r0;
    const int c0 = static_cast<int>(ct) * kMmaCols;

    // x row gr's halo into stage s: [ci][column j][image i]; zero off the
    // image's columns and past the batch; nothing for a row off the image
    auto load = [&](int gr, int s) {
      if (gr < 0 || gr >= h) return;
      bf16* dst = sx + s * kStage;
      const bf16* src = x + static_cast<size_t>(gr) * cin * wn;
      if (vec) {  // n % 8 == 0, x 16-byte aligned: 8 images a copy
        for (int e = tid; e < cin * kMmaHalo * 2; e += NT) {
          const int half = e & 1, rest = e >> 1;
          const int ci = rest / kMmaHalo, j = rest - ci * kMmaHalo;
          const int gc = c0 - 1 + j, nn = n0 + half * 8;
          const bool ok = gc >= 0 && gc < w && nn < n;
          cp_async16(dst + ci * kSX + j * kMmaImages + half * 8,
                     ok ? src + ci * wn + static_cast<size_t>(gc) * n + nn
                        : x,
                     ok);
        }
      } else {
        for (int e = tid; e < cin * kMmaHalo * kMmaImages; e += NT) {
          const int i = e & (kMmaImages - 1), rest = e / kMmaImages;
          const int ci = rest / kMmaHalo, j = rest - ci * kMmaHalo;
          const int gc = c0 - 1 + j, nn = n0 + i;
          bf16 v = zero;
          if (gc >= 0 && gc < w && nn < n)
            v = src[ci * wn + static_cast<size_t>(gc) * n + nn];
          dst[ci * kSX + j * kMmaImages + i] = v;
        }
      }
    };

    // y1 of row gy at the halo columns from stage s; zero off the image
    auto y1_row = [&](uint32_t (&y)[kMmaHalo][2], int gy, const bf16* s) {
      const bool row_ok = gy >= 0 && gy < h;
#pragma unroll
      for (int j = 0; j < kMmaHalo; j += 2) {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (row_ok) {
          // matrices: k 0-7 and 8-15 of column j, then of column j + 1
          const int q = lane >> 3;
          const bf16* p = s + ((q & 1) * 8 + (lane & 7)) * kSX +
                          (j + (q >> 1)) * kMmaImages + ig * 8;
#pragma unroll
          for (int ks = 0; ks < KT; ++ks) {
            uint32_t b[4];
            ldsm_x4_t(b, p + ks * 16 * kSX);
            mma_bf16(d[0], a[ks], b[0], b[1]);
            mma_bf16(d[1], a[ks], b[2], b[3]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int gc = c0 - 1 + j + jj;
          const bool ok = row_ok && gc >= 0 && gc < w;
          y[j + jj][0] =
              ok ? pack_rn(d[jj][0] + bias0, d[jj][1] + bias0) : 0u;
          y[j + jj][1] =
              ok ? pack_rn(d[jj][2] + bias1, d[jj][3] + bias1) : 0u;
        }
      }
    };

    // output row r from the y1 rows r - 1 (ya), r (yb), r + 1 (yc)
    auto stencil = [&](const uint32_t (&ya)[kMmaHalo][2],
                       const uint32_t (&yb)[kMmaHalo][2],
                       const uint32_t (&yc)[kMmaHalo][2], int r) {
      const int nn = n0 + ig * 8 + 2 * t4;
      bf16* orow = out + (static_cast<size_t>(r) * cout + co0) * wn + nn;
#pragma unroll
      for (int c = 0; c < kMmaCols; ++c) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        taps(acc, ya, c, wd0, wd1, 0);
        taps(acc, yb, c, wd0, wd1, 1);
        taps(acc, yc, c, wd0, wd1, 2);
        acc[0] += bd0;
        acc[1] += bd0;
        acc[2] += bd1;
        acc[3] += bd1;
        if (relu) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaxf(acc[q], 0.f);
        }
        const int gc = c0 + c;
        if (gc >= w || nn >= n) continue;
        bf16* o = orow + static_cast<size_t>(gc) * n;
        if (n % 2 == 0) {  // nn even, nn + 1 < n, 4-byte aligned
          if (ok0)
            *reinterpret_cast<uint32_t*>(o) = pack_rn(acc[0], acc[1]);
          if (ok1)
            *reinterpret_cast<uint32_t*>(o + 8 * wn) =
                pack_rn(acc[2], acc[3]);
        } else {
          const bool two = nn + 1 < n;
          if (ok0) {
            o[0] = __float2bfloat16_rn(acc[0]);
            if (two) o[1] = __float2bfloat16_rn(acc[1]);
          }
          if (ok1) {
            o[8 * wn] = __float2bfloat16_rn(acc[2]);
            if (two) o[8 * wn + 1] = __float2bfloat16_rn(acc[3]);
          }
        }
      }
    };

    // walk y1 rows r0 - 1 .. r1: row i's x lands kStages - 1 rows ahead
    const int m = r1 - r0 + 2;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < m) load(r0 - 1 + i, i);
      cp_async_commit();
    }
    uint32_t ya[kMmaHalo][2], yb[kMmaHalo][2], yc[kMmaHalo][2];
    for (int i = 0; i < m; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // row i's stage is full; stage (i - 1) is read
      if (i + kStages - 1 < m)
        load(r0 - 1 + i + kStages - 1, (i + kStages - 1) % kStages);
      cp_async_commit();
      y1_row(yc, r0 - 1 + i, sx + (i % kStages) * kStage);
      if (i >= 2) stencil(ya, yb, yc, r0 + i - 2);
#pragma unroll
      for (int j = 0; j < kMmaHalo; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          ya[j][q] = yb[j][q];
          yb[j][q] = yc[j][q];
        }
      }
    }
    __syncthreads();  // the stages are read before the next run loads
  }
}

template <int KT, int MT>
int launch_mma(const void* x, const void* w1, const void* b1, const void* wd,
               const void* bd, void* out, int h, int w, int n, int cin,
               int cout, int relu, cudaStream_t stream) {
  auto kernel = convdp_cm_mma_kernel<KT, MT>;
  constexpr int threads = 64 * MT;
  constexpr size_t smem = mma_smem_bytes(16 * KT);
  // once per instantiation (the process's card): room for the dynamic
  // shared memory, and the blocks that fit on the card at once (or a
  // negated error)
  static const long long slots = [&]() -> long long {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    int occ = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                        smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<long long>(e);
    return static_cast<long long>(std::max(occ, 1)) * sms;
  }();
  if (slots < 0) return static_cast<int>(-slots);
  // walkers: sets of every image tile that fit on the card at once; each
  // takes an equal run of (column tile, row) units
  const int ntn = (n + kMmaImages - 1) / kMmaImages;
  const long long units =
      static_cast<long long>((w + kMmaCols - 1) / kMmaCols) * h;
  const long long walkers = std::max(1LL, std::min(slots / ntn, units));
  const long long per = (units + walkers - 1) / walkers;
  const dim3 grid(ntn, static_cast<unsigned>((units + per - 1) / per));
  const int vec =
      n % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<bf16*>(out), h, w, n, cin,
      cout, relu, units, per, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int dispatch_mma(int coutp, const void* x, const void* w1, const void* b1,
                 const void* wd, const void* bd, void* out, int h, int w,
                 int n, int cin, int cout, int relu, cudaStream_t s) {
  switch (coutp) {
    case 16:
      return launch_mma<KT, 1>(x, w1, b1, wd, bd, out, h, w, n, cin, cout,
                               relu, s);
    case 32:
      return launch_mma<KT, 2>(x, w1, b1, wd, bd, out, h, w, n, cin, cout,
                               relu, s);
    default:
      return launch_mma<KT, 4>(x, w1, b1, wd, bd, out, h, w, n, cin, cout,
                               relu, s);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the f32 route needs for a (cin -> cout) unit.
size_t yunet_convdp_cm_smem_bytes(int cin, int cout) {
  return sizeof(float) *
         (static_cast<size_t>(kWp) * kLanes * (cin + 3 * static_cast<size_t>(cout)) +
          static_cast<size_t>(cin) * cout + 11 * static_cast<size_t>(cout));
}

// Images a block of the f32 route takes (its grid's y axis is ceil(n /
// this), its z axis ceil(h / yunet_convdp_cm_rows_per_block())).
int yunet_convdp_cm_lanes() { return kLanes; }
int yunet_convdp_cm_rows_per_block() { return kRowsPerBlock; }

// The most input or output channels the bf16 route takes.
int yunet_convdp_cm_mma_max_channels() { return kMaxMmaChannels; }

// The f32 route. x: (h, cin, w*n) f32 or bf16 (bf16 != 0), n minor; w1:
// (cin, cout), b1: (cout), wd: (9, cout) tap-major (dy*3+dx), bd: (cout),
// all f32; out: (h, cout, w*n) in x's dtype. All device pointers; stream
// is a cudaStream_t. Returns cudaGetLastError() after the launch.
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

// The bf16 route, the same arguments with x and out bf16, at most
// yunet_convdp_cm_mma_max_channels() channels each side. Its 1-D grid is
// the blocks that fit on the card at once (fewer for a small unit).
int yunet_convdp_cm_forward_mma(const void* x, const void* w1, const void* b1,
                                const void* wd, const void* bd, void* out,
                                int h, int w, int n, int cin, int cout,
                                int relu, void* stream) {
  if (cin < 1 || cout < 1 || cin > kMaxMmaChannels ||
      cout > kMaxMmaChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int coutp = pad_channels(cout);
  switch (pad_channels(cin)) {
    case 16:
      return dispatch_mma<1>(coutp, x, w1, b1, wd, bd, out, h, w, n, cin,
                             cout, relu, s);
    case 32:
      return dispatch_mma<2>(coutp, x, w1, b1, wd, bd, out, h, w, n, cin,
                             cout, relu, s);
    default:
      return dispatch_mma<4>(coutp, x, w1, b1, wd, bd, out, h, w, n, cin,
                             cout, relu, s);
  }
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
