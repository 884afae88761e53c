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
// Both routes walk the same tiles. Each block walks a fixed set of image
// tiles of kRows x kCols positions (tile = blockIdx.x, blockIdx.x +
// gridDim.x, ...), stages the (kRows+2) x (kCols+2) halo of x and dz in
// shared memory, recomputes y1 on the halo, and sums its share of the
// gradients over its tiles. At the end every block writes its sums to a
// row of `partial`, and a second launch adds the rows in block order.
// Nothing uses atomics: the grid is fixed by the shapes, so two calls give
// the same gradients bit for bit.
//
// What bounds the work on the H100: the bytes are x and dz read and dx
// written once; the arithmetic is three Cin x Cout products a position
// (the y1 recompute, dx and dw1), about 70 operations a byte at 64 -> 64,
// under the bf16 tensor cores' ~295. So once the products run on the
// tensor cores, even at mma.sync's share of the peak, the bytes bound it.
//
// bf16 route (convdp_bwd_mma_kernel, the shipped dtype). The three
// products run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate), their operands staged in bf16 and loaded with ldmatrix:
//   - y1 = bf16(x . bf16(w1) + b1): both operands are bf16 already, so
//     one pass computes the plain version's function up to the f32 sum
//     order. That order matters more than it seems: dwd sums y1 * dz over
//     every position, and a y1 that rounds the other way moves it by one
//     bf16 ulp of y1. With the tensor cores' sums alone, enough y1
//     rounded otherwise than the plain version's (cuBLAS in f32) to move
//     dwd past the check's 1e-4 of its scale at the smaller units on an
//     H100. So where the tensor-core sum lies within
//     kY1Tol * max|x| * sum|w1| (a bound on both sums' f32 error) of a
//     rounding boundary, about 0.1-0.5% of the entries, the warp sums y1
//     again in the f32 route's order (one multiply-add a term, ci
//     ascending), taking bf16(w1) from the lanes' B fragments by shuffles,
//     and rounds that.
//   - dx = dy1 . w1^T takes f32 dy1 and f32 w1. One bf16 pass would round
//     each to 8 bits (about 2^-9 of each term), beyond the check's 1e-4 of
//     dx's scale. So each is split into hi = bf16(v) and lo = bf16(v - hi)
//     (16 bits together), and dx = lo.hi + hi.lo + hi.hi, three products
//     into one f32 accumulator; the missing lo.lo and the residues are
//     ~2^-16 of a term.
//   - dw1 = x^T . dy1: x is exact in bf16, so two products, x.lo + x.hi.
//     Each warp keeps its dw1 tiles in registers across all the block's
//     image tiles.
// dy1 (9 taps), dwd, dbd and db1 stay f32 multiply-adds on the CUDA cores:
// each thread owns one channel and a run of the tile's positions, slides a
// 3x3 window of y1 and dz along it, and keeps its 11 sums in registers.
// Cin and Cout are padded with zeros to 16, 32 or 64 (the MMA tiles; one
// instantiation each, so at most 64 channels), rows of 16 bytes with 8
// elements of padding so that ldmatrix meets no bank conflicts. The halos
// come in as 16-byte cp.async copies where the channel count allows. The
// footprint, 111 KB at 64 -> 64, lets two blocks of 8 warps share an SM,
// so one block's loads overlap the other's products.
//
// As built it is not at the byte bound: the products are cheap, and what
// is left is instruction issue on the CUDA cores (the y1 epilogue with its
// rounding-band test, the 9-tap pass) and 128 registers a thread for two
// blocks an SM, with a few spills. Levers for a later change: prefetch the
// next tile's halos with cp.async while this one computes, and move the
// 9-tap pass to packed bf16x2 or f32x2 arithmetic.
//
// f32 route (convdp_bwd_kernel): scalar f32 multiply-adds from shared
// memory, one block of 16 warps an SM at 64 -> 64 (188 KB); not the
// shipped dtype, and not timed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// -- bf16 route: tensor-core products ---------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;      // 8 warps; two blocks share an SM
constexpr int kHaloRows = 192;        // kNpos rounded up to the MMA's 16 rows
constexpr int kMaxMmaChannels = 64;
// the band around a bf16 rounding boundary, as a share of max|x| *
// sum|w1|, in which y1 is summed again; at 2^-24 the 29 units of a 640^2
// b16 step keep dwd as close to the plain version's as the f32 route's
// (chip_smoke.py); a much narrower band lets some y1 round otherwise
constexpr float kY1Tol = 1.f / (1 << 24);

// channels padded to an MMA tile: 16, 32 or 64
__host__ __device__ inline int pad_channels(int c) {
  return c <= 16 ? 16 : c <= 32 ? 32 : 64;
}

// shared memory of one block for padded channel counts: the x halo
// (kHaloRows x cinp+8), the dz halo (kNpos x coutp), the y1 halo
// (kNpos x coutp+8) and dy1's hi and lo halves (kTile x coutp+8), bf16
__host__ __device__ inline size_t mma_smem_bytes(int cinp, int coutp) {
  return sizeof(bf16) *
         (static_cast<size_t>(kHaloRows) * (cinp + 8) +
          static_cast<size_t>(kNpos) * (2 * coutp + 8) +
          2 * static_cast<size_t>(kTile) * (coutp + 8));
}

// two floats rounded to bf16, packed low element first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v = hi + lo + O(2^-16 v), hi and lo bf16
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
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

// the (kRows+2) x (kCols+2) halo of a tile of g (channels c, padded to CP
// with zeros) into s (row stride STRIDE); zero outside the image
template <int CP, int STRIDE>
__device__ __forceinline__ void load_halo(bf16* s, const bf16* __restrict__ g,
                                          bool vec, size_t base, int r0,
                                          int c0, int h, int w, int c) {
  if (vec) {  // c % 8 == 0 and g 16-byte aligned
    constexpr int kChunks = CP / 8;
    for (int e = threadIdx.x; e < kNpos * kChunks; e += kMmaThreads) {
      const int pos = e / kChunks, ch = (e - pos * kChunks) * 8;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      const bool ok = gr >= 0 && gr < h && gc >= 0 && gc < w && ch < c;
      cp_async16(s + pos * STRIDE + ch,
                 ok ? g + (base + static_cast<size_t>(gr) * w + gc) * c + ch
                    : g,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < kNpos * CP; e += kMmaThreads) {
      const int pos = e / CP, ch = e - pos * CP;
      const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
      bf16 v = __float2bfloat16_rn(0.f);
      if (gr >= 0 && gr < h && gc >= 0 && gc < w && ch < c)
        v = g[(base + static_cast<size_t>(gr) * w + gc) * c + ch];
      s[pos * STRIDE + ch] = v;
    }
  }
}

// sum_ci x[ci] * bf16(w1[ci, co]) in the f32 route's order: one f32
// multiply-add a term, ci ascending (the padding's zero terms at the end
// change nothing). A warp-wide call: each lane sums its own row xrow for
// column nc of the warp's n-tile, whose bf16(w1) the lanes hold in their y1
// B fragments (lane 4 * nc + (ci % 8) / 2 holds ci in register (ci % 16) /
// 8 of k-step ci / 16).
template <int KT>
__device__ __forceinline__ float y1_chain(const bf16* xrow,
                                          const uint32_t (&by)[KT][2],
                                          int nc) {
  float acc = 0.f;
#pragma unroll
  for (int c8 = 0; c8 < KT * 16; c8 += 8) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xrow + c8);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const uint32_t wp = __shfl_sync(0xffffffffu, by[c8 / 16][(c8 / 8) & 1],
                                      4 * nc + i / 2);
      const __nv_bfloat162 wv = *reinterpret_cast<const __nv_bfloat162*>(&wp);
      acc += __bfloat162float(xs[i]) * __low2float(wv);
      acc += __bfloat162float(xs[i + 1]) * __high2float(wv);
    }
  }
  return acc;
}

template <int CINP, int COUTP>
__global__ void __launch_bounds__(kMmaThreads, 2)
convdp_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ wd, bf16* __restrict__ dx,
                      float* __restrict__ partial, int n, int h, int w,
                      int cin, int cout) {
  constexpr int SX = CINP + 8;     // row strides, in elements
  constexpr int SY = COUTP + 8;
  constexpr int NT = COUTP / 8;    // n-tiles of y1 and of dw1
  constexpr int NTX = CINP / 8;    // n-tiles of dx
  constexpr int KT = CINP / 16;    // k-steps of y1
  constexpr int KTX = COUTP / 16;  // k-steps of dx
  constexpr int TPC = kMmaThreads / COUTP;  // threads per channel
  constexpr int SEG = kTile / TPC;          // tile positions per thread
  constexpr int SEG_ROWS = SEG < kCols ? 1 : SEG / kCols;
  constexpr int SEG_LEN = SEG < kCols ? SEG : kCols;
  constexpr int DW_TILES = (CINP / 16) * NT;
  constexpr int DW_PER_WARP = (DW_TILES + 7) / 8;
  constexpr int kSums = 11;  // db1 | dwd (9 taps) | dbd of a channel
  static_assert(8 % NT == 0 && 8 % NTX == 0 && kCols == 16, "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);  // kHaloRows x SX
  bf16* sdz = sx + kHaloRows * SX;               // kNpos x COUTP
  bf16* sy = sdz + kNpos * COUTP;                // kNpos x SY
  bf16* shi = sy + kNpos * SY;                   // kTile x SY, dy1's halves
  bf16* slo = shi + kTile * SY;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // B fragments in registers for the whole kernel. y1: bf16(w1) as
  // (k = ci, n = co), this warp's n-tile ny. dx: w1's hi and lo halves
  // as (k = co, n = ci), this warp's n-tile nx.
  const int ny = warp % NT, nx = warp % NTX;
  auto w1_at = [&](int ci, int co) {
    return ci < cin && co < cout ? w1[ci * cout + co] : 0.f;
  };
  uint32_t by[KT][2];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    const int k = ks * 16 + 2 * t4, co = ny * 8 + g;
    by[ks][0] = pack_bf16(w1_at(k, co), w1_at(k + 1, co));
    by[ks][1] = pack_bf16(w1_at(k + 8, co), w1_at(k + 9, co));
  }
  uint32_t bxh[KTX][2], bxl[KTX][2];
#pragma unroll
  for (int ks = 0; ks < KTX; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = ks * 16 + 2 * t4 + 8 * half, ci = nx * 8 + g;
      bf16 h0, l0, h1, l1;
      split_bf16(w1_at(ci, k), h0, l0);
      split_bf16(w1_at(ci, k + 1), h1, l1);
      __nv_bfloat162 hv(h0, h1), lv(l0, l1);
      bxh[ks][half] = *reinterpret_cast<uint32_t*>(&hv);
      bxl[ks][half] = *reinterpret_cast<uint32_t*>(&lv);
    }
  }
  const int yc = ny * 8 + 2 * t4;  // this thread's y1 columns yc, yc + 1
  float bias[2], wsum[2];  // b1 and sum_ci |bf16(w1)| of the two columns
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bias[j] = yc + j < cout ? b1[yc + j] : 0.f;
    wsum[j] = 0.f;
    for (int ci = 0; ci < cin; ++ci)
      wsum[j] += fabsf(round_to<bf16>(w1_at(ci, yc + j)));
  }

  // the channel this thread owns in the CUDA-core pass, and its run of
  // SEG tile positions
  const int co = tid % COUTP, seg = tid / COUTP;
  float wdr[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wdr[t] = co < cout ? wd[t * cout + co] : 0.f;
  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = 0.f;
  float acc_dw1[DW_PER_WARP][4];
#pragma unroll
  for (int j = 0; j < DW_PER_WARP; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_dw1[j][q] = 0.f;

  // the x halo's padding rows feed only discarded MMA rows: zero them once
  for (int e = tid; e < (kHaloRows - kNpos) * SX; e += kMmaThreads)
    sx[kNpos * SX + e] = __float2bfloat16_rn(0.f);
  const bool vec_x =
      cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_dz =
      cout % 8 == 0 && (reinterpret_cast<uintptr_t>(dz) & 15) == 0;

  const int tiles_w = (w + kCols - 1) / kCols;
  const int tiles_img = tiles_w * ((h + kRows - 1) / kRows);
  const int tiles = n * tiles_img;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int img = tile / tiles_img, rem = tile - img * tiles_img;
    const int r0 = (rem / tiles_w) * kRows, c0 = (rem % tiles_w) * kCols;
    const size_t base = static_cast<size_t>(img) * h * w;
    __syncthreads();  // the last tile's reads of shared memory are done

    load_halo<CINP, SX>(sx, x, vec_x, base, r0, c0, h, w, cin);
    load_halo<COUTP, COUTP>(sdz, dz, vec_dz, base, r0, c0, h, w, cout);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // y1 on the halo (rows: halo positions, k: ci, n: co), rounded to
    // bf16; zero outside the image. Where the tensor-core sum lies within
    // kY1Tol * max|x| * sum|w1| of a bf16 rounding boundary, the warp sums
    // y1 again in the f32 route's order and rounds that.
    for (int mt = warp / NT; mt < kHaloRows / 16; mt += 8 / NT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t xm[2] = {0u, 0u};  // max |x| of rows g and g + 8, as bf16x2
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, sx + (mt * 16 + (lane & 15)) * SX + ks * 16 +
                       (lane >> 4) * 8);
        mma_bf16(acc, a, by[ks][0], by[ks][1]);
        // |bf16| orders as its bits do
        xm[0] = __vmaxu2(xm[0], __vmaxu2(a[0] & 0x7fff7fffu,
                                         a[2] & 0x7fff7fffu));
        xm[1] = __vmaxu2(xm[1], __vmaxu2(a[1] & 0x7fff7fffu,
                                         a[3] & 0x7fff7fffu));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t m = xm[half];
        m = __vmaxu2(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = __vmaxu2(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float xmax = __uint_as_float(max(m & 0xffffu, m >> 16) << 16);
        const int pos = mt * 16 + g + 8 * half;
        const int gr = r0 - 1 + pos / kWp, gc = c0 - 1 + pos % kWp;
        const bool in = pos < kNpos && gr >= 0 && gr < h && gc >= 0 && gc < w;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = acc[2 * half + j] + bias[j];
          const float tol = kY1Tol * xmax * wsum[j];
          const bool redo =
              in && __bfloat16_as_ushort(__float2bfloat16_rn(v[j] - tol)) !=
                        __bfloat16_as_ushort(__float2bfloat16_rn(v[j] + tol));
          if (__any_sync(0xffffffffu, redo)) {
            const float c = y1_chain<KT>(sx + pos * SX, by, 2 * t4 + j);
            if (redo) v[j] = c + bias[j];
          }
          if (!in) v[j] = 0.f;
        }
        if (pos < kNpos)
          *reinterpret_cast<__nv_bfloat162*>(sy + pos * SY + yc) =
              __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    __syncthreads();

    // the CUDA-core pass, channel co over this thread's positions: dwd and
    // dbd from the y1 and dz windows; dy1 = sum_t wd[t] * dz[a+1-ty,
    // b+1-tx] (zero past the image's edge), its sum db1, and its bf16
    // halves for the products below. Halo row i, col j of the window is
    // halo position (r + i, cb + c + j).
#pragma unroll
    for (int rr = 0; rr < SEG_ROWS; ++rr) {
      const int p0 = seg * SEG + rr * kCols;
      const int r = p0 / kCols, cb = p0 % kCols;
      float yw[3][3], zw[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pos = (r + i) * kWp + cb + j;
          yw[i][j] = __bfloat162float(sy[pos * SY + co]);
          zw[i][j] = __bfloat162float(sdz[pos * COUTP + co]);
        }
#pragma unroll
      for (int c = 0; c < SEG_LEN; ++c) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int pos = (r + i) * kWp + cb + c + 2;
          yw[i][2] = __bfloat162float(sy[pos * SY + co]);
          zw[i][2] = __bfloat162float(sdz[pos * COUTP + co]);
        }
        const float gz = zw[1][1];
#pragma unroll
        for (int t = 0; t < 9; ++t) sums[1 + t] += yw[t / 3][t % 3] * gz;
        sums[10] += gz;
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) d += wdr[t] * zw[2 - t / 3][2 - t % 3];
        if (r0 + r >= h || c0 + cb + c >= w) d = 0.f;
        sums[0] += d;
        const int p = r * kCols + cb + c;
        split_bf16(d, shi[p * SY + co], slo[p * SY + co]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          yw[i][0] = yw[i][1], yw[i][1] = yw[i][2];
          zw[i][0] = zw[i][1], zw[i][1] = zw[i][2];
        }
      }
    }
    __syncthreads();

    // dx = dy1 . w1^T (rows: tile positions, k: co, n: ci), three
    // products of the halves, rounded once to bf16. m-tile mt is tile row
    // mt (kCols == 16).
    for (int mt = warp / NTX; mt < kTile / 16; mt += 8 / NTX) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KTX; ++ks) {
        const int off = (mt * 16 + (lane & 15)) * SY + ks * 16 +
                        (lane >> 4) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, shi + off);
        ldsm_x4(al, slo + off);
        mma_bf16(acc, al, bxh[ks][0], bxh[ks][1]);
        mma_bf16(acc, ah, bxl[ks][0], bxl[ks][1]);
        mma_bf16(acc, ah, bxh[ks][0], bxh[ks][1]);
      }
      const int ci = nx * 8 + 2 * t4, gr = r0 + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gc = c0 + g + 8 * half;
        if (gr >= h || gc >= w || ci >= cin) continue;
        bf16* out = dx + (base + static_cast<size_t>(gr) * w + gc) * cin + ci;
        if (cin % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(acc[2 * half], acc[2 * half + 1]);
        } else {
          out[0] = __float2bfloat16_rn(acc[2 * half]);
          if (ci + 1 < cin) out[1] = __float2bfloat16_rn(acc[2 * half + 1]);
        }
      }
    }

    // dw1 += x^T . dy1 (rows: ci, k: the tile's positions, n: co), two
    // products (x is exact in bf16). k-step kk is tile row kk. A (x^T)
    // comes transposed from the x halo: matrix q holds positions
    // (q / 2) * 8.. and channels (q % 2) * 8..; B holds dy1's hi (matrices
    // 0, 1) and lo (2, 3) halves, positions 0-7 and 8-15.
#pragma unroll
    for (int j = 0; j < DW_PER_WARP; ++j) {
      const int ti = warp + 8 * j;
      if (ti >= DW_TILES) continue;
      const int mi = ti / NT, ni = ti % NT;
      const int q = lane >> 3, rw = lane & 7;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4_trans(a, sx + ((kk + 1) * kWp + (q >> 1) * 8 + rw + 1) * SX +
                             mi * 16 + (q & 1) * 8);
        ldsm_x4_trans(b, (q >> 1 ? slo : shi) +
                             (kk * 16 + (q & 1) * 8 + rw) * SY + ni * 8);
        mma_bf16(acc_dw1[j], a, b[2], b[3]);
        mma_bf16(acc_dw1[j], a, b[0], b[1]);
      }
    }
  }

  // the block's sums into its row of partial: dw1 from the fragments; the
  // TPC threads of a channel add their 11 sums in thread order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // TPC x kSums x COUTP
#pragma unroll
  for (int k = 0; k < kSums; ++k) red[(seg * kSums + k) * COUTP + co] = sums[k];
  float* row = partial + static_cast<size_t>(blockIdx.x) * acc_len(cin, cout);
#pragma unroll
  for (int j = 0; j < DW_PER_WARP; ++j) {
    const int ti = warp + 8 * j;
    if (ti >= DW_TILES) continue;
    const int mi = ti / NT, ni = ti % NT;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = mi * 16 + g + 8 * (e >> 1), c = ni * 8 + 2 * t4 + (e & 1);
      if (ci < cin && c < cout) row[ci * cout + c] = acc_dw1[j][e];
    }
  }
  __syncthreads();
  // db1 | dwd | dbd follow dw1 in the row, in the order of sums[]
  for (int e = tid; e < kSums * cout; e += kMmaThreads) {
    const int k = e / cout, c = e - k * cout;
    float s = 0.f;
    for (int sg = 0; sg < TPC; ++sg) s += red[(sg * kSums + k) * COUTP + c];
    row[cin * cout + e] = s;
  }
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

// the tile launch (blocks of `threads`, `smem` bytes of shared memory),
// then the reduction of its rows of partial into grads
template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* x,
           const void* dz, const void* w1, const void* b1, const void* wd,
           void* dx, float* partial, float* grads, int n, int h, int w,
           int cin, int cout, int blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(
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

// the bf16 route's instantiation for the padded channel counts
template <int CINP, int COUTP>
int launch_mma(const void* x, const void* dz, const void* w1, const void* b1,
               const void* wd, void* dx, float* partial, float* grads, int n,
               int h, int w, int cin, int cout, int blocks,
               cudaStream_t stream) {
  auto kernel = convdp_bwd_mma_kernel<CINP, COUTP>;
  // all of the SM's 228 KB as shared memory, so that two blocks fit (a
  // hint; set once)
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  return launch<bf16>(kernel, kMmaThreads, mma_smem_bytes(CINP, COUTP), x,
                      dz, w1, b1, wd, dx, partial, grads, n, h, w, cin, cout,
                      blocks, stream);
}

template <int CINP>
int dispatch_mma(int coutp, const void* x, const void* dz, const void* w1,
                 const void* b1, const void* wd, void* dx, float* partial,
                 float* grads, int n, int h, int w, int cin, int cout,
                 int blocks, cudaStream_t s) {
  switch (coutp) {
    case 16:
      return launch_mma<CINP, 16>(x, dz, w1, b1, wd, dx, partial, grads, n,
                                  h, w, cin, cout, blocks, s);
    case 32:
      return launch_mma<CINP, 32>(x, dz, w1, b1, wd, dx, partial, grads, n,
                                  h, w, cin, cout, blocks, s);
    default:
      return launch_mma<CINP, 64>(x, dz, w1, b1, wd, dx, partial, grads, n,
                                  h, w, cin, cout, blocks, s);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the f32 route's tile launch needs for a
// (cin -> cout) unit.
size_t yunet_convdp_bwd_smem_bytes(int cin, int cout) {
  return sizeof(float) *
         (static_cast<size_t>(kNpos) * (cin + 2 * cout) +
          2 * static_cast<size_t>(cin) * cout + 10 * static_cast<size_t>(cout) +
          static_cast<size_t>(acc_len(cin, cout)));
}

// The most input or output channels the bf16 route takes.
int yunet_convdp_bwd_mma_max_channels() { return kMaxMmaChannels; }

// Blocks of the tile launch, i.e. rows of `partial`, for an (n, h, w) input.
int yunet_convdp_bwd_blocks(int n, int h, int w) {
  const long long tiles = static_cast<long long>(n) *
                          ((h + kRows - 1) / kRows) *
                          ((w + kCols - 1) / kCols);
  return static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

// Length of a row of `partial` and of `grads`.
int yunet_convdp_bwd_acc_len(int cin, int cout) { return acc_len(cin, cout); }

// x: (n, h, w, cin) and dz: (n, h, w, cout), f32 or bf16 (is_bf16 != 0);
// w1: (cin, cout), b1: (cout), wd: (9, cout) tap-major (dy*3+dx), all f32;
// dx: (n, h, w, cin) in x's dtype; partial: yunet_convdp_bwd_blocks(n, h, w)
// x acc_len f32 scratch; grads: acc_len f32, written as dw1 | db1 | dwd |
// dbd. bf16 takes the tensor-core route (at most
// yunet_convdp_bwd_mma_max_channels() channels each side), f32 the scalar
// one. All device pointers; stream is a cudaStream_t. Returns the first
// nonzero cudaGetLastError() of the two launches, or 0.
int yunet_convdp_backward(const void* x, const void* dz, const void* w1,
                          const void* b1, const void* wd, void* dx,
                          void* partial, void* grads, int n, int h, int w,
                          int cin, int cout, int is_bf16, void* stream) {
  const int blocks = yunet_convdp_bwd_blocks(n, h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* g = static_cast<float*>(grads);
  if (!is_bf16)
    return launch<float>(convdp_bwd_kernel<float>, kThreads,
                         yunet_convdp_bwd_smem_bytes(cin, cout), x, dz, w1,
                         b1, wd, dx, p, g, n, h, w, cin, cout, blocks, s);
  if (cin > kMaxMmaChannels || cout > kMaxMmaChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  const int coutp = pad_channels(cout);
  switch (pad_channels(cin)) {
    case 16:
      return dispatch_mma<16>(coutp, x, dz, w1, b1, wd, dx, p, g, n, h, w,
                              cin, cout, blocks, s);
    case 32:
      return dispatch_mma<32>(coutp, x, dz, w1, b1, wd, dx, p, g, n, h, w,
                              cin, cout, blocks, s);
    default:
      return dispatch_mma<64>(coutp, x, dz, w1, b1, wd, dx, p, g, n, h, w,
                              cin, cout, blocks, s);
  }
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
