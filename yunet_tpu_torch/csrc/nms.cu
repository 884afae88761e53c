// Greedy NMS over score-sorted candidates as a bitmask: the IoU predicate
// of every pair in parallel (launch A), then one warp per image scanning
// it in score order (launch B). Both launches come from one host call.
//
// Replaces the TPU kernels yunet_tpu/ops/nms_pallas.py:_nms_batched_kernel
// (whole batch, line 78) and :_nms_kernel (one image, line 40). The
// per-image call is the batch-1 case of the same kernels.
//
// Semantics (mmcv's greedy NMS): candidates arrive sorted by score,
// descending, with the first counts[b] = n of image b above the score
// threshold. Box j is suppressed iff some box i < j that is still alive
// has IoU(i, j) > iou_thr; keep[b][j] = alive(j) && j < n. Boxes past n
// can only suppress boxes past n, which keep masks anyway, so both
// launches stop at n, read on the device.
//
// What bounds it on the H100: the serial dependency. Box i's fate is
// known only once every earlier alive box has been applied, so a direct
// loop costs n dependent steps, each an IoU pass and a block barrier.
// The IoUs themselves do not depend on the order, so they move out of
// the chain:
//   * launch A, the mask: bit c of u32 word mask[b][i][w] is set iff
//     column j = 32w + c has j > i, j < n and IoU(i, j) > iou_thr, for
//     rows i < n and words w in [floor(i/32), ceil(n/32)) (the upper
//     triangle); a row is mask_words(k) words, ceil(k/32) rounded up to
//     4. A block takes one 32-row tile (boxes and areas in shared
//     memory) and kMaskWarps words; in a warp, lane c owns column 32w + c
//     and a ballot over the warp gives each row's word. The grid spans
//     images x row tiles x word spans; a block past n or below the
//     diagonal exits at once, so the host never needs n. Rows and words
//     past that are never written. Its work is the IoU of every live
//     pair; a pair that does not intersect skips the IEEE division.
//   * launch B, the scan: one warp an image, no block barrier. Lane l
//     owns the "removed" words w = l + 32q in registers (q < Q, Q =
//     ceil(mask_words(k)/32), 10 at the largest k). Tile t's 32 rows
//     (their words from t on) are copied to shared memory with cp.async
//     while tile t-1 is scanned. For tile t the tile's removed word comes
//     from its owner by a shuffle, and the warp resolves the tile's 32
//     greedy steps on it, visiting only the rows that are alive and whose
//     diagonal word is not zero; then each lane ORs the later words of
//     the tile's alive rows into the words it owns. A step of the greedy
//     loop is a few register operations and, for a row that suppresses,
//     one shuffle; a tile is one pass over shared memory. That OR pass,
//     not the greedy steps, sets the scan's time (read straight from
//     device memory, it also put a round trip on the chain each tile), so
//     it reads as little as it can: at most 64 words a row, all 32 rows
//     with the removed ones masked off; above that only the alive rows.
//     The scratch mask is not zeroed: a word the scan reads that the
//     mask launch did not write, or a staged word no copy filled, lands
//     in a removed word that no later tile reads.
//
// The keep set must equal the plain PyTorch version's bit for bit, so the
// IoU is evaluated with explicitly rounded operations in the same order as
// nms_pallas.py:59-62 (and the file is built with -fmad=false):
//   area  = max(x2-x1, 0) * max(y2-y1, 0)
//   inter = max(iw, 0) * max(ih, 0)
//   iou   = inter / max(area_j + area_i - inter, 1e-9)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskWarps = 8;     // words (32-column spans) a mask block takes
constexpr int kMaxK = 9685;       // the wrapper's limit (ops/nms.py:MAX_K)
// a mask row is words = ceil(ceil(k/32)/4)*4 u32: rows copy in 16 B pieces
constexpr int kMaxWords = ((kMaxK + 31) / 32 + 3) / 4 * 4;
constexpr int kMaxQ = (kMaxWords + 31) / 32;   // 10 removed words a lane

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(i, j) > thr with the plain version's roundings, j the column box.
// A pair that does not intersect skips the division: 0 / union is +-0,
// which compares with thr as 0 does (union >= 1e-9 is never NaN).
__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj,
                                         float aj, float thr) {
  const float iw = __fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x));
  const float ih = __fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y));
  const float inter = __fmul_rn(fmaxf(iw, 0.f), fmaxf(ih, 0.f));
  if (inter == 0.f) return 0.f > thr;
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aj, ai), inter), 1e-9f);
  return __fdiv_rn(inter, uni) > thr;
}

// grid (batch, ceil(k/32), ceil(ceil(k/32) / kMaskWarps)): x the image, y
// a 32-row tile, z a span of words
__global__ void __launch_bounds__(32 * kMaskWarps)
nms_mask_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ counts, int k, int words,
                float iou_thr, uint32_t* __restrict__ mask) {
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int w0 = blockIdx.z * kMaskWarps;
  const int n = min(max(counts[b], 0), k);
  const int wn = (n + 31) >> 5;
  if (32 * t >= n || w0 + kMaskWarps <= t || w0 >= wn) return;

  __shared__ float4 srow[32];
  __shared__ float sarea[32];
  const float4* img = boxes + static_cast<size_t>(b) * k;
  const int rows = min(32, n - 32 * t);
  if (threadIdx.x < 32) {
    const float4 bx = threadIdx.x < rows ? img[32 * t + threadIdx.x]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    srow[threadIdx.x] = bx;
    sarea[threadIdx.x] = box_area(bx);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = w0 + (threadIdx.x >> 5);
  if (w < t || w >= wn) return;                   // the whole warp
  const int j = 32 * w + lane;
  const bool live = j < n;
  const float4 bj = live ? img[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float aj = box_area(bj);
  uint32_t mine = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const bool hit = (r < rows) & live & (j > 32 * t + r) &&
                     overlaps(srow[r], sarea[r], bj, aj, iou_thr);
    const uint32_t word = __ballot_sync(kFull, hit);
    if (lane == r) mine = word;
  }
  if (lane < rows)
    mask[(static_cast<size_t>(b) * k + 32 * t + lane) * words + w] = mine;
}

__device__ __forceinline__ void cp_async16(uint32_t* smem,
                                           const uint32_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies tile t's rows < n, words [t & ~3, ceil(n/32) rounded up to 4),
// from the mask (row stride words) to buf (row stride s), lane l row
// 32t + l, and commits them as one group.
__device__ __forceinline__ void stage_tile(uint32_t* buf,
                                           const uint32_t* img, int words,
                                           int s, int t, int n, int wn,
                                           int lane) {
  const int w0 = t & ~3;
  const int w1 = (wn + 3) & ~3;
  if (32 * t + lane < n) {
    const uint32_t* src = img + static_cast<size_t>(32 * t + lane) * words;
    uint32_t* dst = buf + lane * s;
    for (int w = w0; w < w1; w += 4) cp_async16(dst + w, src + w);
  }
  cp_async_commit();
}

// one warp (block) per image; Q removed words a lane. Dynamic shared
// memory: two tiles of 33 rows x 32Q words, row 32 all zeros.
template <int Q>
__global__ void __launch_bounds__(32)
nms_scan_kernel(const int* __restrict__ counts, int k, int words,
                const uint32_t* __restrict__ mask,
                uint8_t* __restrict__ keep) {
  constexpr int S = 32 * Q;
  constexpr int kTile = 33 * S;
  extern __shared__ __align__(16) uint32_t sbuf[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = min(max(counts[b], 0), k);
  const int wn = (n + 31) >> 5;
  const uint32_t* img = mask + static_cast<size_t>(b) * k * words;
  uint8_t* out = keep + static_cast<size_t>(b) * k;

  uint32_t rem[Q];                  // removed bits of words lane + 32q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    rem[q] = 0;
    sbuf[32 * S + 32 * q + lane] = 0;
    sbuf[kTile + 32 * S + 32 * q + lane] = 0;
  }
  if (wn > 0) stage_tile(sbuf, img, words, S, 0, n, wn, lane);

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    for (int tl = 0; tl < 32; ++tl) {
      const int t = 32 * q + tl;
      if (t >= wn) break;
      // the next tile streams in while this one is scanned
      if (t + 1 < wn)
        stage_tile(sbuf + ((t + 1) & 1) * kTile, img, words, S, t + 1, n,
                   wn, lane);
      else
        cp_async_commit();
      cp_async_wait_one();
      __syncwarp();
      const uint32_t* tile = sbuf + (t & 1) * kTile;
      const int rows = min(32, n - 32 * t);
      const uint32_t valid = rows == 32 ? kFull : (1u << rows) - 1u;

      // the tile's greedy steps: rows removed by earlier tiles, then each
      // alive row with a nonzero diagonal word in order
      const uint32_t diag = lane < rows ? tile[lane * S + t] : 0u;
      uint32_t cur = __shfl_sync(kFull, rem[q], tl) & valid;
      uint32_t todo = __ballot_sync(kFull, diag != 0) & ~cur;
      while (todo) {
        cur |= __shfl_sync(kFull, diag, __ffs(todo) - 1);
        todo &= (todo - 1) & ~cur;
      }
      const uint32_t alive = ~cur & valid;
      if (32 * t + lane < k) out[32 * t + lane] = (alive >> lane) & 1u;

      // the alive rows' later words into the words each lane owns. A word
      // not staged, or not written by the mask launch, is <= t or >= wn:
      // it lands in a removed word that no later tile reads. With at most
      // 64 words a row, every row is read and the removed ones masked off;
      // with more, only the alive rows, four a round (a missing one reads
      // the zero row).
      if (Q <= 2) {
#pragma unroll
        for (int q2 = q; q2 < Q; ++q2) {
          if (32 * q2 + 31 <= t || 32 * q2 >= wn) continue;   // whole warp
          const int w = 32 * q2 + lane;
          uint32_t acc = 0;
#pragma unroll
          for (int r = 0; r < 32; ++r)
            acc |= tile[r * S + w] & (0u - ((alive >> r) & 1u));
          rem[q2] |= acc;
        }
      } else {
        uint32_t left = alive;
        while (left) {
          int r[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            r[u] = left ? __ffs(left) - 1 : 32;
            left &= left - 1;
          }
#pragma unroll
          for (int q2 = q; q2 < Q; ++q2) {
            if (32 * q2 + 31 <= t || 32 * q2 >= wn) continue;
            const int w = 32 * q2 + lane;
            rem[q2] |= tile[r[0] * S + w] | tile[r[1] * S + w] |
                       tile[r[2] * S + w] | tile[r[3] * S + w];
          }
        }
      }
      __syncwarp();                 // the tile is read before it is restaged
    }
  }
  for (int j = 32 * wn + lane; j < k; j += 32) out[j] = 0;
}

int mask_words(int k) { return ((k + 31) / 32 + 3) / 4 * 4; }

int launch_mask(const void* boxes, const int* counts, int batch, int k,
                float iou_thr, uint32_t* mask, cudaStream_t s) {
  const int tiles = (k + 31) / 32;
  const dim3 grid(batch, tiles, (tiles + kMaskWarps - 1) / kMaskWarps);
  nms_mask_kernel<<<grid, 32 * kMaskWarps, 0, s>>>(
      static_cast<const float4*>(boxes), counts, k, mask_words(k), iou_thr,
      mask);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int scan(int batch, const int* counts, int k, const uint32_t* mask,
         uint8_t* keep, cudaStream_t s) {
  const size_t smem = 2 * 33 * 32 * Q * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_scan_kernel<Q><<<batch, 32, smem, s>>>(counts, k, mask_words(k), mask,
                                             keep);
  return static_cast<int>(cudaGetLastError());
}

int launch_scan(const int* counts, int batch, int k, const uint32_t* mask,
                uint8_t* keep, cudaStream_t s) {
  switch ((mask_words(k) + 31) / 32) {
    case 1: return scan<1>(batch, counts, k, mask, keep, s);
    case 2: return scan<2>(batch, counts, k, mask, keep, s);
    case 3: return scan<3>(batch, counts, k, mask, keep, s);
    case 4: return scan<4>(batch, counts, k, mask, keep, s);
    case 5: return scan<5>(batch, counts, k, mask, keep, s);
    case 6: return scan<6>(batch, counts, k, mask, keep, s);
    case 7: return scan<7>(batch, counts, k, mask, keep, s);
    case 8: return scan<8>(batch, counts, k, mask, keep, s);
    case 9: return scan<9>(batch, counts, k, mask, keep, s);
    default: return scan<kMaxQ>(batch, counts, k, mask, keep, s);
  }
}

// runs fn on card `device`, the caller's current card restored after
template <typename F>
int on_device(int device, F fn) {
  int prev = device;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int code = fn();
  if (prev != device) cudaSetDevice(prev);
  return code;
}

}  // namespace

extern "C" {

// boxes: (batch, k, 4) f32, sorted by score per image; counts: (batch,)
// i32; mask: (batch, k, mask_words(k)) u32 scratch, need not be zeroed;
// keep: (batch, k) u8 (a torch.bool) output. All device pointers on card
// `device`; stream is a cudaStream_t of that card; 1 <= k <= 9685 and
// batch >= 1. Returns the first nonzero cudaError_t of the two launches,
// or 0.
int yunet_greedy_nms(const void* boxes, const void* counts, int batch, int k,
                     float iou_thr, void* mask, void* keep, int device,
                     void* stream) {
  if (k < 1 || k > kMaxK || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* cnt = static_cast<const int*>(counts);
  auto* m = static_cast<uint32_t*>(mask);
  const auto s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    const int e = launch_mask(boxes, cnt, batch, k, iou_thr, m, s);
    return e ? e : launch_scan(cnt, batch, k, m,
                               static_cast<uint8_t*>(keep), s);
  });
}

// Each launch alone, with the same arguments, for timing them apart.
int yunet_nms_mask(const void* boxes, const void* counts, int batch, int k,
                   float iou_thr, void* mask, int device, void* stream) {
  if (k < 1 || k > kMaxK || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    return launch_mask(boxes, static_cast<const int*>(counts), batch, k,
                       iou_thr, static_cast<uint32_t*>(mask),
                       static_cast<cudaStream_t>(stream));
  });
}

int yunet_nms_scan(const void* counts, int batch, int k, const void* mask,
                   void* keep, int device, void* stream) {
  if (k < 1 || k > kMaxK || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    return launch_scan(static_cast<const int*>(counts), batch, k,
                       static_cast<const uint32_t*>(mask),
                       static_cast<uint8_t*>(keep),
                       static_cast<cudaStream_t>(stream));
  });
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
