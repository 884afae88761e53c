// Streaming SimOTA reductions: the per-prior candidate mask and argmin-cost
// GT, and the per-GT top-k smallest costs and top-k largest IoUs, without
// the (P, G) cost matrix ever reaching device memory.
//
// Replaces the TPU kernels yunet_tpu/ops/simota_pallas.py:_kernel_folded
// (line 233, the shipped one) and :_kernel (line 118, the same outputs on a
// 4-D grid). Semantics follow simota_pallas.py:102-349 and the dense
// formulation ops/assign.py:sim_ota_assign expression for expression:
//
//   in_gts[p,g]  = min(px-x1, py-y1, x2-px, y2-py) > 0, and g valid
//   in_cts[p,g]  = the same against the centre box cx -+ 2.5*sx, and g valid
//   valid[p]     = any_g (in_gts | in_cts)
//   iou[p,g]     = pairwise_iou(decoded[p], gt[g]) (floor 1e-6), zeroed
//                  unless valid[p] and g valid
//   cost[p,g]    = (cls_w * BCE(sqrt(clip(s,0,1)), onehot[g])
//                   + iou_w * -log(iou + eps)) + INF * !(in_gts & in_cts);
//                  BIG where !valid[p] or g invalid
//   best_gt[p]   = argmin_g cost over ALL G columns, ties to the lower g
//   cand_idx[g]  = the k smallest costs in ascending (value, prior index)
//   topk_iou[g]  = the k largest IoUs, descending
//
// An invalid GT slot gets cand_idx = 0..k-1 and topk_iou = 0: exactly what
// the dense plain version yields for a column that is BIG everywhere. Its
// dynamic_k is 0, so the value never reaches an assignment.
//
// What bounds it on the H100: at the training shapes (B=16, P=8400, G=128
// slots, a few to 40 real faces an image) the inputs are ~2.9 MB and the
// work ~45 f32 operations per live (prior, valid GT) pair, so the card
// could finish in a few microseconds; the kernel is bound by latency (two
// dependent launches, k rounds of block-wide merges). The design keeps it
// simple and exact:
//   (a) valid_best: one thread per (image, prior); the image's GT rows sit
//       in shared memory; two loops over the G slots (mask, then argmin).
//   (b) topk: one block per (image, GT slot); a dead slot writes its
//       defined value and returns. Each thread strides over the priors in
//       ascending order and keeps a private sorted top-16 of (cost, index)
//       and of IoU in registers; then k rounds of a block-wide argmin of
//       the threads' heads (lexicographic on (value, index)) and k rounds
//       of a max pop the block's top-k. Only the (P, G) pair values that a
//       block needs are ever computed, and none is stored.
// Work scales with the real faces: dead GT blocks return at once, and (a)
// skips dead slots.
//
// Where it can go wrong, and what the code does:
//   * Ties are common (every invalid prior costs exactly BIG; out-of-centre
//     priors can tie on IoU): both reductions break ties to the lower prior
//     and the lower GT index, as the dense version's stable sort/argmin.
//   * dynamic_k = int(sum of topk_iou) can cross an integer on one ulp, so
//     every IoU must round as the plain version's separate torch ops do:
//     each multiply, add, subtract and divide is spelled out with the _rn
//     intrinsics, and the file is built with -fmad=false.
//   * logf, log1pf and sqrtf are CUDA's libdevice functions, the ones that
//     PyTorch's CUDA log/log1p/sqrt call; no __logf, no fast math (IEEE
//     division and sqrt are nvcc's defaults).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;
constexpr float kInf = 100000.0f;  // candidate outside box & centre
constexpr float kBig = 1e9f;       // invalid prior or padded GT

struct GtRow {
  float x1, y1, x2, y2, y;
  int valid;
};

struct Params {
  float center_radius, iou_weight, cls_weight, eps;
};

__device__ __forceinline__ float clip0(float v) { return fmaxf(v, 0.f); }

// in_gts / in_cts of prior (px, py, sx, sy) against one GT row
__device__ __forceinline__ void pair_masks(float px, float py, float sx,
                                           float sy, const GtRow& g,
                                           float r, bool* in_gts,
                                           bool* in_cts) {
  *in_gts = fminf(fminf(__fsub_rn(px, g.x1), __fsub_rn(py, g.y1)),
                  fminf(__fsub_rn(g.x2, px), __fsub_rn(g.y2, py))) > 0.f;
  const float cx = __fmul_rn(__fadd_rn(g.x1, g.x2), 0.5f);
  const float cy = __fmul_rn(__fadd_rn(g.y1, g.y2), 0.5f);
  const float rx = __fmul_rn(r, sx);
  const float ry = __fmul_rn(r, sy);
  *in_cts = fminf(fminf(__fsub_rn(px, __fsub_rn(cx, rx)),
                        __fsub_rn(py, __fsub_rn(cy, ry))),
                  fminf(__fsub_rn(__fadd_rn(cx, rx), px),
                        __fsub_rn(__fadd_rn(cy, ry), py))) > 0.f;
}

// pairwise_iou's expression: inter / max(area_d + area_g - inter, 1e-6)
__device__ __forceinline__ float pair_iou(float4 d, const GtRow& g) {
  const float iw = clip0(__fsub_rn(fminf(d.z, g.x2), fmaxf(d.x, g.x1)));
  const float ih = clip0(__fsub_rn(fminf(d.w, g.y2), fmaxf(d.y, g.y1)));
  const float inter = __fmul_rn(iw, ih);
  const float area_d = __fmul_rn(clip0(__fsub_rn(d.z, d.x)),
                                 clip0(__fsub_rn(d.w, d.y)));
  const float area_g = __fmul_rn(clip0(__fsub_rn(g.x2, g.x1)),
                                 clip0(__fsub_rn(g.y2, g.y1)));
  return __fdiv_rn(inter,
                   fmaxf(__fsub_rn(__fadd_rn(area_d, area_g), inter), 1e-6f));
}

// cost of a valid prior against a valid GT; iou already zeroed if needed
__device__ __forceinline__ float pair_cost(float s, float iou, bool in_both,
                                           const GtRow& g, const Params& k) {
  const float log_p = fmaxf(logf(s), -100.f);
  const float log_1mp = fmaxf(log1pf(-s), -100.f);
  const float cls = -__fadd_rn(__fmul_rn(g.y, log_p),
                               __fmul_rn(__fsub_rn(1.f, g.y), log_1mp));
  const float iou_cost = -logf(__fadd_rn(iou, k.eps));
  const float c = __fadd_rn(__fmul_rn(k.cls_weight, cls),
                            __fmul_rn(k.iou_weight, iou_cost));
  return __fadd_rn(c, in_both ? 0.f : kInf);
}

__device__ __forceinline__ float fused_score(const float* scores, size_t i) {
  return sqrtf(fminf(fmaxf(scores[i], 0.f), 1.f));
}

__device__ void load_gt_rows(GtRow* rows, const float4* gt_boxes,
                             const float* gt_onehot,
                             const uint8_t* gt_valid, int b, int g_n) {
  for (int g = threadIdx.x; g < g_n; g += blockDim.x) {
    const size_t i = static_cast<size_t>(b) * g_n + g;
    const float4 bx = gt_boxes[i];
    rows[g] = GtRow{bx.x, bx.y, bx.z, bx.w, gt_onehot[i],
                    gt_valid[i] ? 1 : 0};
  }
}

// (a) grid (ceil(P / kThreads), B): valid_prior and best_gt per prior
__global__ void __launch_bounds__(kThreads)
valid_best_kernel(const float* __restrict__ scores,
                  const float4* __restrict__ priors,
                  const float4* __restrict__ decoded,
                  const float4* __restrict__ gt_boxes,
                  const float* __restrict__ gt_onehot,
                  const uint8_t* __restrict__ gt_valid, int p_n, int g_n,
                  Params prm, uint8_t* __restrict__ valid_out,
                  int* __restrict__ best_out) {
  extern __shared__ GtRow rows[];
  const int b = blockIdx.y;
  load_gt_rows(rows, gt_boxes, gt_onehot, gt_valid, b, g_n);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_n) return;
  const float4 pr = priors[p];
  const size_t bp = static_cast<size_t>(b) * p_n + p;

  bool valid = false;
  for (int g = 0; g < g_n && !valid; ++g) {
    if (!rows[g].valid) continue;
    bool in_gts, in_cts;
    pair_masks(pr.x, pr.y, pr.z, pr.w, rows[g], prm.center_radius, &in_gts,
               &in_cts);
    valid = in_gts || in_cts;
  }

  int best = 0;
  if (valid) {  // an invalid prior costs BIG in every column: argmin is 0
    const float4 d = decoded[bp];
    const float s = fused_score(scores, bp);
    float best_v = 0.f;
    for (int g = 0; g < g_n; ++g) {
      float c = kBig;
      if (rows[g].valid) {
        bool in_gts, in_cts;
        pair_masks(pr.x, pr.y, pr.z, pr.w, rows[g], prm.center_radius,
                   &in_gts, &in_cts);
        c = pair_cost(s, pair_iou(d, rows[g]), in_gts && in_cts, rows[g],
                      prm);
      }
      if (g == 0 || c < best_v) {
        best_v = c;
        best = g;
      }
    }
  }
  valid_out[bp] = valid ? 1 : 0;
  best_out[bp] = best;
}

// insert (v, i) into an ascending list, after any equal values (the
// caller visits priors in ascending index, so equal values keep the lower
// index first)
__device__ __forceinline__ void insert_min(float (&lv)[kMaxK],
                                           int (&li)[kMaxK], float v, int i) {
#pragma unroll
  for (int j = kMaxK - 1; j > 0; --j) {
    if (v < lv[j - 1]) {
      lv[j] = lv[j - 1];
      li[j] = li[j - 1];
    } else if (v < lv[j]) {
      lv[j] = v;
      li[j] = i;
    }
  }
  if (v < lv[0]) {
    lv[0] = v;
    li[0] = i;
  }
}

__device__ __forceinline__ void insert_max(float (&lv)[kMaxK], float v) {
#pragma unroll
  for (int j = kMaxK - 1; j > 0; --j) {
    if (v > lv[j - 1]) lv[j] = lv[j - 1];
    else if (v > lv[j]) lv[j] = v;
  }
  if (v > lv[0]) lv[0] = v;
}

// (value, index) lexicographic "a before b" for the ascending merge
__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// block-wide argmin of (v, i) pairs; every thread gets the winner
__device__ void block_lex_min(float v, int i, float* sv, int* si,
                              float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sv[0];
    int bi = si[0];
    for (int w = 1; w < kThreads / 32; ++w)
      if (lex_less(sv[w], si[w], bv, bi)) {
        bv = sv[w];
        bi = si[w];
      }
    sv[kThreads / 32] = bv;
    si[kThreads / 32] = bi;
  }
  __syncthreads();
  *out_v = sv[kThreads / 32];
  *out_i = si[kThreads / 32];
  __syncthreads();
}

// (b) grid (G, B), kThreads threads: per-GT top-k cost indices and IoUs
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ scores,
            const float4* __restrict__ priors,
            const float4* __restrict__ decoded,
            const float4* __restrict__ gt_boxes,
            const float* __restrict__ gt_onehot,
            const uint8_t* __restrict__ gt_valid,
            const uint8_t* __restrict__ valid_prior, int p_n, int g_n, int k,
            Params prm, int* __restrict__ cand_out,
            float* __restrict__ iou_out) {
  __shared__ float sv[kThreads / 32 + 1];
  __shared__ int si[kThreads / 32 + 1];
  const int g = blockIdx.x, b = blockIdx.y;
  const size_t bg = static_cast<size_t>(b) * g_n + g;
  int* cand = cand_out + bg * k;
  float* topi = iou_out + bg * k;
  if (!gt_valid[bg]) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      cand[j] = j;
      topi[j] = 0.f;
    }
    return;
  }
  const float4 bx = gt_boxes[bg];
  const GtRow row{bx.x, bx.y, bx.z, bx.w, gt_onehot[bg], 1};

  float cv[kMaxK], iv[kMaxK];
  int ci[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    cv[j] = INFINITY;
    ci[j] = 0x7fffffff;
    iv[j] = -INFINITY;
  }
  for (int p = threadIdx.x; p < p_n; p += blockDim.x) {
    const size_t bp = static_cast<size_t>(b) * p_n + p;
    float c = kBig, iou = 0.f;
    if (valid_prior[bp]) {
      const float4 pr = priors[p];
      bool in_gts, in_cts;
      pair_masks(pr.x, pr.y, pr.z, pr.w, row, prm.center_radius, &in_gts,
                 &in_cts);
      iou = pair_iou(decoded[bp], row);
      c = pair_cost(fused_score(scores, bp), iou, in_gts && in_cts, row,
                    prm);
    }
    if (c < cv[kMaxK - 1]) insert_min(cv, ci, c, p);
    if (iou > iv[kMaxK - 1]) insert_max(iv, iou);
  }

  // k rounds: the block's smallest head wins and its owner pops it. The
  // prior index names the owner: thread t holds only priors p = t mod
  // blockDim.
  for (int r = 0; r < k; ++r) {
    float wv;
    int wi;
    block_lex_min(cv[0], ci[0], sv, si, &wv, &wi);
    if (threadIdx.x == 0) cand[r] = wi;
    if (wi == ci[0] && wv == cv[0]) {
#pragma unroll
      for (int j = 0; j < kMaxK - 1; ++j) {
        cv[j] = cv[j + 1];
        ci[j] = ci[j + 1];
      }
      cv[kMaxK - 1] = INFINITY;
      ci[kMaxK - 1] = 0x7fffffff;
    }
  }
  // the IoU values only: ties between threads go to the lower thread
  for (int r = 0; r < k; ++r) {
    float wv;
    int wt;
    block_lex_min(-iv[0], threadIdx.x, sv, si, &wv, &wt);
    if (threadIdx.x == 0) topi[r] = -wv;
    if (wt == threadIdx.x) {
#pragma unroll
      for (int j = 0; j < kMaxK - 1; ++j) iv[j] = iv[j + 1];
      iv[kMaxK - 1] = -INFINITY;
    }
  }
}

}  // namespace

extern "C" {

int yunet_simota_max_k() { return kMaxK; }

// Shared memory launch (a) needs for g_n GT slots.
size_t yunet_simota_smem_bytes(int g_n) {
  return static_cast<size_t>(g_n) * sizeof(GtRow);
}

// scores (B, P) f32; priors (P, 4) f32; decoded (B, P, 4) f32; gt_boxes
// (B, G, 4) f32; gt_onehot (B, G) f32; gt_valid (B, G) u8. Outputs:
// valid_prior (B, P) u8, best_gt (B, P) i32. Device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch.
int yunet_simota_valid_best(const void* scores, const void* priors,
                            const void* decoded, const void* gt_boxes,
                            const void* gt_onehot, const void* gt_valid,
                            int batch, int p_n, int g_n, float center_radius,
                            float iou_weight, float cls_weight, float eps,
                            void* valid_prior, void* best_gt, void* stream) {
  const Params prm{center_radius, iou_weight, cls_weight, eps};
  const dim3 grid((p_n + kThreads - 1) / kThreads, batch);
  valid_best_kernel<<<grid, kThreads, yunet_simota_smem_bytes(g_n),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float4*>(priors),
      static_cast<const float4*>(decoded),
      static_cast<const float4*>(gt_boxes),
      static_cast<const float*>(gt_onehot),
      static_cast<const uint8_t*>(gt_valid), p_n, g_n, prm,
      static_cast<uint8_t*>(valid_prior), static_cast<int*>(best_gt));
  return static_cast<int>(cudaGetLastError());
}

// The same inputs plus valid_prior from yunet_simota_valid_best. Outputs:
// cand_idx (B, G, k) i32, topk_iou (B, G, k) f32; 1 <= k <= 16.
int yunet_simota_topk(const void* scores, const void* priors,
                      const void* decoded, const void* gt_boxes,
                      const void* gt_onehot, const void* gt_valid,
                      const void* valid_prior, int batch, int p_n, int g_n,
                      int k, float center_radius, float iou_weight,
                      float cls_weight, float eps, void* cand_idx,
                      void* topk_iou, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{center_radius, iou_weight, cls_weight, eps};
  const dim3 grid(g_n, batch);
  topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float4*>(priors),
      static_cast<const float4*>(decoded),
      static_cast<const float4*>(gt_boxes),
      static_cast<const float*>(gt_onehot),
      static_cast<const uint8_t*>(gt_valid),
      static_cast<const uint8_t*>(valid_prior), p_n, g_n, k, prm,
      static_cast<int*>(cand_idx), static_cast<float*>(topk_iou));
  return static_cast<int>(cudaGetLastError());
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
