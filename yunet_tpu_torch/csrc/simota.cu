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
// could finish in a couple of microseconds. Measured first (PERF.md §6,
// K1): the first port took ~0.117 ms of device time a call (valid_best
// 0.046, topk 0.067) and its host about as long again to issue the call.
// Timing variants of topk showed that neither its 60 serial barriers nor
// its arithmetic set its time: keying every prior's IoU (and merging those
// lists) and a second wave of live blocks did. The design:
//   (a) valid_best, grid (ceil(P / kThreads), B), one thread a prior: the
//       image's live GT rows are compacted into shared memory in ascending
//       slot order (with the per-GT terms cx, cy and area precomputed, the
//       same roundings), so the passes touch live slots only. The clipped
//       score's sqrt and two class logs are taken once a prior, and a cost
//       only where it can win: a cost in box and centre is below the INF
//       tier (cls <= 100 and -log(iou + eps) <= 16.2 at the assigner's
//       weights; ops/simota.py checks the weights), so when a slot holds
//       the prior in box and centre only such slots are costed. A dead
//       slot costs BIG and every valid prior has a live slot below BIG, so
//       a dead slot never wins the argmin.
//   (b) topk, grid (B, G), so that the live slots, the first of each
//       image, are the first blocks: a dead slot writes its defined value
//       and returns. A live block's threads stride over the priors, loads
//       for kUnroll priors in flight at once, and keep the K smallest of
//       two kinds of one-integer key in registers (K templated: k itself):
//         cost key = monotone bits of the f32 cost << 32 | prior index,
//         IoU key  = ~(monotone bits of the f32 IoU) << 32 | prior index,
//       so the (value, index) order is one uint64 compare and the IoU's
//       descending order is an ascending one. Keys are distinct (the index
//       is in them), so any split of the priors over threads gives the
//       same K smallest. Only IoUs above 0 are keyed (the top k is padded
//       with zeros), and only the costs of priors in box and centre, which
//       hold the K smallest when there are K of them; a block that finds
//       fewer keys every prior's cost in a second pass. Each warp merges
//       its 32 lists by rounds of a shuffle min (no barrier) until K keys
//       or none are left; the 8 warp lists meet in shared memory after one
//       __syncthreads (two with the second pass), and warp 0 merges them.
// Work scales with the real faces: dead GT blocks return at once, and (a)
// never reads a dead slot's row.
//
// Where it can go wrong, and what the code does:
//   * Ties are common (every invalid prior costs exactly BIG; INF-tier
//     costs round to equal f32 values; out-of-centre priors can tie on
//     IoU): the keys break cost ties to the lower prior and the argmin
//     to the lower GT index, as the dense version's stable sort/argmin.
//     -0 and +0 map to one key, so equal values stay equal.
//   * dynamic_k = int(sum of topk_iou) can cross an integer on one ulp, so
//     every IoU must round as the plain version's separate torch ops do:
//     each multiply, add, subtract and divide is spelled out with the _rn
//     intrinsics, and the file is built with -fmad=false.
//   * logf, log1pf and sqrtf are CUDA's libdevice functions, the ones that
//     PyTorch's CUDA log/log1p/sqrt call; no __logf, no fast math (IEEE
//     division and sqrt are nvcc's defaults). Hoisting them out of the GT
//     loop changes no operand, so no result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;
constexpr int kUnroll = 2;         // priors a thread has in flight
constexpr float kInf = 100000.0f;  // candidate outside box & centre
constexpr float kBig = 1e9f;       // invalid prior or padded GT
constexpr uint64_t kNoKey = ~0ull;  // above every real key

// One live GT slot with the per-GT terms of the pair expressions (16-byte
// aligned: shared-memory rows load as 128-bit words).
struct __align__(16) GtRow {
  float x1, y1, x2, y2;   // the box
  float cx, cy, area, y;  // centre, area, the one-hot value
  int g;                  // slot index
};

// One prior's terms of the masks: its centre and its centre radius.
struct PriorPt {
  float px, py, rx, ry;
};

struct Params {
  float center_radius, iou_weight, cls_weight, eps;
};

// The clipped score's class terms, once a prior.
struct PriorLogs {
  float log_p, log_1mp;
};

__device__ __forceinline__ float clip0(float v) { return fmaxf(v, 0.f); }

__device__ __forceinline__ PriorPt prior_pt(float4 pr, float r) {
  return PriorPt{pr.x, pr.y, __fmul_rn(r, pr.z), __fmul_rn(r, pr.w)};
}

__device__ __forceinline__ GtRow make_row(float4 bx, float y, int g) {
  return GtRow{bx.x,
               bx.y,
               bx.z,
               bx.w,
               __fmul_rn(__fadd_rn(bx.x, bx.z), 0.5f),
               __fmul_rn(__fadd_rn(bx.y, bx.w), 0.5f),
               __fmul_rn(clip0(__fsub_rn(bx.z, bx.x)),
                         clip0(__fsub_rn(bx.w, bx.y))),
               y,
               g};
}

// in_gts / in_cts of a prior against one GT row. min(px - x1, py - y1,
// x2 - px, y2 - py) > 0 is px > x1 && py > y1 && x2 > px && y2 > py:
// an IEEE difference keeps the sign of the exact one, and is never 0 for
// unequal operands without flush-to-zero (nvcc's default). The same holds
// against the centre box's rounded bounds cx -+ rx. (& and not &&: no
// branches.)
__device__ __forceinline__ void pair_masks(const PriorPt& q, const GtRow& g,
                                           bool* in_gts, bool* in_cts) {
  *in_gts = (q.px > g.x1) & (q.py > g.y1) & (g.x2 > q.px) & (g.y2 > q.py);
  *in_cts = (q.px > __fsub_rn(g.cx, q.rx)) & (q.py > __fsub_rn(g.cy, q.ry)) &
            (__fadd_rn(g.cx, q.rx) > q.px) & (__fadd_rn(g.cy, q.ry) > q.py);
}

// pairwise_iou's expression: inter / max(area_d + area_g - inter, 1e-6);
// boxes that do not overlap give 0 without the division (0 / a positive
// number; a -0 there would read as +0, one key and one sum)
__device__ __forceinline__ float pair_iou(float4 d, const GtRow& g) {
  const float iw = clip0(__fsub_rn(fminf(d.z, g.x2), fmaxf(d.x, g.x1)));
  const float ih = clip0(__fsub_rn(fminf(d.w, g.y2), fmaxf(d.y, g.y1)));
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.f)) return 0.f;
  const float area_d = __fmul_rn(clip0(__fsub_rn(d.z, d.x)),
                                 clip0(__fsub_rn(d.w, d.y)));
  return __fdiv_rn(inter,
                   fmaxf(__fsub_rn(__fadd_rn(area_d, g.area), inter), 1e-6f));
}

__device__ __forceinline__ PriorLogs prior_logs(float score) {
  const float s = sqrtf(fminf(fmaxf(score, 0.f), 1.f));
  return PriorLogs{fmaxf(logf(s), -100.f), fmaxf(log1pf(-s), -100.f)};
}

// cost of a valid prior against a valid GT
__device__ __forceinline__ float pair_cost(PriorLogs l, float iou,
                                           bool in_both, const GtRow& g,
                                           const Params& k) {
  const float cls = -__fadd_rn(__fmul_rn(g.y, l.log_p),
                               __fmul_rn(__fsub_rn(1.f, g.y), l.log_1mp));
  const float iou_cost = -logf(__fadd_rn(iou, k.eps));
  const float c = __fadd_rn(__fmul_rn(k.cls_weight, cls),
                            __fmul_rn(k.iou_weight, iou_cost));
  return __fadd_rn(c, in_both ? 0.f : kInf);
}

// f32 -> uint32 with the float order (no NaN reaches it); -0 -> +0
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ uint64_t cost_key(float c, int p) {
  return (static_cast<uint64_t>(ordered_bits(c)) << 32) |
         static_cast<uint32_t>(p);
}

__device__ __forceinline__ uint64_t iou_key(float iou, int p) {
  return (static_cast<uint64_t>(~ordered_bits(iou)) << 32) |
         static_cast<uint32_t>(p);
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
  __shared__ int warp_live[kWarps];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t bp = static_cast<size_t>(b) * p_n + p;

  // compact the live slots, in ascending slot order
  int n_live = 0;
  for (int g0 = 0; g0 < g_n; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    const size_t i = static_cast<size_t>(b) * g_n + g;
    const bool live = g < g_n && gt_valid[i];
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(mask);
    __syncthreads();
    int at = n_live, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += warp_live[w];
      total += warp_live[w];
    }
    if (live)
      rows[at + __popc(mask & ((1u << lane) - 1u))] =
          make_row(gt_boxes[i], gt_onehot[i], g);
    n_live += total;
    __syncthreads();
  }

  if (p >= p_n) return;
  const PriorPt q = prior_pt(priors[p], prm.center_radius);

  // valid: in the box or centre region of a live slot; j_both: the first
  // slot whose box and centre both hold the prior
  bool valid = false;
  int j_both = n_live;
  for (int j = 0; j < n_live; ++j) {
    bool in_gts, in_cts;
    pair_masks(q, rows[j], &in_gts, &in_cts);
    valid = valid || in_gts || in_cts;
    if (in_gts && in_cts) {
      j_both = j;
      break;
    }
  }

  int best = 0;
  if (valid) {  // an invalid prior costs BIG in every column: argmin is 0
    const float4 d = decoded[bp];
    const PriorLogs l = prior_logs(scores[bp]);
    float best_v = kBig;
    // with a slot in box and centre the argmin is among those slots: their
    // costs lie below the INF tier that every other live slot's cost is in
    const bool tier = j_both < n_live;
    for (int j = tier ? j_both : 0; j < n_live; ++j) {
      bool in_gts, in_cts;
      pair_masks(q, rows[j], &in_gts, &in_cts);
      if (tier && !(in_gts && in_cts)) continue;
      const float c = pair_cost(l, pair_iou(d, rows[j]), in_gts && in_cts,
                                rows[j], prm);
      if (c < best_v) {
        best_v = c;
        best = rows[j].g;
      }
    }
  }
  valid_out[bp] = valid ? 1 : 0;
  best_out[bp] = best;
}

// insert key into the ascending list l (the caller has checked that it
// beats l[K - 1]; keys are distinct)
template <int K>
__device__ __forceinline__ void insert_key(uint64_t (&l)[K], uint64_t key) {
#pragma unroll
  for (int j = K - 1; j > 0; --j)
    l[j] = key < l[j - 1] ? l[j - 1] : (key < l[j] ? key : l[j]);
  if (key < l[0]) l[0] = key;
}

template <int K>
__device__ __forceinline__ void pop_front(uint64_t (&l)[K]) {
#pragma unroll
  for (int j = 0; j < K - 1; ++j) l[j] = l[j + 1];
  l[K - 1] = kNoKey;
}

// min over the warp's lanes, in every lane
__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The K smallest keys of the warp's 32 lists: K rounds of warp_min over
// the lists' heads; the owner of the min (keys are distinct: one lane)
// pops it. Lane r returns round r's min.
template <int K>
__device__ __forceinline__ uint64_t warp_merge(uint64_t (&l)[K], int lane) {
  uint64_t kept = kNoKey;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const uint64_t m = warp_min(l[0]);
    if (m == kNoKey) break;  // the same in every lane
    if (l[0] == m) pop_front(l);
    if (lane == r) kept = m;
  }
  return kept;
}

// Warp 0's merge of the block's kWarps sorted lists in shared memory: lane
// w < kWarps walks list w, the other lanes hold no key but take part in
// the min, which must reach lanes up to K - 1. Lane r returns the r-th
// smallest.
template <int K>
__device__ __forceinline__ uint64_t block_merge(const uint64_t (*lists)[K],
                                                int lane) {
  int at = 0;
  uint64_t head = lane < kWarps ? lists[lane][0] : kNoKey, kept = kNoKey;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const uint64_t m = warp_min(head);
    if (m == kNoKey) break;
    if (lane < kWarps && head == m)
      head = ++at < K ? lists[lane][at] : kNoKey;
    if (lane == r) kept = m;
  }
  return kept;
}

// One pass over the thread's priors (p = threadIdx.x + i * kThreads, kUnroll
// of them in flight): the cost keys of the priors in box and centre, or of
// every prior with all_costs, into ck; with kIou the keys of the IoUs above
// 0 into ik (the top k is padded with zeros, which every GT column has:
// P >= k).
template <int K, bool kIou>
__device__ __forceinline__ void scan_priors(
    bool all_costs, const GtRow& row, const Params& prm,
    const uint8_t* __restrict__ vp, const float4* __restrict__ priors,
    const float4* __restrict__ dec, const float* __restrict__ sc, int p_n,
    uint64_t (&ck)[K], uint64_t (&ik)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) ck[j] = ik[j] = kNoKey;
  for (int p0 = threadIdx.x; p0 < p_n; p0 += kThreads * kUnroll) {
    bool v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      v[u] = p < p_n && vp[p];
    }
    float4 pr[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      if (v[u]) {
        pr[u] = priors[p];
        d[u] = dec[p];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      if (p >= p_n) break;
      float c = kBig, iou = 0.f;
      bool in_both = false;
      if (v[u]) {
        bool in_gts, in_cts;
        pair_masks(prior_pt(pr[u], prm.center_radius), row, &in_gts,
                   &in_cts);
        in_both = in_gts && in_cts;
        iou = pair_iou(d[u], row);
        if (in_both || all_costs)
          c = pair_cost(prior_logs(sc[p]), iou, in_both, row, prm);
      }
      if (in_both || all_costs) {
        const uint64_t kc = cost_key(c, p);
        if (kc < ck[K - 1]) insert_key(ck, kc);
      }
      if (kIou && iou > 0.f) {
        const uint64_t ki = iou_key(iou, p);
        if (ki < ik[K - 1]) insert_key(ik, ki);
      }
    }
  }
}

// (b) grid (B, G), kThreads threads: per-GT top-k cost indices and IoUs.
// Block (b, g) is linear block g * B + b, so the live slots (the first
// ones of each image) come first and spread over the SMs, and the dead
// blocks at the end retire at once. At most 85 registers, three blocks an
// SM: the 333 live blocks of the training batch run in one wave, not two
// (80 registers and no spill at k = 10; a few bytes spill above k = 11).
template <int K>
__global__ void __launch_bounds__(kThreads, 3)
topk_kernel(const float* __restrict__ scores,
            const float4* __restrict__ priors,
            const float4* __restrict__ decoded,
            const float4* __restrict__ gt_boxes,
            const float* __restrict__ gt_onehot,
            const uint8_t* __restrict__ gt_valid,
            const uint8_t* __restrict__ valid_prior, int p_n, int g_n,
            Params prm, int* __restrict__ cand_out,
            float* __restrict__ iou_out) {
  __shared__ uint64_t warp_cost[kWarps][K], warp_iou[kWarps][K];
  __shared__ int warp_keys[kWarps];
  const int b = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bg = static_cast<size_t>(b) * g_n + g;
  int* cand = cand_out + bg * K;
  float* topi = iou_out + bg * K;
  if (!gt_valid[bg]) {
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      cand[j] = j;
      topi[j] = 0.f;
    }
    return;
  }
  const GtRow row = make_row(gt_boxes[bg], gt_onehot[bg], g);
  const uint8_t* vp = valid_prior + static_cast<size_t>(b) * p_n;
  const float* sc = scores + static_cast<size_t>(b) * p_n;
  const float4* dec = decoded + static_cast<size_t>(b) * p_n;

  // Cost keys of the priors in box and centre only: when there are at
  // least K of them they hold the K smallest costs (below the INF tier
  // that every other valid prior's cost is in, and below BIG).
  uint64_t ck[K], ik[K];
  scan_priors<K, true>(false, row, prm, vp, priors, dec, sc, p_n, ck, ik);
  uint64_t wc = warp_merge(ck, lane);
  const uint64_t wi = warp_merge(ik, lane);
  if (lane < K) {
    warp_cost[warp][lane] = wc;
    warp_iou[warp][lane] = wi;
  }
  // the warp's real cost keys, at most K: they sum to K or more over the
  // block exactly when the block has K priors in box and centre
  const int n_keys = __popc(__ballot_sync(0xffffffffu,
                                          lane < K && wc != kNoKey));
  if (lane == 0) warp_keys[warp] = n_keys;
  __syncthreads();
  int n_both = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_both += warp_keys[w];
  if (n_both < K) {
    // fewer: the INF and BIG tiers reach the top K, so key every prior's
    // cost (nothing reads warp_cost between the two barriers)
    scan_priors<K, false>(true, row, prm, vp, priors, dec, sc, p_n, ck, ik);
    wc = warp_merge(ck, lane);
    if (lane < K) warp_cost[warp][lane] = wc;
    __syncthreads();
  }
  if (warp != 0) return;
  const uint64_t kc = block_merge<K>(warp_cost, lane);
  const uint64_t ki = block_merge<K>(warp_iou, lane);
  if (lane < K) {
    cand[lane] = static_cast<int>(static_cast<uint32_t>(kc));
    topi[lane] = ki == kNoKey
                     ? 0.f
                     : from_ordered_bits(~static_cast<uint32_t>(ki >> 32));
  }
}

// topk_kernel<K> for the runtime k, K = 1..kMaxK
template <int K>
cudaError_t launch_topk(int k, dim3 grid, cudaStream_t stream,
                        const float* scores, const float4* priors,
                        const float4* decoded, const float4* gt_boxes,
                        const float* gt_onehot, const uint8_t* gt_valid,
                        const uint8_t* valid_prior, int p_n, int g_n,
                        Params prm, int* cand, float* iou) {
  if constexpr (K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (k != K)
      return launch_topk<K + 1>(k, grid, stream, scores, priors, decoded,
                                gt_boxes, gt_onehot, gt_valid, valid_prior,
                                p_n, g_n, prm, cand, iou);
    topk_kernel<K><<<grid, kThreads, 0, stream>>>(
        scores, priors, decoded, gt_boxes, gt_onehot, gt_valid, valid_prior,
        p_n, g_n, prm, cand, iou);
    return cudaGetLastError();
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
// valid_prior (B, P) u8 (0 or 1: a torch.bool tensor's storage), best_gt
// (B, P) i32. Device pointers; stream is a cudaStream_t. Returns
// cudaGetLastError() after the launch.
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
  const Params prm{center_radius, iou_weight, cls_weight, eps};
  return static_cast<int>(launch_topk<1>(
      k, dim3(batch, g_n), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(scores), static_cast<const float4*>(priors),
      static_cast<const float4*>(decoded),
      static_cast<const float4*>(gt_boxes),
      static_cast<const float*>(gt_onehot),
      static_cast<const uint8_t*>(gt_valid),
      static_cast<const uint8_t*>(valid_prior), p_n, g_n, prm,
      static_cast<int*>(cand_idx), static_cast<float*>(topk_iou)));
}

// Both launches, as streamed_simota makes them: one call from the host.
// Returns the first nonzero cudaGetLastError().
int yunet_simota(const void* scores, const void* priors, const void* decoded,
                 const void* gt_boxes, const void* gt_onehot,
                 const void* gt_valid, int batch, int p_n, int g_n, int k,
                 float center_radius, float iou_weight, float cls_weight,
                 float eps, void* valid_prior, void* best_gt, void* cand_idx,
                 void* topk_iou, void* stream) {
  const int code = yunet_simota_valid_best(
      scores, priors, decoded, gt_boxes, gt_onehot, gt_valid, batch, p_n,
      g_n, center_radius, iou_weight, cls_weight, eps, valid_prior, best_gt,
      stream);
  if (code) return code;
  return yunet_simota_topk(scores, priors, decoded, gt_boxes, gt_onehot,
                           gt_valid, valid_prior, batch, p_n, g_n, k,
                           center_radius, iou_weight, cls_weight, eps,
                           cand_idx, topk_iou, stream);
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
