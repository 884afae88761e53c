// SCRFD's and RetinaFace's folded convolutions: a forward conv on NHWC bf16
// (implicit GEMM, f32 accumulation) whose epilogue adds the bias, an
// optional shortcut and an optional ReLU (or the ReLU, then the shortcut)
// before the one rounding to bf16, into a whole map or a slice of a wider
// one.
//
// Replaces no TPU kernel: neither model has a counterpart in the JAX
// package. It was added to take the passes that ran around the library's
// convs out of the detect program: PyTorch's bias add after each conv, the
// ReLUs, the shortcut and FPN adds, the FPN's nearest 2x upsample, and
// cuDNN's channel padding kernels for the 3- and 28-channel inputs and the
// 2- and 20-channel outputs (about 130 kernels a 640x640 SCRFD detect);
// for RetinaFace also the SSH's concatenation (each branch's last conv
// writes its channels of the level's map, relu(cat) = cat(relu)) and the
// heads' concatenation over levels (each level's merged head writes its
// run of rows).
//
// What bounds it on the H100: at batch 1 SCRFD's convs are small (the
// largest is 1.45 GMAC), so latency, not bytes or the tensor cores: the
// least time is yardstick/scrfd.py:conv_bound_ms taken conv by conv (39.07
// us for the 58 convs at 640x640: bf16 activations read and written once,
// weights read once, 2 x the multiply-adds at 989 TFLOP/s). So the design
// keeps each conv to one kernel, few round trips to device memory, little
// address arithmetic (no division in a loop), and enough warps in flight.
// RetinaFace-R50's 76 folded convs (44.3 GMAC, channels to 2048, K to
// 2304) have a bound of 157.4 us (yardstick/retinaface.py), 88.5 GFLOP of
// it compute: big enough that the tensor cores' use decides, and there
// the kernel's 32-pixel warp tiles on mma.sync m16n8k16 (an ldmatrix for
// every two MMAs at 32 channels a block column) reach 20-170 TFLOP/s a
// conv, 57 overall.
//
// GEMM view: M = output pixels, N = Cout, K = ks * ks * cp, tap-major, cp
// = Cin rounded up to a multiple of 8. The weights come packed once at the
// fold as (Cout, K) bf16 rows, each tap's channels zero-padded to cp
// (ops/conv_epi.py:pack_weights).
//   A block owns an output tile of th x tw pixels of one image (32 * wm
// pixels, tw 8 or 16) by 8 * NT output channels (NT n8 tiles, a template
// argument, one instantiation each). It walks the input channels in chunks
// of kc (16, 32 or 64): a chunk stages the tile's input halo, ((th - 1) *
// stride + ks) x ((tw - 1) * stride + ks) pixels by kc channels, once, and
// the chunk's weights for every tap, then runs all ks * ks taps from shared
// memory: ldmatrix takes a row address from each lane, so a tap's A
// fragment is the halo rows under its 16 output pixels, shifted by (ky,
// kx). An input element is read from device memory once a chunk, not once
// a tap. Chunks arrive by cp.async (the halo in 16- or 8-byte pieces where
// Cin is a multiple of 8 or 4, pieces built from element loads for the
// 3-channel input) into a ring that holds every chunk where shared memory
// allows, so one round trip to device memory serves them all (else two
// stages: chunk c + 1 loads while chunk c multiplies). Halo pixels outside
// the image and channels past Cin read as zero: no padding kernel runs.
//   Warp (i, j) of the block's wm x wk multiplies pixels 32i .. 32i + 31
// of the tile (two m16 tiles) over the chunk's (tap, k16 step) units u = j,
// j + wk, ... (mma.sync m16n8k16, bf16 in, f32 accumulate; shared-memory
// rows padded by 8 elements, which keeps ldmatrix free of bank conflicts at
// stride 1). With wk > 1 every warp's partial sums go to shared memory and
// the block's threads share out the sums and the epilogue: small maps get
// more warps without a second kernel.
//   Epilogue: + bias (f32), + the shortcut (bf16, at the output's
// resolution or, with up = 2, at half of it, read at (y / 2, x / 2): the
// FPN's nearest 2x upsample), then ReLU if set (with post set, the ReLU
// first and the shortcut after it: RetinaFace's FPN laterals); rounded
// once to bf16 into an output tile in shared memory, which goes to device
// memory in pieces of 16 bytes where Cout and the output's pixel pitch ldc
// are multiples of 8 (8, 4 or 2 where they are not), pixel (b, y, x) at b
// * img + (y * wo + x) * ldc: a whole map, a channel slice of a wider one,
// or a run of pixels of a longer one. The shortcut after the ReLU and the
// pitched store are a template argument (WIDE): with them as run-time
// branches SCRFD's 58 convs took 0.0145 ms (2.3%) longer graphed.
// The bias, the shortcut (staged into the output tile) and the weights of
// the first chunks are requested before the halo's pixel table is built,
// so their latency overlaps it. The library route rounds the conv, the
// bias add and the shortcut add each to bf16.
//   Launches on the caller's stream and allocates nothing, so it can be
// captured into a CUDA graph. Each launch is a programmatic dependent of
// the kernel before it (cudaLaunchKernelEx with programmatic stream
// serialization): a block requests the bias and weights and builds its
// pixel table before it waits (griddepcontrol.wait) for the grids before
// it to finish and reads their outputs, and lets the next grid launch
// once its multiply-adds are done. So in a graph of convs the next conv's
// launch and set-up overlap this one's epilogue, and a trace's intervals
// of consecutive convs overlap by that much.
//
// As built, on an H100 (700 W; PERF.md), the 58 convs of a 640x640 SCRFD
// detect take 0.63 ms replayed as one CUDA graph (0.69-0.71 ms launched
// without the dependency), against 0.95-0.99 ms for the library route
// (cuDNN's convs and cuBLAS's 1x1 GEMMs with PyTorch's bias, shortcut,
// upsample and ReLU passes), 16x their bound. What is left is latency a
// block: the first round trip to device memory, the multiply (smem-bound
// in ldmatrix at these warp tiles), the epilogue. RetinaFace-R50's 76
// take 1.55 ms at 640x640 and 1.41 ms at 480x640 (10x and 12x their
// bound) with each shape's tile timed at its first call
// (ops/conv_epi.py:_pick_tile), against 1.42 and 1.28 ms for the library
// route: the 7x7/2 stem alone ~98 us (3 channels padded to 16 a tap), and
// the 1x1 convs at 13-70 TFLOP/s. The tiles matter there: a rule fitted
// at 640x640 took 1.71 ms at 480x640.
// Tried and not kept: an implicit GEMM that gathered every tap's pixels
// from device memory (1.2-1.3 ms for the 58: the address arithmetic and
// the 9x reads), and the same halo design on wgmma (m64nNk16, operands
// from shared memory in unswizzled core matrices; 0.82 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowPad = 8;        // elements after each shared-memory row
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 200 * 1024;
// the ring holds every chunk of a conv (at most kMaxStages) where this
// much shared memory allows (two blocks an SM), else fewer, down to two
constexpr size_t kStageBudget = 110 * 1024;
constexpr int kMaxStages = 8;

struct Conv {
  const bf16* x;       // (n, h, w, cin)
  const bf16* wp;      // (cout, kdim), packed
  const float* bias;   // (cout)
  const bf16* res;     // (n, ho / up, wo / up, cout) or null
  bf16* out;           // (n, ho, wo, cout), or see img and ldc
  int h, w, cin, cp, ks, stride, pad, ho, wo, cout, kdim, up, relu;
  int tw_shift, th, tiles_x, tiles_y;  // the output tile: th x (1 << tw_shift)
  int hr, hc;                          // its input halo: hr x hc pixels
  int wm, wk, kc, vw, g_shift, g_shift8, chunks, stages;
  int res_staged;                      // the shortcut read through smem
  // a wide launch's: the shortcut added after the ReLU, not before; the
  // output's pixel pitch and image pitch, in elements (pixel (b, y, x) at
  // out + b * img + (y * wo + x) * ldc)
  int post, ldc;
  long long img;
};

// A launch is wide where it adds its shortcut after the ReLU or writes
// into a view of a wider map; every other launch (all of SCRFD's) runs the
// kernel's narrow instantiation, whose epilogue and store are the ones it
// had before the wide launches came.
bool wide(const Conv& p) {
  return p.post || p.ldc != p.cout ||
         p.img != static_cast<long long>(p.ho) * p.wo * p.cout;
}

// A block's shared memory, in bytes: the halo's pixel table, the bias,
// the output tile (which holds the shortcut first, where it is staged),
// then the ring of chunk stages (halo and weights); the k-groups' partial
// sums reuse the ring.
__host__ __device__ size_t table_bytes(const Conv& p) {
  return (static_cast<size_t>(p.hr) * p.hc * sizeof(int) + 15) / 16 * 16;
}
// The output tile's row: 8 nt channels and 8 (nt even) or 16 (nt odd) more,
// so that a row is an odd number of 16-byte units and the epilogue's
// stores of 8 rows fall in distinct banks.
__host__ __device__ int tile_row(int nt) {
  return 8 * nt + (nt & 1 ? 16 : 8);
}
__host__ __device__ size_t tile_bytes(const Conv& p, int nt) {
  return 32 * p.wm * tile_row(nt) * sizeof(bf16);
}
__host__ __device__ size_t stage_bytes(const Conv& p, int nt) {
  return (static_cast<size_t>(p.hr) * p.hc * (p.kc + kRowPad) +
          8 * nt * static_cast<size_t>(p.ks * p.ks * p.kc + kRowPad)) *
         sizeof(bf16);
}
__host__ __device__ size_t smem_bytes(const Conv& p, int nt) {
  const size_t ring = p.stages * stage_bytes(p, nt);
  const size_t red = static_cast<size_t>(p.wk > 1 ? p.wk : 0) * p.wm * 32 *
                     (2 * nt * 4) * sizeof(float);
  return table_bytes(p) + 8 * nt * sizeof(float) + tile_bytes(p, nt) +
         (ring > red ? ring : red);
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

// two 8x8 bf16 matrices (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// 16 (or 8) bytes from global to shared memory, or zeros if !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(bf16* dst, const bf16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 .. kMaxStages - 1) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Programmatic dependent launch: let the grid after this one on the
// stream be launched once every block of this one has run this; wait
// until the grids before this one have finished and their writes are
// visible. Where the launch had no such dependency, both do nothing.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A thread's walk over the (row, piece) grid of a tile whose rows hold
// `per_row` pieces: it starts at piece tid and steps by nthreads, with no
// division after the first.
struct Walk {
  int row, col, drow, dcol, per_row;
  __device__ __forceinline__ Walk(int tid, int nthreads, int per_row_)
      : row(tid / per_row_),
        col(tid - tid / per_row_ * per_row_),
        drow(nthreads / per_row_),
        dcol(nthreads - nthreads / per_row_ * per_row_),
        per_row(per_row_) {}
  __device__ __forceinline__ void step() {
    row += drow;
    col += dcol;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
};

// Stage the weights of input channel chunk cc for every tap and the
// block's 8 * NT output channels: (n, tap, 8 channels) pieces of 16 bytes,
// a row of ks * ks * kc / 8 pieces an output channel.
template <int NT>
__device__ __forceinline__ void load_weights(const Conv& p, bf16* wts, int cc,
                                             int n0, Walk w) {
  const int c0 = cc * p.kc, ldw = p.ks * p.ks * p.kc + kRowPad;
  const int tshift = p.g_shift8, gmask = (1 << tshift) - 1;
  for (; w.row < 8 * NT; w.step()) {
    const int t = w.col >> tshift, g = (w.col & gmask) * 8;
    const int n = n0 + w.row, c = c0 + g;
    const bool ok = n < p.cout && c < p.cp;
    const bf16* src =
        ok ? p.wp + static_cast<long long>(n) * p.kdim + t * p.cp + c : p.wp;
    cp_async16(wts + w.row * ldw + t * p.kc + g, src, ok);
  }
}

// Stage the halo of input channel chunk cc: pix[i] is the input pixel
// under halo pixel i, or -1 outside the image.
__device__ __forceinline__ void load_halo(const Conv& p, const int* pix,
                                          bf16* halo, int cc, int tid,
                                          int nthreads) {
  const int ldh = p.kc + kRowPad, c0 = cc * p.kc;
  if (p.vw == 1) {
    // channels that no 4-byte copy reaches (the 3-channel input): pieces
    // of 8 channels built from element loads, four pieces' loads in flight
    // before their stores
    const int pieces8 = (p.hr * p.hc) << p.g_shift8;
    const int mask8 = (1 << p.g_shift8) - 1;
    for (int i0 = tid; i0 < pieces8; i0 += 4 * nthreads) {
      __align__(16) bf16 v[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * nthreads;
        const int off = i < pieces8 ? pix[i >> p.g_shift8] : -1;
        const int c = c0 + (i & mask8) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[j][e] = off >= 0 && c + e < p.cin
                        ? p.x[static_cast<long long>(off) * p.cin + c + e]
                        : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * nthreads;
        if (i < pieces8)
          *reinterpret_cast<uint4*>(halo + (i >> p.g_shift8) * ldh +
                                    (i & mask8) * 8) =
              *reinterpret_cast<const uint4*>(v[j]);
      }
    }
    return;
  }
  const int pieces = (p.hr * p.hc) << p.g_shift;
  const int gmask = (1 << p.g_shift) - 1;
  for (int i = tid; i < pieces; i += nthreads) {
    const int px = i >> p.g_shift, g = (i & gmask) * p.vw;
    const int off = pix[px];
    const bool ok = off >= 0 && c0 + g < p.cin;
    const bf16* src =
        ok ? p.x + static_cast<long long>(off) * p.cin + c0 + g : p.x;
    if (p.vw == 8)
      cp_async16(halo + px * ldh + g, src, ok);
    else
      cp_async8(halo + px * ldh + g, src, ok);
  }
}

// Where the epilogue writes: the output tile (pixel rows of ldo channels
// from n0, holding the staged shortcut until then), the bias, and the
// tile's place in the output.
struct EpilogueTile {
  bf16* tile;
  const float* bias;
  int ldo, b, oy0, ox0, n0;
};

// Output pixel pi of the tile at channels j, j + 1 (from n0): + bias, +
// the shortcut, ReLU (or, WIDE with p.post set, + bias, ReLU, + the
// shortcut), rounded to bf16 into the tile.
template <bool WIDE>
__device__ __forceinline__ void finish_pair(const Conv& p,
                                            const EpilogueTile& et, int pi,
                                            int j, float v0, float v1) {
  v0 += et.bias[j];
  v1 += et.bias[j + 1];
  bf16* row = et.tile + pi * et.ldo;
  const bf16* res = nullptr;
  if (p.res_staged) {
    res = row;
  } else if (p.res) {
    const int oy = et.oy0 + (pi >> p.tw_shift);
    const int ox = et.ox0 + (pi & ((1 << p.tw_shift) - 1));
    if (oy < p.ho && ox < p.wo)
      res = p.res + ((static_cast<long long>(et.b) * (p.ho / p.up) +
                      oy / p.up) * (p.wo / p.up) + ox / p.up) * p.cout +
            et.n0;
  }
  if constexpr (WIDE) {
    const bool add = res && et.n0 + j < p.cout;
    float r0 = 0.f, r1 = 0.f;
    if (add) {
      r0 = __bfloat162float(res[j]);
      if (et.n0 + j + 1 < p.cout) r1 = __bfloat162float(res[j + 1]);
    }
    if (add && !p.post) {
      v0 += r0;
      v1 += r1;
    }
    if (p.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    if (add && p.post) {
      v0 += r0;
      v1 += r1;
    }
  } else {
    if (res && et.n0 + j < p.cout) {
      v0 += __bfloat162float(res[j]);
      if (et.n0 + j + 1 < p.cout) v1 += __bfloat162float(res[j + 1]);
    }
    if (p.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(v0, v1);
}

template <int NT, bool WIDE>
__global__ void __launch_bounds__(32 * kMaxWarps)
    scrfd_fprop_kernel(const Conv p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wm = p.wm, wk = p.wk;
  const int nthreads = 32 * wm * wk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % wm, warp_k = warp / wm;
  const int tw = 1 << p.tw_shift, twm = tw - 1;
  const int n0 = blockIdx.y * (8 * NT);
  const int per_image = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_image, tile = blockIdx.x - b * per_image;
  const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  const int oy0 = ty * p.th, ox0 = tx * tw;

  const int nt_total = 8 * NT;
  const int hp = p.hr * p.hc;
  const int ldh = p.kc + kRowPad, kk = p.ks * p.ks;
  const int ldw = kk * p.kc + kRowPad, ldo = tile_row(NT);
  const int halo_elems = hp * ldh, stage_elems = halo_elems + nt_total * ldw;
  int* pix = reinterpret_cast<int*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + table_bytes(p));
  bf16* tile_s = reinterpret_cast<bf16*>(bias_s + nt_total);
  bf16* ring = tile_s + 32 * wm * ldo;
  const int stages = p.stages;

  // Launched as a programmatic dependent of the kernel before it on the
  // stream: do everything that does not read the previous kernels'
  // outputs before waiting for them: the bias, the weights of the chunks
  // the ring takes ahead (both written at the fold) and the halo's pixel
  // table.
  for (int i = tid; i < nt_total; i += nthreads)
    cp_async4(bias_s + i, p.bias + n0 + i, n0 + i < p.cout);
  const Walk wts_walk(tid, nthreads, kk << p.g_shift8);
  for (int c = 0; c < stages - 1 && c < p.chunks; ++c)
    load_weights<NT>(p, ring + c * stage_elems + halo_elems, c, n0,
                     wts_walk);
  {
    const int iy0 = oy0 * p.stride - p.pad, ix0 = ox0 * p.stride - p.pad;
    for (Walk w(tid, nthreads, p.hc); w.row < p.hr; w.step()) {
      const int iy = iy0 + w.row, ix = ix0 + w.col;
      pix[w.row * p.hc + w.col] = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w
                                      ? (b * p.h + iy) * p.w + ix
                                      : -1;
    }
  }
  griddep_wait();
  // the shortcut of the tile's pixels, into the output tile, where the
  // epilogue reads it and writes the result
  if (p.res_staged) {
    const int rh = p.ho / p.up, rw = p.wo / p.up;
    for (int i = tid; i < 32 * wm * NT; i += nthreads) {
      const int pi = i / NT, j = (i - pi * NT) * 8;
      const int oy = oy0 + (pi >> p.tw_shift), ox = ox0 + (pi & twm);
      const bool ok = oy < p.ho && ox < p.wo && n0 + j < p.cout;
      const long long rq =
          (static_cast<long long>(b) * rh + oy / p.up) * rw + ox / p.up;
      cp_async16(tile_s + pi * ldo + j,
                 ok ? p.res + rq * p.cout + n0 + j : p.res, ok);
    }
  }
  __syncthreads();

  // a ring of `stages` chunks, stages - 1 loading ahead of the one being
  // multiplied (every chunk at once where the ring holds them all)
  for (int c = 0; c < stages - 1; ++c) {
    if (c < p.chunks)
      load_halo(p, pix, ring + c * stage_elems, c, tid, nthreads);
    cp_async_commit();
  }

  // this lane's A rows: the halo pixel under output pixel (lane & 15) of
  // each of its m16 tiles at tap (0, 0)
  int hbase[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int pi = warp_m * 32 + mt * 16 + (lane & 15);
    const int ly = pi >> p.tw_shift, lx = pi & twm;
    hbase[mt] = ly * p.stride * p.hc + lx * p.stride;
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // warp_k's (tap, k16 step) units of a chunk: u = warp_k, warp_k + wk,
  // ...; its first, as (tap, step, ky, kx)
  const int steps = p.kc >> 4;
  const int t_first = warp_k / steps, s_first = warp_k - t_first * steps;
  const int ky_first = t_first / p.ks, kx_first = t_first - ky_first * p.ks;
  for (int cc = 0; cc < p.chunks; ++cc) {
    const int next = cc + stages - 1;
    if (next < p.chunks) {
      bf16* st = ring + (next % stages) * stage_elems;
      load_weights<NT>(p, st + halo_elems, next, n0, wts_walk);
      load_halo(p, pix, st, next, tid, nthreads);
    }
    cp_async_commit();
    cp_async_wait_n(stages - 1);
    __syncthreads();
    const bf16* hs = ring + (cc % stages) * stage_elems;
    const bf16* ws = hs + halo_elems;
    int t = t_first, step = s_first, ky = ky_first, kx = kx_first;
    for (; t < kk;) {
      const int k16 = step * 16, shift = ky * p.hc + kx;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], hs + (hbase[mt] + shift) * ldh + k16 +
                           (lane >> 4) * 8);
      const bf16* wt = ws + t * p.kc + k16 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, wt + ((nt + (lane >> 4)) * 8 + (lane & 7)) * ldw);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], bb[0], bb[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], bb[2], bb[3]);
        }
      }
      if (NT & 1) {
        uint32_t bb[2];
        ldsm_x2(bb, wt + ((NT - 1) * 8 + (lane & 7)) * ldw);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][NT - 1], a[mt], bb[0], bb[1]);
      }
      for (step += wk; step >= steps; step -= steps) {
        ++t;
        if (++kx == p.ks) {
          kx = 0;
          ++ky;
        }
      }
    }
    __syncthreads();
  }

  // the multiply-adds are done: let the next conv launch and start its
  // set-up while this one's epilogue runs (at the kernel's start it would
  // sit resident in griddepcontrol.wait; the convs then take 2% less time,
  // but a trace's conv intervals overlap twice as much)
  griddep_launch_dependents();

  // epilogue, into the output tile (where a staged shortcut waits): +
  // bias, + shortcut, ReLU, rounded once to bf16. Thread (g, t4) of a warp
  // holds rows g and g + 8 of each m16 tile at channels 2 t4, 2 t4 + 1 of
  // each n8 tile. With wk > 1 every warp's partial sums go to shared memory
  // (the ring is free) and the block's threads share out their sums.
  constexpr int kRegs = 2 * NT * 4;
  const EpilogueTile et{tile_s, bias_s, ldo, b, oy0, ox0, n0};
  if (wk == 1) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          finish_pair<WIDE>(p, et, warp_m * 32 + mt * 16 + half * 8 + g,
                      nt * 8 + 2 * t4, acc[mt][nt][half * 2],
                      acc[mt][nt][half * 2 + 1]);
  } else {
    float* red = reinterpret_cast<float*>(ring);
    float* dst = red + (warp_k * wm + warp_m) * kRegs * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[((mt * NT + nt) * 4 + q) * 32] = acc[mt][nt][q];
    __syncthreads();
    // pair e: lane e % 32 of register pair r2 = (mt * NT + nt) * 2 + half
    // of warp row wi
    for (int e = tid; e < wm * (kRegs / 2) * 32; e += nthreads) {
      const int ln = e & 31, wr = e >> 5;
      const int wi = wr / (kRegs / 2), r2 = wr - wi * (kRegs / 2);
      const int mt = r2 / (2 * NT), nt = (r2 >> 1) - mt * NT, half = r2 & 1;
      const float* src =
          red + (wi * kRegs + (mt * NT + nt) * 4 + half * 2) * 32 + ln;
      float v0 = 0.f, v1 = 0.f;
      for (int k = 0; k < wk; ++k, src += wm * kRegs * 32) {
        v0 += src[0];
        v1 += src[32];
      }
      finish_pair<WIDE>(p, et, wi * 32 + mt * 16 + half * 8 + (ln >> 2),
                  nt * 8 + 2 * (ln & 3), v0, v1);
    }
  }
  __syncthreads();

  // the tile to device memory in pieces of pw channels (16 bytes where
  // Cout and the pixel pitch allow): a warp's pieces are consecutive in
  // memory along a pixel row, and so are a tile row's pixels where one
  // block column holds Cout and the output is a whole map
  const int cw = min(nt_total, p.cout - n0);
  const int cl = WIDE ? p.cout | p.ldc : p.cout;
  const int pw = cl % 8 == 0 ? 8 : cl % 4 == 0 ? 4 : cl % 2 == 0 ? 2 : 1;
  for (Walk w(tid, nthreads, cw / pw); w.row < 32 * wm; w.step()) {
    const int pi = w.row, j = w.col * pw;
    const int oy = oy0 + (pi >> p.tw_shift), ox = ox0 + (pi & twm);
    if (oy >= p.ho || ox >= p.wo) continue;
    const bf16* src = tile_s + pi * ldo + j;
    bf16* dst =
        WIDE ? p.out + b * p.img +
                   static_cast<long long>(oy * p.wo + ox) * p.ldc + n0 + j
             : p.out + ((static_cast<long long>(b) * p.ho + oy) * p.wo + ox) *
                           p.cout + n0 + j;
    if (pw == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (pw == 4)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (pw == 2)
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
    else
      *dst = *src;
  }
}

template <int NT, bool WIDE>
int launch_kernel(const Conv& p, size_t smem, int blocks,
                  cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scrfd_fprop_kernel<NT, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  // a programmatic dependent of the kernel before it on the stream (the
  // kernel waits for it before reading what it wrote): in a CUDA graph the
  // next conv's launch and set-up overlap this one's tail
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, (p.cout + 8 * NT - 1) / (8 * NT));
  config.blockDim = dim3(32 * p.wm * p.wk);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attribute;
  config.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&config, scrfd_fprop_kernel<NT, WIDE>, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int NT>
int launch(const Conv& p, size_t smem, int blocks, cudaStream_t stream) {
  return wide(p) ? launch_kernel<NT, true>(p, smem, blocks, stream)
                 : launch_kernel<NT, false>(p, smem, blocks, stream);
}

int multiprocessors() {
  static int count = 0;
  if (count == 0) {
    int device = 0, v = 0;
    if (cudaGetDevice(&device) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) ==
            cudaSuccess)
      count = v;
  }
  return count > 0 ? count : 132;
}

bool nt_ok(int nt) {
  return nt == 1 || nt == 3 || nt == 4 || nt == 7 || nt == 8 || nt == 10 ||
         nt == 11 || nt == 14 || nt == 16;
}

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

// The launch's Conv from the C arguments, or false where the kernel does
// not take them.
bool make_conv(Conv& p, int n, int h, int w, int cin, int ks, int stride,
               int ho, int wo, int cout, int up, int relu, bool res, int post,
               int ldc, long long img, int nt, int wm, int wk, int tw,
               int kc) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || ks < 1 ||
      ks % 2 == 0 || stride < 1 || ho < 1 || wo < 1 || up < 1 ||
      ho % up != 0 || wo % up != 0 || (post && !res) || ldc < cout ||
      img < static_cast<long long>(ho) * wo * ldc || !nt_ok(nt) ||
      (wm != 1 && wm != 2 && wm != 4 && wm != 8) ||
      (wk != 1 && wk != 2 && wk != 4 && wk != 8) || wm * wk > kMaxWarps ||
      (tw != 8 && tw != 16) || 32 * wm % tw != 0 ||
      (kc != 16 && kc != 32 && kc != 64))
    return false;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cp = (cin + 7) / 8 * 8;
  p.ks = ks;
  p.stride = stride;
  p.pad = ks / 2;
  p.ho = ho;
  p.wo = wo;
  p.cout = cout;
  p.kdim = ks * ks * p.cp;
  p.up = up;
  p.relu = relu;
  p.post = post;
  p.ldc = ldc;
  p.img = img;
  p.tw_shift = log2_exact(tw);
  p.th = 32 * wm / tw;
  p.tiles_x = (wo + tw - 1) / tw;
  p.tiles_y = (ho + p.th - 1) / p.th;
  p.hr = (p.th - 1) * stride + ks;
  p.hc = (tw - 1) * stride + ks;
  p.wm = wm;
  p.wk = wk;
  p.kc = kc;
  p.vw = cin % 8 == 0 ? 8 : cin % 4 == 0 ? 4 : 1;
  p.g_shift = log2_exact(kc / p.vw);
  p.g_shift8 = log2_exact(kc / 8);
  p.chunks = (p.cp + kc - 1) / kc;
  p.res_staged = res && cout % 8 == 0;
  // a grid that gives each multiprocessor at most one block may take all
  // of its shared memory; a larger one keeps to the budget
  const long long blocks = static_cast<long long>(n) * p.tiles_y * p.tiles_x *
                           ((cout + 8 * nt - 1) / (8 * nt));
  const size_t budget =
      blocks <= multiprocessors() ? kMaxSmem : kStageBudget;
  p.stages = p.chunks < kMaxStages ? p.chunks : kMaxStages;
  while (p.stages > 2 && smem_bytes(p, nt) > budget) --p.stages;
  return static_cast<long long>(n) * p.tiles_y * p.tiles_x < (1LL << 31) &&
         smem_bytes(p, nt) <= kMaxSmem;
}

}  // namespace

extern "C" {

// out = [relu](conv(x, w, stride, ks / 2) + bias [+ res]), bf16 NHWC; with
// post, out = [relu](conv(x, w, stride, ks / 2) + bias) + res.
// x: (n, h, w, cin) bf16; wp: (cout, ks * ks * cp) bf16, cp = cin rounded
// up to 8, each tap's channels zero-padded; bias: (cout) f32; res: null or
// (n, ho / up, wo / up, cout) bf16, read at (y / up, x / up); out: output
// pixel (b, y, x) at out + b * img + (y * wo + x) * ldc, its cout channels
// consecutive (ldc = cout and img = ho * wo * cout for a whole map; a
// slice of a wider map's channels, or of a longer run of pixels, else),
// bf16; all 16-byte aligned. The block: 8 nt output channels, nt in {1, 3,
// 4, 7, 8, 10, 11, 14, 16}; an output tile of 32 wm pixels tw wide, tw 8
// or 16; wm x wk warps, wm, wk in {1, 2, 4, 8}, at most 8 in all; input
// channel chunks of kc in {16, 32, 64}; within 200 KB of shared memory.
// All device pointers; stream is a cudaStream_t. Returns
// cudaErrorInvalidValue for what the kernel does not take, else
// cudaGetLastError() after the launch.
int yunet_scrfd_conv_forward(const void* x, const void* wp, const void* bias,
                             const void* res, void* out, int n, int h, int w,
                             int cin, int ks, int stride, int ho, int wo,
                             int cout, int up, int relu, int post, int ldc,
                             long long img, int nt, int wm, int wk, int tw,
                             int kc, void* stream) {
  Conv p;
  if (!make_conv(p, n, h, w, cin, ks, stride, ho, wo, cout, up, relu,
                 res != nullptr, post, ldc, img, nt, wm, wk, tw, kc))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wp);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  const size_t smem = smem_bytes(p, nt);
  const int blocks = n * p.tiles_y * p.tiles_x;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1:
      return launch<1>(p, smem, blocks, s);
    case 3:
      return launch<3>(p, smem, blocks, s);
    case 4:
      return launch<4>(p, smem, blocks, s);
    case 7:
      return launch<7>(p, smem, blocks, s);
    case 8:
      return launch<8>(p, smem, blocks, s);
    case 10:
      return launch<10>(p, smem, blocks, s);
    case 11:
      return launch<11>(p, smem, blocks, s);
    case 14:
      return launch<14>(p, smem, blocks, s);
    default:
      return launch<16>(p, smem, blocks, s);
  }
}

const char* yunet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
