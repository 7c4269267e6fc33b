// K3: the K attention-gated marker heads of the decoder, fused.
//
// Replaces the TPU kernel mipheivit_tpu/ops/seg_heads.py::_kernel, launched
// there by fused_seg_heads. Same math, per pixel p of x [B, H, W, C]
// (channels_last memory), with the psi BatchNorm folded into w1 / b1:
//
//   g1    = relu(x(p) . w1 + b1)                  [K*C2], rounded to x's dtype
//   gate  = sigmoid(g1[k*C2 .. +C2) . w2[k] + b2)  per head k, f32
//   m     = x(p) . wm                              [9K], f32, no bias
//   out_k = act(bf[k] + sum_{dy,dx} m(p+D)[t*K + k] * gate_k(p+D))
//           with D = (dy-1, dx-1), t = dy*3 + dx; rounded to x's dtype
//
// Out-of-image neighbours contribute exactly 0 because m has no bias: their
// x arrives zero-filled, and rows wholly outside the image are skipped.
//
// What bounds it on the H100. At the flagship shape (64 x 256^2 pixels,
// C = 32, K = 16, C2 = 16) the bytes are x read once and the output written
// once, 0.40 GB: 0.12 ms at 3.35 TB/s; the products (gate 32x256, psi-conv2
// 256, taps 32x144 and the 144-term stencil per pixel, 26.4 kFLOP) are 111
// GFLOP, 0.11 ms at the dense bf16 peak; the elementwise work (bias, ReLU
// and rounding of 256 gate features, K sigmoids, 9K products and sums, ~600
// f32 operations a pixel) ~0.09 ms on the CUDA cores. The three floors are
// about equal, and they overlap only where loads, products and elementwise
// work run at the same time.
//
// Design (bf16; heads_ws_kernel below). A persistent grid of one block per
// SM: a producer warp per consumer streams x by TMA into that consumer's
// ring of six stages (full / empty mbarriers), and three consumer
// warpgroups (setmaxnreg: 160 registers) each own one work item at a time:
// 64 output columns (the 64 rows of wgmma's M) by a band of TH = 30 output
// rows of one image, walked down its 32 halo rows. A halo row arrives as one
// box of 66 pixels x 32 channels under the 64-byte swizzle; TMA's zero fill
// past the image edge is the zero padding of the reference's 3x3 conv. Per
// halo row:
//   gates per group of 8 heads: g1 = x . w1 on wgmma m64n128k16 (A from
//         registers by ldmatrix, B from shared memory, the accumulator
//         started at b1); ReLU and the bf16 rounding in one
//         cvt.rn.relu.bf16x2, which leaves g1 as the A fragments of
//         psi-conv2: one wgmma m64n8k16 a head against its w2 row (a head's
//         16 features are one 16-deep slice); the sigmoid in f32. The gates
//         (K f32 a pixel) go to a shared row buffer, the only per-pixel
//         intermediate that leaves registers.
//   one barrier of the warpgroup, after which the last output row leaves.
//   taps  per dx, one wgmma m64n48k16 (m64n72k16 in a pass of 24 heads) of
//         the x rows one pixel to the side (ldmatrix addresses the shifted
//         rows, so the neighbour's m lands in the output pixel's own
//         accumulator row) by the pass's [3 dy x PH heads] taps, the next
//         dx's product running while this one's is summed: each product times
//         the neighbour's gate from the row buffer, summed in registers into
//         the three running output rows (dy). The row whose last halo row
//         this is gets the f32 bias and activation, one rounding, a shared
//         staging row, and after the next barrier one TMA store of [64 px,
//         the pass's heads] where K % 8 == 0. Else a single pass (K <= 24: a
//         19-marker pixel is 38 B) stores the row's contiguous span of 64 K
//         values by 16-byte vector stores, and several passes store their
//         heads pixel by pixel.
// The weights of a pass (w1, wm, the w2 rows: 33 KB for 16 heads, 50 KB for
// 24) are written into shared memory once per block and read by wgmma once
// per 64 pixels. The gates of the two columns beside the item (x0 - 1,
// x0 + 64) come from one extra gate pass over a box of those two columns (2 x
// 32 halo rows) at the start of the item, so items sit side by side with no
// recomputed columns; rows are recomputed 32/30 times plus that pass, ~1.09x
// in all. Heads go in groups of 8 (a 19-marker panel costs 24 heads), and
// a pass takes 2 groups (16 heads) or, where that makes fewer passes, 3 (24
// heads: a 19-marker panel in one pass, which streams x once); more heads
// run further passes over the image, each with its own weights in shared
// memory. The JAX kernel's two stacked 8-row blocks (16 rows computed
// for 8) and its dense [K*C2, K] psi-conv2 are TPU layout work and are not
// carried over.
//
// What holds it (scripts/profile_k3_parts_torch.py; H100 80GB HBM3, 700 W):
// the per-row chain of each consumer. Without psi-conv2's eight m64n8 a
// group the kernel takes ~0.6 of its time, without the taps ~0.75, with
// loads, barriers and stores alone ~0.37 (16 heads) and ~0.28 (19 heads in
// one pass of 24). Measured slower while the design was chosen: two
// consumers with 232 registers; overlapping one group's g1 with the last
// one's psi-conv2, issuing taps before the barrier, or all taps at once,
// which run out of registers (ptxas serialises every wgmma: C7512); and
// psi-conv2 on the CUDA cores (a reduce-scatter over each row's quad).

// Widths (heads_ws_kernel<PG, CW, NC2>). The decoder's last fusion width C
// is a config field (32 in every shipped preset), and C2 = C / 2. The
// kernel takes CW = 16, 32 or 64 channels and C2 in NC2 = 1 or 2 groups of
// 16 features; ops/seg_heads.py zero-pads C and C2 up to them, which is
// exact (a zero channel of x against a zero row of w1 and wm adds nothing;
// a padded feature of g1 is relu(0 + 0) = 0 against a zero entry of w2). A
// halo row of CW channels is one TMA box under the swizzle of its width (32,
// 64 or 128 bytes: a 64-channel pixel is the widest 128-byte swizzle span),
// the products over the channels run CW / 16 wgmma k-steps, and the gate's
// psi-conv2 sums NC2 groups of 16 features, each a g1 product of its own
// (m64n128: 8 heads x 16 features) and eight m64n8k16. So the largest C is
// 64 (C2 up to 32): a wider pixel needs two boxes a row, and at C = 64 and
// C2 = 32 a pass's weights (w1 64 KB, the taps 18 KB, w2 16 KB) and three
// consumers' rings of two stages already take 225 KB of the 227 KB a block
// has. Widths other than C = 32, C2 = 16 run passes of 16 heads, and at CW
// = 64 a ring of two stages (six at 16 and 32 channels).
//
// Two paths:
//   bf16  the main path (wgmma and TMA, as above);
//   f32   scalar FMAs on 8 x 8 output tiles with the tap products of the
//         10 x 10 halo in shared memory, 16 heads a block (8 at C = 64 with
//         C2 = 32) (tests and f32 numerics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

struct Args {
  const void* x;     // [B, H, W, C]
  const void* w1t;   // [KP*C2, C]: psi-conv1 with BN folded, output-major
  const void* b1;    // [KP*C2]
  const void* w2;    // [KP, C2]
  const void* b2;    // [KP]
  const void* wmt;   // [9*KP, C]: the tap matrix, output-major, row t*KP + k
  const void* bf;    // [KP]
  void* out;         // [B, H, W, K]
  int B, H, W, K;    // K heads, zero-padded to KP = K rounded up to 8 in the weights
  int act;           // 0 none, 1 tanh, 2 sigmoid
  int C, C2;         // channels (16, 32 or 64) and gate features a head (16 or 32)
};

__host__ __device__ __forceinline__ int padded_heads(int k) { return (k + 7) & ~7; }

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float activate(float v, int act) {
  return act == 1 ? tanhf(v) : act == 2 ? sigmoid_f32(v) : v;
}

// ---- bf16: persistent, warp-specialised, TMA-fed wgmma ------------------------

constexpr int NCONS = 3;                  // consumer warpgroups per block
constexpr int HG = 8;                     // heads per group
constexpr int TW = 64;                    // output columns per item: wgmma's M
constexpr int TH = 30;                    // output rows per item
constexpr int HR = TH + 2;                // halo rows per item
constexpr int ROW_PX = TW + 2;            // pixels of a halo-row box: x0 - 1 .. x0 + 64
constexpr int C2G = 16;                   // gate features a group of psi-conv2: one k-step
// gate-buffer pitch in floats: a pass's 16 or 24 heads; rows 24 floats apart
// make the float2 accesses of a half warp (4 rows x 4 lanes) conflict-free
constexpr int GP = 24;
constexpr int THREADS = 128 * (NCONS + 1);  // producer warpgroup + the consumers
// registers: setmaxnreg moves them between warpgroups within what the block
// got at launch (65536 / THREADS a thread, in steps of 8): the producer keeps
// 24, the consumers share the rest (160 each with three)
constexpr int PRODUCER_REGS = 24;
constexpr int LAUNCH_REGS = (65536 / THREADS) & ~7;
constexpr int CONSUMER_REGS_FIT =
    ((LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * NCONS)) & ~7;
constexpr int CONSUMER_REGS = CONSUMER_REGS_FIT < 240 ? CONSUMER_REGS_FIT : 240;
static_assert(128 * PRODUCER_REGS + 128 * NCONS * CONSUMER_REGS <= LAUNCH_REGS * THREADS,
              "register file");
static_assert(2 * HR <= TW, "one edge pass covers both side columns");
constexpr int W2_TILE = 8 * 64;           // [8 heads][16 features (+16 unused)], 64-byte swizzle
constexpr int BAR_PASS = 1;               // every consumer
constexpr int BAR_ROW = 2;                // + consumer index: one consumer (128 threads)

// Tiles of CW-channel rows (a pixel of x, a row of w1 or of the taps) in the
// swizzled layout of their width: 32, 64 or 128 bytes, the span of one
// TMA box and of one wgmma descriptor. Byte offset of 16-byte chunk c of row
// r, and the descriptor of a tile (8-row groups 8 * 2 CW bytes apart).
template <int CW>
__device__ __forceinline__ unsigned swz_cw(int r, int c) {
  static_assert(CW == 16 || CW == 32 || CW == 64, "channels");
  if constexpr (CW == 64) return swz(r, c);
  else if constexpr (CW == 32) return swz64(r, c);
  else return (unsigned)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}
template <int CW>
__device__ __forceinline__ unsigned long long desc_cw(unsigned addr) {
  if constexpr (CW == 64) return smem_desc(addr);
  else if constexpr (CW == 32) return smem_desc64(addr);
  else
    return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) |
           (3ull << 62);
}

// Shared memory of a kernel whose passes take PG groups (PH = 16 or 24
// heads) over CW channels and NC2 groups of 16 gate features, from a
// 1024-byte aligned base: the weights of a pass (w1 as PG x NC2 tiles of
// [8 heads x 16 features][CW]), then one region per consumer: its ring, two
// output staging rows, two gate row buffers ([66][GP] f32 each: the left
// side column, the 64 pixels, the right one), the side columns' gates ([2 *
// HR][GP]), the ring's mbarriers
template <int PG, int CW, int NC2>
struct Layout {
  static constexpr int PH = HG * PG;                  // heads per pass
  static constexpr int C2 = C2G * NC2;                // gate features a head
  static constexpr int KSTEPS = CW / 16;              // wgmma k-steps over the channels
  static constexpr int ALIGN = CW == 64 ? 1024 : 512; // the swizzle's repeat (and 512)
  static constexpr int ROW_BYTES = ROW_PX * CW * 2;   // a halo row: 4224 at 32 channels
  static constexpr int EDGE_BYTES = 2 * HR * CW * 2;  // the two side columns: 4096 at 32
  static constexpr int STAGES = CW == 64 ? 2 : 6;     // ring stages per consumer
  static constexpr int STAGE_STRIDE = (ROW_BYTES + ALIGN - 1) / ALIGN * ALIGN;  // 4608 at 32
  static constexpr int W1_TILE = 128 * CW * 2;        // [128 gate features][CW channels]
  static constexpr int WM_TILE = 3 * PH * CW * 2;     // one dx: [3 dy x PH heads][CW channels]
  static constexpr int W1_OFF = 0;
  static constexpr int WM_OFF = W1_OFF + PG * NC2 * W1_TILE;
  static constexpr int W2_OFF = WM_OFF + 3 * WM_TILE;
  static constexpr int B1_OFF = W2_OFF + PH * NC2 * W2_TILE;  // f32 [PH * C2]
  static constexpr int B2_OFF = B1_OFF + PH * C2 * 4;   // f32 [PH]
  static constexpr int BF_OFF = B2_OFF + PH * 4;        // f32 [PH]
  static constexpr int CONS_OFF = (BF_OFF + PH * 4 + ALIGN - 1) / ALIGN * ALIGN;
  // 64 px x PH heads bf16 + 16 B of slack
  static constexpr int STG_BYTES = ((TW * PH + 8) * 2 + 127) & ~127;
  static constexpr int R_RING = 0;
  static constexpr int R_STG = R_RING + STAGES * STAGE_STRIDE;
  static constexpr int R_ROWG = R_STG + 2 * STG_BYTES;
  static constexpr int R_EDGEG = R_ROWG + 2 * ROW_PX * GP * 4;
  static constexpr int R_BARS = R_EDGEG + 2 * HR * GP * 4;
  static constexpr int CONS_BYTES = (R_BARS + 2 * STAGES * 8 + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr size_t SMEM = 1024 + CONS_OFF + NCONS * (size_t)CONS_BYTES;
  static_assert(PH <= GP, "gate rows");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(EDGE_BYTES <= STAGE_STRIDE, "stages");
  static_assert(WM_TILE % ALIGN == 0 && W1_TILE % ALIGN == 0 && W2_OFF % 512 == 0 &&
                    R_STG % 128 == 0 && STG_BYTES % 128 == 0 && CONS_OFF % ALIGN == 0 &&
                    CONS_BYTES % ALIGN == 0,
                "alignment");
};

// two f32 values rounded to bf16 and clamped at 0 (ReLU), packed low / high
__device__ __forceinline__ unsigned relu_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float sigmoid_fast(float v) {
  return rcp_approx(1.f + ex2_approx(-1.4426950408889634f * v));
}

__device__ __forceinline__ float activate_fast(float v, int act) {
  if (act == 1) {
    float y;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(v));
    return y;
  }
  return act == 2 ? sigmoid_fast(v) : v;
}

// keeps A fragments' registers live up to here: an RS wgmma reads them until
// a wgmma_wait retires it
template <int N>
__device__ __forceinline__ void keep_frags(unsigned (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The gates of the pass's np (<= PG) groups of 8 heads for the warpgroup's
// 64 pixels, whose x is the A fragments a (channels 16 kk .. 16 kk + 15),
// into the gate rows d0 (pixel i0) and d1 (pixel i0 + 8) at this thread's
// heads. Per group and group of 16 gate features: g1 = x . w1 + b1 on wgmma
// m64n128 (the accumulator starts at b1), ReLU and bf16 in one conversion,
// psi-conv2 as one m64n8k16 per head (g1's accumulator layout is the A
// layout of the next product), summed over the feature groups;
// sigmoid(. + b2).
template <int PG, int CW, int NC2>
__device__ __forceinline__ void pass_gates(unsigned (&a)[CW / 16][4], int np, unsigned w1_s,
                                           unsigned w2_s, const float* b1s, const float* b2s,
                                           int tig, float* d0, float* d1) {
  using L = Layout<PG, CW, NC2>;
  float acc[64];
  unsigned pa[HG][4];
#pragma unroll
  for (int p = 0; p < PG; ++p) {
    if (p >= np) break;
    const float2 b2v = *reinterpret_cast<const float2*>(b2s + p * HG + 2 * tig);
    float gp[4] = {b2v.x, b2v.y, b2v.x, b2v.y};
#pragma unroll
    for (int jc = 0; jc < NC2; ++jc) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {  // column 8 j + 2 tig: head j / 2, feature 8 (j % 2) + 2 tig
        const float2 bb = *reinterpret_cast<const float2*>(
            b1s + (p * HG + j / 2) * L::C2 + C2G * jc + 8 * (j % 2) + 2 * tig);
        acc[4 * j] = bb.x;
        acc[4 * j + 1] = bb.y;
        acc[4 * j + 2] = bb.x;
        acc[4 * j + 3] = bb.y;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        wgmma_rs_n128<0>(acc, a[kk], desc_cw<CW>(w1_s + (p * NC2 + jc) * L::W1_TILE + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int k = 0; k < HG; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[k][e] = relu_bf16x2(acc[8 * k + 2 * e], acc[8 * k + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HG; ++k)
        wgmma_rs_n8<0>(gp, pa[k], smem_desc64(w2_s + ((p * HG + k) * NC2 + jc) * W2_TILE), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(gp);
      keep_frags(pa);
    }
    *reinterpret_cast<float2*>(d0 + p * HG + 2 * tig) =
        make_float2(sigmoid_fast(gp[0]), sigmoid_fast(gp[1]));
    *reinterpret_cast<float2*>(d1 + p * HG + 2 * tig) =
        make_float2(sigmoid_fast(gp[2]), sigmoid_fast(gp[3]));
  }
  keep_frags(a);
}

// One dx's tap product: m64n48 for a pass of 16 heads, m64n72 for 24
__device__ __forceinline__ void taps_mma(float (&d)[24], const unsigned (&a)[4],
                                         unsigned long long db, int acc) {
  wgmma_rs_n48<0>(d, a, db, acc);
}
__device__ __forceinline__ void taps_mma(float (&d)[36], const unsigned (&a)[4],
                                         unsigned long long db, int acc) {
  wgmma_rs_n72<0>(d, a, db, acc);
}

// The tap products of one dx for one halo row, issued as one wgmma group
// (not waited for): the x rows shifted by dx - 1 (a) times the pass's [3 dy
// x PH heads] taps of that dx (wm_s), into tm (rows g, g + 8 x column
// dy * PH + head)
template <int CW, int N>
__device__ __forceinline__ void taps_issue(float (&tm)[N], unsigned (&a)[CW / 16][4],
                                           unsigned wm_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CW / 16; ++kk) taps_mma(tm, a[kk], desc_cw<CW>(wm_s + 32 * kk), kk > 0);
  wgmma_commit();
}

__device__ __forceinline__ float2 ld_shared_f2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Each tap product of one dx, once it has landed, times the gate of its
// neighbour (at shared address gsrc[half]: that pixel's gate row, at this
// thread's heads), summed into the running output rows of groups p < np:
// dy = 0 feeds the row below the halo row (nxt), dy = 1 its own (cur), dy =
// 2 the row above (prv)
template <int PG>
__device__ __forceinline__ void taps_sum(float (&tm)[12 * PG], const unsigned (&gsrc)[2],
                                         int np, float (&nxt)[PG][4], float (&cur)[PG][4],
                                         float (&prv)[PG][4]) {
  fence_acc(tm);
#pragma unroll
  for (int p = 0; p < PG; ++p) {
    if (p >= np) break;
    const float2 ga = ld_shared_f2(gsrc[0] + p * HG * 4);
    const float2 gb = ld_shared_f2(gsrc[1] + p * HG * 4);
    const float gv[4] = {ga.x, ga.y, gb.x, gb.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // column block PG dy + p
      nxt[p][e] = fmaf(tm[4 * p + e], gv[e], nxt[p][e]);
      cur[p][e] = fmaf(tm[4 * (PG + p) + e], gv[e], cur[p][e]);
      prv[p][e] = fmaf(tm[4 * (2 * PG + p) + e], gv[e], prv[p][e]);
    }
  }
}

// The work items: image b, output rows y0 .. y0 + TH - 1, columns x0 .. x0 + 63
struct Item {
  int b, y0, x0;
};
__device__ __forceinline__ Item item_of(int t, int H, int W) {
  const int n_x = (W + TW - 1) / TW, n_y = (H + TH - 1) / TH;
  return {t / (n_x * n_y), ((t / n_x) % n_y) * TH, (t % n_x) * TW};
}

// One persistent block per SM. Producer warp c (lane 0) streams consumer
// c's items, pass by pass (PH = 8 PG heads a pass): per item one stage with
// the two side columns (x0 - 1 and x0 + 64, halo rows y0 - 1 .. y0 + 30, two
// boxes), then one stage per halo row inside the image (66 pixels from x0 -
// 1); TMA fills what lies outside with zeros. Consumer c takes items NCONS * blockIdx.x +
// c, + NCONS * gridDim.x, ...: the side columns' gates, then row by row the
// gates (into one of two row buffers), after the row's barrier the tap
// products and their sums dx by dx, and the output row that completes,
// staged in shared memory and stored after the next barrier.
// xrow / xcol: x [B, H, W, CW] in boxes of [1, 1, 66, CW] and [1, 32, 1,
// CW]; omap: out [B, H, W, K] in boxes of [1, 1, 64, min(K, PH)] where K %
// 8 == 0 (else unused: the rows of a single pass leave by 16-byte vector
// stores of their span, those of several passes pixel by pixel).
template <int PG, int CW, int NC2>
__global__ void __launch_bounds__(THREADS, 1)
    heads_ws_kernel(const __grid_constant__ CUtensorMap xrow, const __grid_constant__ CUtensorMap xcol,
                    const __grid_constant__ CUtensorMap omap, const Args a, const int tma_out) {
  using L = Layout<PG, CW, NC2>;
  constexpr int PH = L::PH, STAGES = L::STAGES, KSTEPS = L::KSTEPS, C2 = L::C2;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  auto cons = [&](int c) { return base + L::CONS_OFF + c * L::CONS_BYTES; };
  auto full = [&](int c, int st) { return cons(c) + L::R_BARS + 8 * st; };
  auto empty = [&](int c, int st) { return cons(c) + L::R_BARS + 8 * (STAGES + st); };

  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, K = a.K, KP = padded_heads(K);
  const int n_pass = (KP + PH - 1) / PH;
  const int items = a.B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  if (tid == 0) {
    for (int c = 0; c < NCONS; ++c)
      for (int st = 0; st < STAGES; ++st) {
        mbar_init(full(c, st), 1);
        mbar_init(empty(c, st), 128);
      }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // the producers: lane 0 of warp c for consumer c
    setmaxnreg_dec<PRODUCER_REGS>();
    const int c = tid / 32;
    if (c < NCONS && tid % 32 == 0) {
      int it = 0;
      auto stage = [&](unsigned bytes) {
        const int st = it % STAGES;
        mbar_wait(empty(c, st), ((it / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(c, st), bytes);
        ++it;
        return cons(c) + L::R_RING + st * L::STAGE_STRIDE;
      };
      for (int q = 0; q < n_pass; ++q)
        for (int t = NCONS * blockIdx.x + c; t < items; t += NCONS * gridDim.x) {
          const Item w = item_of(t, H, W);
          unsigned sb = stage(L::EDGE_BYTES);
          const unsigned bar = full(c, (it - 1) % STAGES);
          tma_load_4d(sb, &xcol, bar, 0, w.x0 - 1, w.y0 - 1, w.b);
          tma_load_4d(sb + HR * CW * 2, &xcol, bar, 0, w.x0 + TW, w.y0 - 1, w.b);
          const int n_out = min(TH, H - w.y0);
          for (int r = 0; r <= n_out + 1; ++r) {
            const int y = w.y0 - 1 + r;
            if (y < 0 || y >= H) continue;
            sb = stage(L::ROW_BYTES);
            tma_load_4d(sb, &xrow, full(c, (it - 1) % STAGES), 0, w.x0 - 1, y, w.b);
          }
        }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const int i0 = warp * 16 + g;                     // this thread's pixels: i0 and i0 + 8
  const int lrow = warp * 16 + (lane & 15), lchunk = lane >> 4;  // its ldmatrix row / chunk
  const unsigned ring = cons(c) + L::R_RING;
  unsigned char* mine = base_ptr + L::CONS_OFF + c * L::CONS_BYTES;
  float* rowg = reinterpret_cast<float*>(mine + L::R_ROWG);    // [2][ROW_PX][GP]
  float* edgeg = reinterpret_cast<float*>(mine + L::R_EDGEG);  // [2 * HR][GP]
  const unsigned rowg_s = cons(c) + L::R_ROWG, edgeg_s = cons(c) + L::R_EDGEG;
  const float* b1s = reinterpret_cast<const float*>(base_ptr + L::B1_OFF);
  const float* b2s = reinterpret_cast<const float*>(base_ptr + L::B2_OFF);
  const float* bfs = reinterpret_cast<const float*>(base_ptr + L::BF_OFF);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  int it = 0;  // ring position
  int ns = 0;  // output rows staged: the next goes to staging row ns & 1
  // the output row staged last and not yet stored: its row (< 0: none),
  // image, first column and pass
  int pend_y = -1, pend_b = 0, pend_x0 = 0, pend_q = 0;

  auto staging = [&](int n) { return cons(c) + L::R_STG + (n & 1) * L::STG_BYTES; };
  auto row_start = [&](int b, int y, int x0) { return ((long long)b * H + y) * W + x0; };
  // a single pass without TMA stores the row's [pixels, K] values as one
  // contiguous span, kept at the same offset within 16 bytes in staging
  auto span_off = [&](long long row0, int nh) { return nh == K ? (int)((row0 * K) & 7) : 0; };

  // The consumer's barrier, after which the pending output row leaves: by
  // one TMA store (lane 0 first waits for the store before it to have read
  // its staging row, which the next output row overwrites), else by every
  // thread's vector stores of its span
  auto sync_store = [&]() {
    if (tma_out) {
      fence_proxy_async();
      if (lt == 0) bulk_wait_read<0>();
    }
    named_sync(BAR_ROW + c, 128);
    if (pend_y < 0) return;
    const unsigned stg = staging(ns - 1);
    if (tma_out) {
      if (lt == 0) {
        tma_store_4d(&omap, stg, PH * pend_q, pend_x0, pend_y, pend_b);
        bulk_commit();
      }
    } else {
      const __nv_bfloat16* sp = reinterpret_cast<const __nv_bfloat16*>(base_ptr + (stg - base));
      const long long row0 = row_start(pend_b, pend_y, pend_x0);
      const int n_px = min(TW, W - pend_x0), nh = min(PH, K - PH * pend_q);
      if (nh == K) {  // one span of n_px * K values
        const int off = span_off(row0, nh), total = off + n_px * K;
        __nv_bfloat16* dst = out + (row0 * K - off);
        for (int ch = lt; ch * 8 < total; ch += 128) {
          const int lo = ch * 8, hi = min(lo + 8, total);
          if (lo >= off && hi == lo + 8) {
            *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(sp + lo);
          } else {
            for (int e = max(lo, off); e < hi; ++e) dst[e] = sp[e];
          }
        }
      } else {  // several passes and K % 8 != 0: the pass's heads, pixel by pixel
        for (int e = lt; e < n_px * nh; e += 128)
          out[(row0 + e / nh) * K + PH * pend_q + e % nh] = sp[e];
      }
    }
    pend_y = -1;
  };

  // wait for a stage and take the A fragments of its rows shifted by ``shift``
  auto take = [&](unsigned (&f)[KSTEPS][4], int shift) {
    const int st = it % STAGES;
    mbar_wait(full(c, st), (it / STAGES) & 1);
    const unsigned sb = ring + st * L::STAGE_STRIDE;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(f[kk], sb + swz_cw<CW>(lrow + shift, 2 * kk + lchunk));
    return st;
  };

  for (int q = 0; q < n_pass; ++q) {
    // the weights of heads PH q .. into shared memory, in the layouts wgmma reads
    const int np = min(PG, (KP - PH * q) / HG);
    named_sync(BAR_PASS, 128 * NCONS);  // every consumer is done with the last pass's weights
    {
      const int ct = tid - 128;
      const __nv_bfloat16* w1t = static_cast<const __nv_bfloat16*>(a.w1t);
      const __nv_bfloat16* wmt = static_cast<const __nv_bfloat16*>(a.wmt);
      const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(a.w2);
      const __nv_bfloat16* b1 = static_cast<const __nv_bfloat16*>(a.b1);
      const __nv_bfloat16* b2 = static_cast<const __nv_bfloat16*>(a.b2);
      const __nv_bfloat16* bf = static_cast<const __nv_bfloat16*>(a.bf);
      constexpr int CH = CW / 8;  // 16-byte chunks of a CW-channel row
      // w1: tile (p, jc), row n = head n / 16 of group p, feature 16 jc + n % 16
      for (int i = ct; i < np * NC2 * 128 * CH; i += 128 * NCONS) {
        const int ch = i % CH, n = (i / CH) % 128, pj = i / (128 * CH);
        const int p = pj / NC2, jc = pj % NC2;
        const uint4 v = *reinterpret_cast<const uint4*>(
            w1t + ((long long)(PH * q + HG * p + n / 16) * C2 + C2G * jc + n % 16) * CW + ch * 8);
        st_shared_v4(base + L::W1_OFF + pj * L::W1_TILE + swz_cw<CW>(n, ch), v);
      }
      for (int i = ct; i < 3 * 3 * PH * CH; i += 128 * NCONS) {  // wm: tile dx, row dy * PH + head
        const int ch = i % CH, n = (i / CH) % (3 * PH), dx = i / (3 * PH * CH), k = n % PH;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);  // heads past the pass's groups: zero taps
        if (k < np * HG)
          v = *reinterpret_cast<const uint4*>(
              wmt + ((long long)((n / PH) * 3 + dx) * KP + PH * q + k) * CW + ch * 8);
        st_shared_v4(base + L::WM_OFF + dx * L::WM_TILE + swz_cw<CW>(n, ch), v);
      }
      // w2: tile (h, jc) holds features 16 jc .. of head h in its row h % 8
      for (int i = ct; i < np * HG * NC2 * 8 * 4; i += 128 * NCONS) {
        const int ch = i % 4, n = (i / 4) % 8, t = i / 32, ph = t / NC2, jc = t % NC2;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n == ph % HG && ch < 2)
          v = *reinterpret_cast<const uint4*>(w2 + (long long)(PH * q + ph) * C2 + C2G * jc +
                                              ch * 8);
        st_shared_v4(base + L::W2_OFF + t * W2_TILE + swz64(n, ch), v);
      }
      float* b1w = reinterpret_cast<float*>(base_ptr + L::B1_OFF);
      float* b2w = reinterpret_cast<float*>(base_ptr + L::B2_OFF);
      float* bfw = reinterpret_cast<float*>(base_ptr + L::BF_OFF);
      for (int i = ct; i < np * HG * C2; i += 128 * NCONS)
        b1w[i] = __bfloat162float(b1[(long long)PH * q * C2 + i]);
      for (int i = ct; i < np * HG; i += 128 * NCONS) {
        b2w[i] = __bfloat162float(b2[PH * q + i]);
        bfw[i] = __bfloat162float(bf[PH * q + i]);
      }
    }
    fence_proxy_async();
    named_sync(BAR_PASS, 128 * NCONS);
    const int nh = min(PH, K - PH * q);  // heads this pass stores
    const int bi = min(K, PH);           // heads of the TMA store's box

    for (int t = NCONS * blockIdx.x + c; t < items; t += NCONS * gridDim.x) {
      const Item w = item_of(t, H, W);
      const int n_px = min(TW, W - w.x0);
      sync_store();  // the last item's gate rows are read; its last output row leaves

      {  // the gates of the two side columns: edge-stage row i is halo row i of
         // column x0 - 1 (i < HR) or halo row i - HR of column x0 + 64
        // A stage is released only once the products that read its
        // fragments are done: an ldmatrix's shared-memory read can still be
        // in flight at the instructions after it, and the producer's TMA
        // refills a released stage at once (with the two stages of 64
        // channels it overwrote the first rows under the loads: an item's
        // top-left outputs then differed from run to run on an H100)
        unsigned ae[KSTEPS][4];
        const int st = take(ae, 0);
        ++it;
        pass_gates<PG, CW, NC2>(ae, np, base + L::W1_OFF, base + L::W2_OFF, b1s, b2s, tig,
                       edgeg + i0 * GP, edgeg + (i0 + 8) * GP);
        mbar_arrive(empty(c, st));
      }

      // the running output rows: the one above the halo row (prv), its own
      // (cur), the one below (nxt); per group, pixels i0 / i0 + 8 x heads
      float prv[PG][4], cur[PG][4], nxt[PG][4];
#pragma unroll
      for (int p = 0; p < PG; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) prv[p][e] = cur[p][e] = nxt[p][e] = 0.f;

      const int n_out = min(TH, H - w.y0);
      for (int r = 0; r <= n_out + 1; ++r) {
        const int y = w.y0 - 1 + r;
        const bool in = y >= 0 && y < H;  // rows outside the image contribute 0
        float* rg = rowg + (r & 1) * ROW_PX * GP;
        unsigned af[3][KSTEPS][4];        // x of the pixels one to the left, own, one to the right
        int st = 0;                       // the halo row's stage, held until its taps
        if (in) {
          st = take(af[1], 1);
          pass_gates<PG, CW, NC2>(af[1], np, base + L::W1_OFF, base + L::W2_OFF, b1s, b2s, tig,
                         rg + (i0 + 1) * GP, rg + (i0 + 9) * GP);
        }
        sync_store();  // the row's gates are in rg; the last output row leaves
        if (in) {
          const unsigned sb = ring + st * L::STAGE_STRIDE;
#pragma unroll
          for (int dx = 0; dx < 3; dx += 2)
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk)
              ldmatrix_x4(af[dx][kk], sb + swz_cw<CW>(lrow + dx, 2 * kk + lchunk));
          ++it;
          // neighbour (pixel i + dx - 1)'s gate row: rg's row i + dx, where
          // rows 0 and 65 are the side columns
          const unsigned rg_s = rowg_s + (r & 1) * ROW_PX * GP * 4;
          unsigned gsrc[3][2];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int idx = i0 + 8 * hf + dx;
              gsrc[dx][hf] = (idx == 0        ? edgeg_s + r * GP * 4
                              : idx == TW + 1 ? edgeg_s + (HR + r) * GP * 4
                                              : rg_s + idx * GP * 4) + 8 * tig;
            }
          // dx by dx, the next dx's products running while this one's are summed
          float tm[2][12 * PG];
          taps_issue<CW>(tm[0], af[0], base + L::WM_OFF);
          taps_issue<CW>(tm[1], af[1], base + L::WM_OFF + L::WM_TILE);
          wgmma_wait<1>();
          taps_sum(tm[0], gsrc[0], np, nxt, cur, prv);
          taps_issue<CW>(tm[0], af[2], base + L::WM_OFF + 2 * L::WM_TILE);
          wgmma_wait<1>();
          taps_sum(tm[1], gsrc[1], np, nxt, cur, prv);
          wgmma_wait<0>();
          taps_sum(tm[0], gsrc[2], np, nxt, cur, prv);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) keep_frags(af[dx]);
          mbar_arrive(empty(c, st));  // every product of its fragments is done
        }

        if (r >= 2) {  // output row y - 1 is complete: bias, activation, one rounding, staged
          const unsigned stg = staging(ns);
          __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(base_ptr + (stg - base));
          const int off = tma_out ? 0 : span_off(row_start(w.b, y - 1, w.x0), nh);
#pragma unroll
          for (int p = 0; p < PG; ++p) {
            if (p >= np) break;
            const int h = p * HG + 2 * tig;
            const float f0 = bfs[h], f1 = bfs[h + 1];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = i0 + 8 * hf;
              const float v0 = activate_fast(prv[p][2 * hf] + f0, a.act);
              const float v1 = activate_fast(prv[p][2 * hf + 1] + f1, a.act);
              if (tma_out) {
                st_shared_u32(stg + (i * bi + h) * 2, pack_bf16(v0, v1));
              } else if (i < n_px) {
                if (h < nh) sp[off + i * nh + h] = __float2bfloat16_rn(v0);
                if (h + 1 < nh) sp[off + i * nh + h + 1] = __float2bfloat16_rn(v1);
              }
            }
          }
          pend_y = y - 1;
          pend_b = w.b;
          pend_x0 = w.x0;
          pend_q = q;
          ++ns;
        }
#pragma unroll
        for (int p = 0; p < PG; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            prv[p][e] = cur[p][e];
            cur[p][e] = nxt[p][e];
            nxt[p][e] = 0.f;
          }
      }
    }
  }
  sync_store();  // the last output row leaves
  if (lt == 0) bulk_wait<0>();
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

template <int PG, int CW, int NC2>
int launch_ws(const Args& a, cudaStream_t st) {
  using L = Layout<PG, CW, NC2>;
  constexpr int PH = L::PH;
  constexpr CUtensorMapSwizzle SW = CW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xrow, xcol, om;
  const long long xd[4] = {CW, a.W, a.H, a.B};
  const long long xs[3] = {CW, (long long)CW * a.W, (long long)CW * a.W * a.H};
  int err = encode_4d_bf16(&xrow, a.x, xd, xs, {CW, ROW_PX, 1, 1}, SW);
  if (!err) err = encode_4d_bf16(&xcol, a.x, xd, xs, {CW, 1, HR, 1}, SW);
  const int tma_out = a.K % 8 == 0;
  memset(&om, 0, sizeof om);
  if (!err && tma_out) {
    const long long od[4] = {a.K, a.W, a.H, a.B};
    const long long os[3] = {a.K, (long long)a.K * a.W, (long long)a.K * a.W * a.H};
    err = encode_4d_bf16(&om, a.out, od, os, {a.K < PH ? a.K : PH, TW, 1, 1},
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      heads_ws_kernel<PG, CW, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long want = (items + NCONS - 1) / NCONS;
  const int grid = (int)(want < sm_count() ? want : sm_count());
  heads_ws_kernel<PG, CW, NC2><<<grid, THREADS, L::SMEM, st>>>(xrow, xcol, om, a, tma_out);
  return (int)cudaGetLastError();
}

// At 32 channels and 16 gate features, passes of 24 heads where they take
// fewer passes over the image than passes of 16 (19 markers: one pass, not
// two), else of 16 (the fewer registers); other widths in passes of 16
int launch_bf16(const Args& a, cudaStream_t st) {
  const int kp = padded_heads(a.K);
  const int nc2 = a.C2 / C2G;
  if (a.C == 32 && nc2 == 1)
    return (kp + 23) / 24 < (kp + 15) / 16 ? launch_ws<3, 32, 1>(a, st)
                                           : launch_ws<2, 32, 1>(a, st);
  if (a.C == 16) return nc2 == 1 ? launch_ws<2, 16, 1>(a, st) : launch_ws<2, 16, 2>(a, st);
  if (a.C == 32) return launch_ws<2, 32, 2>(a, st);
  return nc2 == 1 ? launch_ws<2, 64, 1>(a, st) : launch_ws<2, 64, 2>(a, st);
}

// ---- f32 (tests): scalar FMAs on 8 x 8 output tiles -------------------------

constexpr int FT = 8;                   // output tile side
constexpr int FH = FT + 2;              // halo tile side
constexpr int FTHREADS = 256;

// The f32 kernel at C channels and C2 gate features a head: FG heads a
// block (8 at 64 channels with 32 features, so that the weights fit)
template <int C, int C2>
struct F32 {
  static constexpr int FG = C * C2 >= 64 * 32 ? 8 : 16;  // heads per block
  static constexpr int NG = FG * C2;                      // gate features: 256 at 32 / 16
  static constexpr int NM = 9 * FG;                       // tap columns, t*FG + k
  static constexpr int LDX = C + 1;                       // f32 x row stride: conflict-free reads
  static constexpr size_t SMEM = ((size_t)FH * FH * LDX + (size_t)(NG + NM) * C + FG * C2 + NG +
                                  2 * FG + (size_t)FH * FH * NM) * sizeof(float);
  static_assert(SMEM <= 232448, "shared memory");
};

// blockIdx.x: the output tile; blockIdx.y: heads FG y .. of the padded KP
template <int C, int C2>
__global__ void __launch_bounds__(FTHREADS) heads_f32_kernel(Args a) {
  using F = F32<C, C2>;
  constexpr int FG = F::FG, NG = F::NG, NM = F::NM, LDX = F::LDX;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [FH*FH][LDX]
  float* w1s = xs + FH * FH * LDX;             // [NG][C]
  float* wms = w1s + NG * C;                   // [NM][C]
  float* w2s = wms + NM * C;                   // [FG][C2]
  float* b1s = w2s + FG * C2;                  // [NG]
  float* b2s = b1s + NG;
  float* bfs = b2s + FG;
  float* vs = bfs + FG;                        // [FH*FH][NM]

  const int KP = padded_heads(a.K), h0 = blockIdx.y * FG, nh = min(FG, KP - h0);
  const int n_tx = (a.W + FT - 1) / FT, n_ty = (a.H + FT - 1) / FT;
  const int tx = blockIdx.x % n_tx, ty = (blockIdx.x / n_tx) % n_ty, b = blockIdx.x / (n_tx * n_ty);
  const int x0 = tx * FT, y0 = ty * FT;
  const float* x = static_cast<const float*>(a.x);

  for (int i = threadIdx.x; i < nh * C2 * C; i += FTHREADS)
    w1s[i] = static_cast<const float*>(a.w1t)[(long long)h0 * C2 * C + i];
  for (int i = threadIdx.x; i < 9 * nh * C; i += FTHREADS) {
    const int t = i / (nh * C), h = (i / C) % nh, c = i % C;
    wms[(t * FG + h) * C + c] = static_cast<const float*>(a.wmt)[((long long)t * KP + h0 + h) * C + c];
  }
  for (int i = threadIdx.x; i < nh * C2; i += FTHREADS) {
    w2s[i] = static_cast<const float*>(a.w2)[h0 * C2 + i];
    b1s[i] = static_cast<const float*>(a.b1)[h0 * C2 + i];
  }
  for (int i = threadIdx.x; i < nh; i += FTHREADS) {
    b2s[i] = static_cast<const float*>(a.b2)[h0 + i];
    bfs[i] = static_cast<const float*>(a.bf)[h0 + i];
  }
  for (int i = threadIdx.x; i < FH * FH * C; i += FTHREADS) {
    const int q = i / C, c = i % C;
    const int y = y0 - 1 + q / FH, col = x0 - 1 + q % FH;
    const bool ok = y >= 0 && y < a.H && col >= 0 && col < a.W;
    xs[q * LDX + c] = ok ? x[(((long long)b * a.H + y) * a.W + col) * C + c] : 0.f;
  }
  __syncthreads();

  // tap products of every (halo pixel, head)
  for (int i = threadIdx.x; i < FH * FH * nh; i += FTHREADS) {
    const int q = i % (FH * FH), h = i / (FH * FH);
    const int y = y0 - 1 + q / FH, col = x0 - 1 + q % FH;
    float* vq = vs + q * NM + h;
    if (y < 0 || y >= a.H || col < 0 || col >= a.W) {
#pragma unroll
      for (int t = 0; t < 9; ++t) vq[t * FG] = 0.f;
      continue;
    }
    const float* xq = xs + q * LDX;
    float pre = 0.f;
    for (int j = 0; j < C2; ++j) {
      const float* wr = w1s + (h * C2 + j) * C;
      float s = b1s[h * C2 + j];
#pragma unroll
      for (int c = 0; c < C; ++c) s = fmaf(xq[c], wr[c], s);
      pre = fmaf(fmaxf(s, 0.f), w2s[h * C2 + j], pre);
    }
    const float gate = sigmoid_f32(pre + b2s[h]);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float* wr = wms + (t * FG + h) * C;
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) m = fmaf(xq[c], wr[c], m);
      vq[t * FG] = m * gate;
    }
  }
  __syncthreads();

  // the 9-tap stencil of every (output pixel, head)
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < FT * FT * nh; i += FTHREADS) {
    const int p = i % (FT * FT), h = i / (FT * FT);
    const int py = p / FT, px = p % FT;
    const int y = y0 + py, col = x0 + px;
    if (y >= a.H || col >= a.W || h0 + h >= a.K) continue;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int q = (py + t / 3) * FH + px + t % 3;
      acc += vs[q * NM + t * FG + h];
    }
    out[(((long long)b * a.H + y) * a.W + col) * a.K + h0 + h] = activate(acc + bfs[h], a.act);
  }
}

template <int C, int C2>
int launch_f32(const Args& a, cudaStream_t st) {
  using F = F32<C, C2>;
  const cudaError_t err = cudaFuncSetAttribute(
      heads_f32_kernel<C, C2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)a.B * ((a.H + FT - 1) / FT) * ((a.W + FT - 1) / FT);
  const int groups = ((a.K + 7) / 8 * 8 + F::FG - 1) / F::FG;
  if (tiles > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  heads_f32_kernel<C, C2><<<dim3((unsigned)tiles, (unsigned)groups), FTHREADS, F::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

int launch(bool bf16, const Args& a, void* stream) {
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.K < 1 || a.act < 0 || a.act > 2 ||
      (a.C != 16 && a.C != 32 && a.C != 64) || (a.C2 != 16 && a.C2 != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bf16(a, st);
  if (a.C == 16) return a.C2 == 16 ? launch_f32<16, 16>(a, st) : launch_f32<16, 32>(a, st);
  if (a.C == 32) return a.C2 == 16 ? launch_f32<32, 16>(a, st) : launch_f32<32, 32>(a, st);
  return a.C2 == 16 ? launch_f32<64, 16>(a, st) : launch_f32<64, 32>(a, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x [B, H, W, C]
// (C = 16, 32 or 64) and out [B, H, W, K] (any K >= 1) are contiguous and
// 16-byte aligned; the weights are the padded (K rounded up to 8 heads, C2 =
// 16 or 32 gate features a head), output-major, contiguous tensors of
// ops/seg_heads.py::_padded_weights, 16-byte aligned.
int k3_seg_heads_bf16(const void* x, const void* w1t, const void* b1, const void* w2,
                      const void* b2, const void* wmt, const void* bf, void* out, int B, int H,
                      int W, int K, int act, int C, int C2, void* stream) {
  return launch(true, {x, w1t, b1, w2, b2, wmt, bf, out, B, H, W, K, act, C, C2}, stream);
}

int k3_seg_heads_f32(const void* x, const void* w1t, const void* b1, const void* w2,
                     const void* b2, const void* wmt, const void* bf, void* out, int B, int H,
                     int W, int K, int act, int C, int C2, void* stream) {
  return launch(false, {x, w1t, b1, w2, b2, wmt, bf, out, B, H, W, K, act, C, C2}, stream);
}

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
