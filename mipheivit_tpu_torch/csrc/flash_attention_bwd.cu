// K5: flash-attention backward (any S, head dim 64 or 128) from K4's saved
// row log-sum-exp.
//
// Replaces the TPU kernels mipheivit_tpu/ops/attention.py::_bwd_dkdv_kernel
// and ::_bwd_dq_kernel, launched there by _long_backward. Same contract, per
// (batch, head), with the probabilities rebuilt from the lse, so the
// [Sq, Sk] matrix never exists:
//
//   p     = exp(q . k^T / sqrt(D) - lse)          keys >= seq_len_k: 0
//   dV    = p^T . dO
//   dP    = dO . v^T
//   dS    = p * (dP - delta)                      delta = rowsum(dO * O), f32
//   dK    = dS^T . q / sqrt(D)
//   dQ    = dS . k / sqrt(D)
//
// Layout. q, dO (and O) are [B, Sq, H*D] and k, v are [B, Sk, H*D], each
// with a base pointer, a batch stride and a row stride (the sections of a
// fused qkv buffer are read in place); dq is written as [B, Sq, H*D], dk
// and dv as [B, Sk, H*D], in q's dtype. Every offset is 64-bit. delta =
// rowsum(dO * O) is the JAX package's XLA reduction outside its kernels;
// here the bf16 path computes it in the call (bwd_prep_kernel), the f32
// path takes it from the wrapper.
//
// What bounds it on the H100. At a 1024-px region (Sq = Sk = 5334, 24
// heads) one call is 10 * Sq * Sk * D * H = 437 GFLOP of products against
// ~0.1 GB of operands: far above the card's ~295 FLOP/byte, so the floor is
// the bf16 tensor-core time, 0.44 ms at the dense peak.
//
// bf16 design (bwd_bf16_kernel<D>): one kernel, one block per (128-key tile,
// head, batch item), 1008 blocks at a region, four warpgroups (at D = 64;
// the 128-wide instance below). The block's K and V tiles stay in shared
// memory (32 KB). A producer warpgroup (one
// thread) keeps a ring of three stages of 64-row q and dO tiles, with
// their lse and delta rows, in flight by TMA (cp.async.bulk.tensor on 3-D
// tensor maps: head columns, rows, batch; rows past Sq and keys past
// seq_len_k arrive as zeros, so padding that holds NaN or Inf reaches no
// product) and mbarriers; the tensor maps are encoded per call on the
// host (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint). Every
// product is a wgmma (bf16 in, f32 accumulate). Two warpgroups own 64 keys
// each:
//
//   S^T  = K . Q^T,  dP^T = V . dO^T       both operands in shared memory
//   P^T, dS^T = P^T * (dP^T - delta)       in registers
//   dV  += P^T . dO, dK += dS^T . Q        P^T and dS^T as register operands
//
// and write dS^T (bf16) into shared memory; the fourth warpgroup takes
//
//   dQ   = dS . K                          over the block's 128 keys
//
// from there: five products where the first design ran seven (two kernels
// each recomputed q . k^T and dO . v^T on mma.sync), with no block-wide
// barrier in a step. The warpgroups meet on named barriers only: dS^T of a
// step written (the dK / dV warpgroups arrive, the dQ warpgroup waits), and
// read (the other way round; dS^T has two buffers). dQ is summed over the
// key tiles in an f32 buffer [B, Sq, H*D] by TMA's bulk reduce-add
// (cp.reduce.async.bulk.tensor, one thread, from a swizzled f32 tile in
// shared memory): about 1.4 GB of f32 adds at a region, cheaper this way
// than as float2 atomics from every thread, and cheaper than the two
// products a separate dQ kernel would recompute (scripts/
// profile_k5_parts_torch.py prices both on the card). setmaxnreg moves
// registers from the producer (24) and the dQ warpgroup (80) to the dK /
// dV warpgroups (200). The order of the dQ sum differs from run to run, so
// dq does too, by f32 rounding. Rounding otherwise stays the first
// design's: p rounded to bf16 for p^T . dO, dS for both of its products;
// the lse is K4's, taken from the f32 p. In the same call a memset zeroes
// the dQ buffer, a first short kernel (bwd_prep_kernel) computes delta and
// puts the lse in log2 units, both padded to whole 64-row tiles (lse +inf
// and delta 0 past Sq, so those rows get p = 0 and dS = 0), and a last one
// (dq_cast_kernel) scales dQ by 1/sqrt(D) and casts it to bf16.
//
// The 128-wide instance (head dims 65 to 128, zero-padded to 128 by the
// wrapper). A row of 128 bf16 values is two 128-byte swizzle spans, so each
// tile is two column halves, one TMA box each, and a product over the head
// dim walks them. The dK and dV accumulators of 64 keys double to 64 x 128
// f32 each (128 registers a thread): one dK / dV warpgroup (240 registers)
// owns the block's 64 keys, beside the dQ warpgroup (160: its dQ tile is
// 64 x 128 f32 too) and the producer, 384 threads; the ring has two stages
// of q and dO (32 KB each), and the dQ tile four f32 boxes of 32 columns.
// 183 KB of shared memory a block; twice the blocks of the 64-wide
// instance, each streaming every q and dO tile once.
//
// f32 path: two kernels of scalar FMAs with every tile in shared memory,
// p and dS kept f32 (tests, numerics): dK/dV per 64-key tile, dQ per
// 64-row query tile, query rows past Sq given lse = +inf and delta = 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile of the f32 path
constexpr int THREADS = 128; // f32 path
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // in elements
  int Sq, Sk, L, H;  // L = seq_len_k
  float scale_log2;  // log2(e) / sqrt(D)
  float scale;       // 1 / sqrt(D)
};

// ---- bf16: one kernel per key tile on wgmma, q / dO tiles by TMA -----------

// The instance for head dim D. Every 64-row tile is D / 64 column halves of
// 64 values (one TMA box, 128-byte swizzled rows each).
template <int D>
struct Bwd {
  static_assert(D == 64 || D == 128, "head dim");
  static constexpr int HALVES = D / 64;
  static constexpr int NCW = D == 64 ? 2 : 1;         // dK / dV warpgroups, 64 keys each
  static constexpr int KB = 64 * NCW;                 // keys per block
  static constexpr int CONSUMERS = 128 * NCW;
  static constexpr int DQ_WG = NCW, PRODUCER_WG = NCW + 1;  // dQ; the copies
  static constexpr int THREADS = 128 * (NCW + 2);
  // registers: 168 (D = 128) or 128 (D = 64) a thread at launch; the
  // producer keeps 24, the dQ warpgroup 80 or 160, the dK / dV warpgroups
  // take the rest
  static constexpr int PRODUCER_REGS = 24, DQ_REGS = D == 64 ? 80 : 160;
  static constexpr int CONSUMER_REGS = D == 64 ? 200 : 240;
  static_assert(128 * (PRODUCER_REGS + DQ_REGS) + CONSUMERS * CONSUMER_REGS <=
                    ((65536 / THREADS) & ~7) * THREADS,
                "register file");
  static constexpr int BAR_COUNT = CONSUMERS + 128;
  static constexpr int STAGES = D == 64 ? 3 : 2;      // the q / dO ring
  static constexpr int HALF = BQ * 128;               // a column half of a 64-row tile
  static constexpr int TILE_BYTES = HALVES * HALF;    // 64 rows of D bf16
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * BQ * 4;  // q, dO, lse, delta
  static constexpr int STAGE_STRIDE = (STAGE_BYTES + 1023) / 1024 * 1024;
  static constexpr int DS_BYTES = KB * BQ * 2;        // dS^T [KB keys][64 queries] bf16
  static constexpr int DQ_BOX = BQ * 128;             // 32 f32 columns of a dQ tile
  static constexpr int DQ_BYTES = BQ * D * 4;         // a dQ tile, D / 32 boxes
  // alignment, K and V, the ring, dS^T twice, dQ twice, the mbarriers
  static constexpr size_t SMEM = 1024 + 2 * NCW * (size_t)TILE_BYTES +
                                 (size_t)STAGES * STAGE_STRIDE + 2 * (size_t)DS_BYTES +
                                 2 * (size_t)DQ_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};
// named barriers (0 is __syncthreads): dS^T of an even / odd step written
// (the dK / dV warpgroups arrive, the dQ warpgroup waits), and read (the
// other way round)
constexpr int BAR_DS_READY = 1, BAR_DS_FREE = 3;
constexpr int BAR_DQ = 5;                        // the dQ warpgroup alone

struct BwdArgs {
  const float* lse;    // [B, H, Sq_pad], log2 units, +inf past Sq (bwd_prep_kernel)
  const float* delta;  // [B, H, Sq_pad], 0 past Sq (bwd_prep_kernel)
  float* dq_acc;       // [B, Sq, H*D] f32, zeroed
  void* dk;            // [B, Sk, H*D]
  void* dv;
  int Sq, Sq_pad, Sk, L, H;
  float scale_log2, scale;
};

// keeps the compiler from reusing a register operand's registers before
// the products that read it are done
__device__ __forceinline__ void fence_frags(unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

template <int D>
__global__ void __launch_bounds__(Bwd<D>::THREADS, 1)
    bwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap dqmap, BwdArgs a) {
  using P = Bwd<D>;
  constexpr int KB = P::KB, STAGES = P::STAGES, HALVES = P::HALVES, HALF = P::HALF;
  constexpr int TILE_BYTES = P::TILE_BYTES, BAR_COUNT = P::BAR_COUNT;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const unsigned k_s = base, v_s = base + P::NCW * TILE_BYTES;
  const unsigned ring = base + 2 * P::NCW * TILE_BYTES;
  const unsigned ds_s = ring + STAGES * P::STAGE_STRIDE;
  const unsigned dq_s = ds_s + 2 * P::DS_BYTES;
  const unsigned kv_bar = dq_s + 2 * P::DQ_BYTES;
  auto full = [&](int st) { return kv_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_bar + 8 * (1 + STAGES + st); };

  const int k0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_q = (a.Sq + BQ - 1) / BQ;
  const long long hd = (long long)a.H * D;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + (long long)b * a.Sk * hd + h * D;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + (long long)b * a.Sk * hd + h * D;

  if (k0 >= a.L) {  // no live key: dK = dV = 0, no term of dQ
    for (int i = tid; i < KB * D / 8; i += P::THREADS) {
      const int row = k0 + i / (D / 8), c = (i % (D / 8)) * 8;
      if (row >= a.Sk) continue;
      *reinterpret_cast<uint4*>(dkg + row * hd + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvg + row * hd + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), P::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == P::PRODUCER_WG) {  // one thread issues every copy, a box per column half
    setmaxnreg_dec<P::PRODUCER_REGS>();
    if (tid == P::PRODUCER_WG * 128) {
      mbar_expect_tx(kv_bar, 2 * P::NCW * TILE_BYTES);
      for (int i = 0; i < P::NCW; ++i)
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(k_s + i * TILE_BYTES + hh * HALF, &kmap, kv_bar, h * D + 64 * hh,
                      k0 + 64 * i, b);
          tma_load_3d(v_s + i * TILE_BYTES + hh * HALF, &vmap, kv_bar, h * D + 64 * hh,
                      k0 + 64 * i, b);
        }
      const long long row0 = ((long long)b * a.H + h) * a.Sq_pad;
      for (int i = 0; i < n_q; ++i) {
        const int st = i % STAGES;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);  // the first round passes
        const unsigned sb = ring + st * P::STAGE_STRIDE;
        mbar_expect_tx(full(st), P::STAGE_BYTES);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(sb + hh * HALF, &qmap, full(st), h * D + 64 * hh, i * BQ, b);
          tma_load_3d(sb + TILE_BYTES + hh * HALF, &omap, full(st), h * D + 64 * hh, i * BQ, b);
        }
        bulk_load(sb + 2 * TILE_BYTES, a.lse + row0 + i * BQ, BQ * 4, full(st));
        bulk_load(sb + 2 * TILE_BYTES + BQ * 4, a.delta + row0 + i * BQ, BQ * 4, full(st));
      }
    }
    return;
  }

  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  if (wg == P::DQ_WG) {  // dQ = dS . K over the block's keys, step by step
    setmaxnreg_dec<P::DQ_REGS>();
    const int lt = tid % 128;
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_q; ++i) {
      const unsigned dsb = ds_s + (i & 1) * P::DS_BYTES;
      named_sync(BAR_DS_READY + (i & 1), BAR_COUNT);
      float dq[HALVES][32];
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk)  // 16 keys a step: key tile kk / 4
          wgmma_ss_n64<1, 1>(dq[hh], smem_desc(dsb + kk * 2048),
                             smem_desc(k_s + (kk / 4) * TILE_BYTES + hh * HALF + (kk % 4) * 2048),
                             kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) fence_acc(dq[hh]);
      if (i + 2 < n_q) named_arrive(BAR_DS_FREE + (i & 1), BAR_COUNT);
      // the tile into shared memory (128-byte swizzled boxes of 32
      // columns), once the reduction of two steps back has read it; then
      // one thread adds it into dq_acc by TMA
      if (lt == 0) bulk_wait_read<1>();
      named_sync(BAR_DQ, 128);
      const unsigned buf = dq_s + (i & 1) * P::DQ_BYTES;
      unsigned char* buf_ptr = base_ptr + (buf - base);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;
          const int c = 2 * (j & 3) + (tig >> 1);  // 16-byte chunk within the box's row
          *reinterpret_cast<float2*>(buf_ptr + (j >> 2) * P::DQ_BOX + swz(row, c) +
                                     (tig & 1) * 8) =
              make_float2(dq[j >> 3][4 * (j & 7) + 2 * r], dq[j >> 3][4 * (j & 7) + 2 * r + 1]);
        }
      fence_proxy_async();
      named_sync(BAR_DQ, 128);
      if (lt == 0) {
        for (int bx = 0; bx < D / 32; ++bx)
          tma_reduce_add_3d(&dqmap, buf + bx * P::DQ_BOX, h * D + 32 * bx, i * BQ, b);
        bulk_commit();
      }
    }
    if (lt == 0) bulk_wait<0>();
    return;
  }

  // the dK / dV warpgroups: wg owns keys k0 + 64 wg .. + 63. (Letting a
  // step's dV and dK products finish behind the next step's S^T made ptxas
  // serialize every wgmma, C7515: each step waits for its own.)
  setmaxnreg_inc<P::CONSUMER_REGS>();
  const unsigned kw = k_s + wg * TILE_BYTES, vw = v_s + wg * TILE_BYTES;
  float dk[HALVES][32], dv[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[hh][e] = dv[hh][e] = 0.f;
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_q; ++i) {
    const int st = i % STAGES;
    mbar_wait(full(st), (i / STAGES) & 1);
    const unsigned q_t = ring + st * P::STAGE_STRIDE, o_t = q_t + TILE_BYTES;
    const float* ls = reinterpret_cast<const float*>(base_ptr + (q_t - base) + 2 * TILE_BYTES);
    const float* dls = ls + BQ;

    // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 queries each, in two
    // groups, so that p forms while dP^T is still in flight; the head dim
    // in steps of 16, half by half
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, smem_desc(kw + (kk / 4) * HALF + (kk % 4) * 32),
                         smem_desc(q_t + (kk / 4) * HALF + (kk % 4) * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(dp, smem_desc(vw + (kk / 4) * HALF + (kk % 4) * 32),
                         smem_desc(o_t + (kk / 4) * HALF + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_acc(s);

    // P^T and dS^T in registers; thread (warp, g, tig) holds keys warp*16 +
    // g (+8) and queries 8j + 2 tig (+1)
    const int key_a = k0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tig * 2 + (e & 1);
        s[4 * j + e] = key_a + 8 * (e >> 1) < a.L
                           ? exp2f(s[4 * j + e] * a.scale_log2 - ls[qc]) : 0.f;
      }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dls[j * 8 + tig * 2 + (e & 1)]);
    unsigned pa[4][4], da[4][4];  // 16 queries per step of p^T . dO and dS^T . Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

    // dV += P^T . dO and dK += dS^T . Q, the query rows as the depth, one
    // m64n64 product per column half
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(dv[hh], pa[kk], smem_desc(o_t + hh * HALF + kk * 2048), 1);
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(dk[hh], da[kk], smem_desc(q_t + hh * HALF + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) {
      fence_acc(dk[hh]);
      fence_acc(dv[hh]);
    }
    fence_frags(pa);
    fence_frags(da);
    mbar_arrive(empty(st));  // the stage's q and dO tiles are done with

    // dS^T into this step's buffer (rows = the block's keys, 128-byte
    // swizzled) once the dQ warpgroup is done with it from two steps back
    const unsigned dsb = ds_s + (i & 1) * P::DS_BYTES;
    unsigned char* dsb_ptr = base_ptr + (dsb - base);
    if (i >= 2) named_sync(BAR_DS_FREE + (i & 1), BAR_COUNT);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg * 64 + warp * 16 + g + 8 * r;
        *reinterpret_cast<unsigned*>(dsb_ptr + swz(row, j) + tig * 4) =
            da[j >> 1][(j & 1) * 2 + r];
      }
    fence_proxy_async();  // this thread's dS^T writes, for wgmma
    named_arrive(BAR_DS_READY + (i & 1), BAR_COUNT);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const int e = 4 * (j & 7) + 2 * r;
      *reinterpret_cast<unsigned*>(dkg + row * hd + c) =
          pack_bf16(dk[j >> 3][e] * a.scale, dk[j >> 3][e + 1] * a.scale);
      *reinterpret_cast<unsigned*>(dvg + row * hd + c) =
          pack_bf16(dv[j >> 3][e], dv[j >> 3][e + 1]);
    }
  }
}

// The backward's inputs by whole 64-row tiles: lse2 = lse in log2 units and
// delta2 = rowsum(dO * O) over each head's D values (f32), both [B, H,
// Sq_pad], lse2 = +inf and delta2 = 0 past Sq (p = 0 and dS = 0 there). One
// thread per (batch item, head, row), 16-byte loads of O and dO.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_prep_kernel(const __nv_bfloat16* __restrict__ out, long long out_bs, long long out_rs,
                    const __nv_bfloat16* __restrict__ dout, long long do_bs, long long do_rs,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta2, int B, int H, int Sq, int Sq_pad) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)B * H * Sq_pad) return;
  const int row = (int)(idx % Sq_pad);
  const long long bh = idx / Sq_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float l2 = INFINITY, d = 0.f;
  if (row < Sq) {
    l2 = lse[bh * Sq + row] * LOG2E;
    const uint4* o = reinterpret_cast<const uint4*>(out + b * out_bs + row * out_rs + h * D);
    const uint4* g = reinterpret_cast<const uint4*>(dout + b * do_bs + row * do_rs + h * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 ov = o[c], gv = g[c];
      const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += __bfloat162float(oe[e]) * __bfloat162float(ge[e]);
    }
  }
  lse2[idx] = l2;
  delta2[idx] = d;
}

// dq = dq_acc / sqrt(D), cast to bf16; four values a thread (n a multiple of 4)
__global__ void __launch_bounds__(256) dq_cast_kernel(const float* __restrict__ acc,
                                                      __nv_bfloat16* __restrict__ dq, long long n,
                                                      float scale) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(acc + i);
  uint2 out;
  out.x = pack_bf16(v.x * scale, v.y * scale);
  out.y = pack_bf16(v.z * scale, v.w * scale);
  *reinterpret_cast<uint2*>(dq + i) = out;
}

// ---- f32: scalar FMAs, every tile in shared memory ----------------------------

// 64 rows of D f32 values from global rows r0.. into a padded shared tile
// (row stride D + 1: conflict-free column reads); rows >= n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long rs, int r0,
                                              int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < n) ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

// rows per thread: thread -> column c (and head-dim lanes c + 64 i), rows rg + 2i
constexpr int RPT = BQ / (THREADS / 64);
template <int D>
constexpr size_t F32_DKDV_SMEM = (6 * (size_t)BQ * (D + 1) + 2 * BQ) * sizeof(float);
template <int D>
constexpr size_t F32_DQ_SMEM = (5 * (size_t)BQ * (D + 1) + 2 * BQ) * sizeof(float);

template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_f32_kernel(Args a) {
  constexpr int LDF = D + 1, DC = D / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BQ * LDF;
  float* sQ = sV + BQ * LDF;
  float* sO = sQ + BQ * LDF;
  float* sP = sO + BQ * LDF;  // p^T  [key][query]
  float* sS = sP + BQ * LDF;  // dS^T [key][query]
  float* sL = sS + BQ * LDF;
  float* sD = sL + BQ;

  const int L = a.L, Sq = a.Sq;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* og = static_cast<const float*>(a.dout) + b * a.o_bs + h * D;
  const float* lg = a.lse + ((long long)b * a.H + h) * Sq;
  const float* dg = a.delta + ((long long)b * a.H + h) * Sq;
  const int c = threadIdx.x % 64, rg = threadIdx.x / 64;

  float acc_dk[RPT][DC], acc_dv[RPT][DC];  // key rows rg + 2i, dims c + 64 cc
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc_dk[i][cc] = acc_dv[i][cc] = 0.f;
  if (k0 < L) {
    load_tile_f32<D>(sK, kg, a.k_rs, k0, L);
    load_tile_f32<D>(sV, vg, a.v_rs, k0, L);
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's products are done with sQ, sO, sP, sS
      load_tile_f32<D>(sQ, qg, a.q_rs, q0, Sq);
      load_tile_f32<D>(sO, og, a.o_rs, q0, Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        sL[threadIdx.x] = r < Sq ? lg[r] * LOG2E : INFINITY;
        sD[threadIdx.x] = r < Sq ? dg[r] : 0.f;
      }
      __syncthreads();
      {  // thread -> query column c, key rows rg + 2i
        float s[RPT], dp[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float qv = sQ[c * LDF + d], ov = sO[c * LDF + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            s[i] = fmaf(sK[(rg + 2 * i) * LDF + d], qv, s[i]);
            dp[i] = fmaf(sV[(rg + 2 * i) * LDF + d], ov, dp[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + 2 * i;
          const float p = k0 + r < L ? exp2f(s[i] * a.scale_log2 - sL[c]) : 0.f;
          sP[r * LDF + c] = p;
          sS[r * LDF + c] = p * (dp[i] - sD[c]);
        }
      }
      __syncthreads();
      // thread -> dim columns c + 64 cc, key rows rg + 2i
      for (int qq = 0; qq < BQ; ++qq) {
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float ov = sO[qq * LDF + c + 64 * cc], qv = sQ[qq * LDF + c + 64 * cc];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_dv[i][cc] = fmaf(sP[(rg + 2 * i) * LDF + qq], ov, acc_dv[i][cc]);
            acc_dk[i][cc] = fmaf(sS[(rg + 2 * i) * LDF + qq], qv, acc_dk[i][cc]);
          }
        }
      }
    }
  }
  const long long hd = (long long)a.H * D;
  float* dkg = static_cast<float*>(a.dk) + (long long)b * a.Sk * hd + h * D;
  float* dvg = static_cast<float*>(a.dv) + (long long)b * a.Sk * hd + h * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + rg + 2 * i;
    if (row >= a.Sk) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      dkg[row * hd + c + 64 * cc] = acc_dk[i][cc] * a.scale;
      dvg[row * hd + c + 64 * cc] = acc_dv[i][cc];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_f32_kernel(Args a) {
  constexpr int LDF = D + 1, DC = D / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + BQ * LDF;
  float* sK = sO + BQ * LDF;
  float* sV = sK + BQ * LDF;
  float* sS = sV + BQ * LDF;  // dS [query][key]
  float* sL = sS + BQ * LDF;
  float* sD = sL + BQ;

  const int L = a.L, Sq = a.Sq;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* og = static_cast<const float*>(a.dout) + b * a.o_bs + h * D;
  const float* lg = a.lse + ((long long)b * a.H + h) * Sq;
  const float* dg = a.delta + ((long long)b * a.H + h) * Sq;
  const int c = threadIdx.x % 64, rg = threadIdx.x / 64;

  load_tile_f32<D>(sQ, qg, a.q_rs, q0, Sq);
  load_tile_f32<D>(sO, og, a.o_rs, q0, Sq);
  if (threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < Sq ? lg[r] * LOG2E : 0.f;
    sD[threadIdx.x] = r < Sq ? dg[r] : 0.f;
  }
  float acc[RPT][DC];  // query rows rg + 2i, dims c + 64 cc
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's dS . k is done with sK, sS
    load_tile_f32<D>(sK, kg, a.k_rs, k0, L);
    load_tile_f32<D>(sV, vg, a.v_rs, k0, L);
    __syncthreads();
    {  // thread -> key column c, query rows rg + 2i
      float s[RPT], dp[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = sK[c * LDF + d], vv = sV[c * LDF + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          s[i] = fmaf(sQ[(rg + 2 * i) * LDF + d], kv, s[i]);
          dp[i] = fmaf(sO[(rg + 2 * i) * LDF + d], vv, dp[i]);
        }
      }
      const bool live = k0 + c < L;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + 2 * i;
        const float p = live ? exp2f(s[i] * a.scale_log2 - sL[r]) : 0.f;
        sS[r * LDF + c] = p * (dp[i] - sD[r]);
      }
    }
    __syncthreads();
    const int n = min(BK, L - k0);
    for (int kk = 0; kk < n; ++kk) {
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kv = sK[kk * LDF + c + 64 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i][cc] = fmaf(sS[(rg + 2 * i) * LDF + kk], kv, acc[i][cc]);
      }
    }
  }
  const long long hd = (long long)a.H * D;
  float* dqg = static_cast<float*>(a.dq) + (long long)b * Sq * hd + h * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 2 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) dqg[row * hd + c + 64 * cc] = acc[i][cc] * a.scale;
  }
}

template <typename K>
cudaError_t launch_one(K kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  // above the 48 KB default: opt in to the dynamic shared memory
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

bool bad_dims(int B, int Sq, int Sk, int L, int H, int D) {
  return B < 1 || H < 1 || Sq < 1 || L < 1 || L > Sk || B > 65535 || H > 65535 ||
         (D != 64 && D != 128);
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t st) {
  const dim3 grid_kv((a.Sk + BK - 1) / BK, a.H, B), grid_q((a.Sq + BQ - 1) / BQ, a.H, B);
  cudaError_t err = launch_one(dkdv_f32_kernel<D>, grid_kv, F32_DKDV_SMEM<D>, st, a);
  if (err == cudaSuccess) err = launch_one(dq_f32_kernel<D>, grid_q, F32_DQ_SMEM<D>, st, a);
  return (int)err;
}

// bf16: the four tensor maps (q and dO over Sq rows, k and v over the L
// live keys); dq_acc zeroed, lse2 and delta2 prepared (bwd_prep_kernel);
// the backward kernel; the cast of dq
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, const BwdArgs& a, void* dq, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, long long out_bs,
                long long out_rs, long long o_bs, long long o_rs, int B, cudaStream_t st) {
  using P = Bwd<D>;
  const long long cols = (long long)a.H * D;
  CUtensorMap qm, km, vm, om, dqm;
  int err = encode_rows_bf16(&qm, q, cols, a.Sq, B, q_rs, q_bs, BQ);
  if (!err) err = encode_rows_bf16(&km, k, cols, a.L, B, k_rs, k_bs, 64);
  if (!err) err = encode_rows_bf16(&vm, v, cols, a.L, B, v_rs, v_bs, 64);
  if (!err) err = encode_rows_bf16(&om, dout, cols, a.Sq, B, o_rs, o_bs, BQ);
  if (!err)
    err = encode_rows(&dqm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dq_acc, cols, a.Sq, B, cols,
                      (long long)a.Sq * cols, BQ);
  if (err) return err;
  const long long n = (long long)B * a.Sq * cols;
  cudaError_t e = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * a.H * a.Sq_pad;
  bwd_prep_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out), out_bs, out_rs,
      static_cast<const __nv_bfloat16*>(dout), o_bs, o_rs, lse, const_cast<float*>(a.lse),
      const_cast<float*>(a.delta), B, a.H, a.Sq, a.Sq_pad);
  e = cudaFuncSetAttribute(bwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  bwd_bf16_kernel<D><<<dim3((a.Sk + P::KB - 1) / P::KB, a.H, B), P::THREADS, P::SMEM, st>>>(
      qm, km, vm, om, dqm, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_cast_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
      a.dq_acc, static_cast<__nv_bfloat16*>(dq), n, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launches (0 on success). D is the
// kernel's head dim, 64 or 128 (the operands' heads, zero-padded to it).
// bf16: out (K4's output) with its batch and row strides, lse [B, H, Sq]
// (natural log, contiguous), ws [2, B, H, Sq_pad] f32 scratch (Sq_pad = Sq
// rounded up to 64), dq_acc [B, Sq, H*D] f32 scratch.
int k5_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const float* lse, float* ws, float* dq_acc, void* dq,
                      void* dk, void* dv, long long q_bs, long long q_rs, long long k_bs,
                      long long k_rs, long long v_bs, long long v_rs, long long out_bs,
                      long long out_rs, long long o_bs, long long o_rs, int B, int Sq, int Sk,
                      int L, int H, int D, float scale_log2, float scale, void* stream) {
  if (bad_dims(B, Sq, Sk, L, H, D)) return (int)cudaErrorInvalidValue;
  const int sq_pad = (Sq + BQ - 1) / BQ * BQ;
  const long long plane = (long long)B * H * sq_pad;
  const BwdArgs a{ws, ws + plane, dq_acc, dk, dv, Sq, sq_pad, Sk, L, H, scale_log2, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_bf16<64>(q, k, v, out, dout, lse, a, dq, q_bs, q_rs, k_bs, k_rs, v_bs,
                                   v_rs, out_bs, out_rs, o_bs, o_rs, B, st)
                 : launch_bf16<128>(q, k, v, out, dout, lse, a, dq, q_bs, q_rs, k_bs, k_rs,
                                    v_bs, v_rs, out_bs, out_rs, o_bs, o_rs, B, st);
}

// f32: lse (natural log) and delta [B, H, Sq]
int k5_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv,
                     long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                     long long v_bs, long long v_rs, long long o_bs, long long o_rs, int B,
                     int Sq, int Sk, int L, int H, int D, float scale_log2, float scale,
                     void* stream) {
  if (bad_dims(B, Sq, Sk, L, H, D)) return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    dout, lse,  delta, dq, dk, dv, q_bs, q_rs, k_bs,
               k_rs, v_bs, v_rs, o_bs, o_rs, Sq,    Sk, L,  H,  scale_log2, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_f32<64>(a, B, st) : launch_f32<128>(a, B, st);
}

const char* k5_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
