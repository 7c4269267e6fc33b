// K4: long-sequence flash attention forward (any S, D = 64), with the row
// log-sum-exp.
//
// Replaces the TPU kernel mipheivit_tpu/ops/attention.py::_flash_kernel,
// launched there by _long_forward (square, S > 512) and _cross_forward
// (rectangular Sq x Sk, the sequence-sharded caller). Same contract, per
// (batch, head) and q row:
//
//   logits = q . k^T / sqrt(D)                  f32, keys >= seq_len_k masked
//   online softmax over key tiles               running max m and sum l, f32
//   out    = (sum_k p_k v_k) / l                in q's dtype
//   lse    = m + ln(l)                          natural-log units, f32
//
// The scale is an argument: a head dim below 64 reaches the kernel zero-
// padded to 64 with the scale of its own D (ops/attention.py).
//
// Layout. q is [B, Sq, H*D], k and v are [B, Sk, H*D]; each has a base
// pointer, a batch stride and a row stride, so the q | k | v sections of one
// fused [B, S, 3*H*D] qkv buffer are read in place (no split copy, no head
// transpose, no padding copy). The head offset h*D lies in the unit-stride
// last dimension. out is written as [B, Sq, H*D], lse as [B, H, Sq] f32.
// Every offset is taken in 64-bit arithmetic: the fused buffer of a batch of
// 16 regions (S = 5334) holds 3.9e8 elements.
//
// What bounds it on the H100. A 1024 px region (S = 5334, H = 24) is
// 4*S^2*D*H = 1.75e11 FLOP per image against 2*S*H*D*2 bytes of q/k/v and
// out per pass: thousands of FLOP per byte, so the floor is the bf16
// tensor-core time (0.18 ms per image at the dense peak). At D = 64 the
// softmax costs about as much as the products: a 64 x 128 tile of logits is
// 8192 exponentials on the special-function unit (16 a clock per SM), the
// same number of clocks as the tile's two products on the tensor cores, so
// the design's work is to run the one under the other.
//
// bf16 design (flash_bf16_kernel, FA3's shape on hopper.cuh): one block per
// (128-row q tile, head, batch item), 2016 blocks at a region pair, three
// warpgroups. One thread of the producer warpgroup (24 registers, given up
// by setmaxnreg) loads the q tile once and streams the K and V tiles of
// 128 keys by TMA (cp.async.bulk.tensor on 3-D maps: head columns, rows,
// batch) into a ring of four stages, each with a full mbarrier for K, one
// for V and an empty one; the 128-byte swizzle TMA writes is the layout
// wgmma reads. Two consumer warpgroups (240 registers) own 64 q rows each:
//
//   S = Q . K_j^T        wgmma m64n128k16, both operands in shared memory
//   m, l, p = exp2(...)  online softmax in registers, log2 units
//   O += P . V_j         wgmma m64n64k16, p rounded to bf16 as the register
//                        A operand, V MN-major
//
// Step j issues S_j and, behind it, P_{j-1} . V_{j-1}, waits for S_j only,
// takes the row max and the exponentials while the product of the previous
// tile runs, and then waits for it before rescaling O: each product is
// waited for within the step that issued it, so no accumulator stays in
// flight across a loop step (where ptxas serialises every wgmma, C7514 /
// C7515). The two warpgroups also take turns to issue their products
// (ping-pong on named barriers, as FA3 does), so that one's exponentials
// run while the other's products hold the tensor cores (at a region pair
// on the H100 a few percent faster than the same kernel without the
// turns). The output is divided by l, written into the warpgroup's q tile
// (done with) and stored by TMA.
//
// Masking. Keys at or past seq_len_k are a suffix: key tiles that hold none
// below seq_len_k are never visited, and the K/V tensor maps end at
// seq_len_k, so TMA fills the rows past it with zeros (padding that holds
// NaN or Inf cannot reach p . v); the remaining masked keys of the last
// tile get -inf before the row max. Every visited tile has at least one
// live key, so the running max is finite from the first tile on and
// exp2(m_old - m_new) never sees (-inf) - (-inf). q rows at or past Sq
// arrive as zeros and the TMA store drops them.
//
// Where p is rounded (bf16 path). The TPU kernel keeps p in f32 for p . v.
// Here p is rounded to bf16 for the second product (relative to the running
// row max), as K1 does: about 2^-9 relative error per probability, averaged
// over the keys; the row sum l and the lse are taken from the f32 p. Against
// the plain version (f32 p) that stays within 2e-2 of unit-scale outputs
// and 1e-3 of the lse. The f32 path keeps p in f32 throughout.
//
// Two paths:
//   bf16  the serving and training path, as above.
//   f32   scalar FMAs with logits and p in shared memory (tests, numerics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block of the f32 path
constexpr int BK = 64;       // keys per K/V tile of the f32 path
constexpr int THREADS = 128; // f32 path
constexpr int LDF = D + 1;   // f32 tile row stride: conflict-free column reads
constexpr float LN2 = 0.6931471805599453f;

static_assert(BK == 64, "the f32 softmax reads two keys per lane");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // batch / row strides in elements
  int Sq, L, H;  // q rows, live keys (seq_len_k)
  float scale;   // log2(e) / sqrt(D)
};

// ---- bf16: warp-specialised wgmma, q / K / V tiles by TMA -------------------

constexpr int QT = 128;                     // q rows per block, 64 per consumer warpgroup
constexpr int KT = 128;                     // keys per K / V tile
constexpr int STAGES = 4;                   // the K / V ring
constexpr int WS_THREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
// registers: 168 a thread at launch; the producer keeps 24, the consumers take 240
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "register file");
constexpr int Q_BYTES = QT * D * 2;         // 16 KB, 128-byte swizzled rows
constexpr int KV_BYTES = KT * D * 2;        // 16 KB each of K and V
constexpr int WG_ROWS_BYTES = 64 * D * 2;   // one consumer's 64 rows of q (later of out)
// named barriers (0 is __syncthreads): each consumer's turn to issue
// products, each consumer's epilogue
constexpr int BAR_TURN = 1, BAR_EPI = 3;
// alignment, q, the ring, the mbarriers (q; full K, full V and empty per stage)
constexpr size_t WS_SMEM = 1024 + (size_t)Q_BYTES + (size_t)STAGES * 2 * KV_BYTES +
                           8 * (1 + 3 * STAGES);

// keeps the compiler from reusing a register operand's registers before
// the products that read it are done
__device__ __forceinline__ void fence_frags(unsigned (&a)[KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// The online softmax of one tile's logits s (64 rows x 128 keys; thread
// (warp, g, tig) holds rows warp*16 + g (+8), keys 8j + 2 tig (+1)), in
// place: keys >= live (the tile's first key is 0) get -inf when mask, the
// running max m (log2 units) and the partial row sums l move on, s becomes
// p = exp2(s * scale - m). Returns the factor exp2(m_old - m_new) of each
// row (0 on the first tile, where m_old = -inf).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool mask, int live,
                                             float scale) {
  const int tig = threadIdx.x & 3;
  if (mask) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + tig * 2 + (e & 1) >= live) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale);  // finite: the tile has a live key
    alpha[r] = ex2_approx(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2_approx(fmaf(s[4 * j + e], scale, neg_m[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
}

__device__ __forceinline__ void pack_p(unsigned (&pa)[KT / 16][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// S = Q . K^T for the warpgroup's 64 rows over one tile of 128 keys (issued)
__device__ __forceinline__ void issue_qk(float (&s)[64], unsigned q_s, unsigned k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128<0, 0>(s, smem_desc(q_s + kk * 32), smem_desc(k_s + kk * 32), kk);
}

// O += P . V over one tile of 128 keys (issued), p as the register operand
__device__ __forceinline__ void issue_pv(float (&o)[32], const unsigned (&pa)[KT / 16][4],
                                        unsigned v_s) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs_n64<1>(o, pa[kk], smem_desc(v_s + kk * 2048), 1);
}

__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, float* __restrict__ lse, int Sq,
                      int L, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const unsigned q_s = base, ring = base + Q_BYTES;
  const unsigned q_bar = ring + STAGES * 2 * KV_BYTES;
  auto k_slot = [&](int st) { return ring + st * 2 * KV_BYTES; };
  auto v_slot = [&](int st) { return ring + st * 2 * KV_BYTES + KV_BYTES; };
  auto full_k = [&](int st) { return q_bar + 8 * (1 + st); };
  auto full_v = [&](int st) { return q_bar + 8 * (1 + STAGES + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + 2 * STAGES + st); };

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_kv = (L + KT - 1) / KT;  // tiles with at least one live key

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // the producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
      tma_load_3d(q_s, &qmap, q_bar, h * D, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        mbar_wait(empty(st), ((j / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_k(st), KV_BYTES);
        tma_load_3d(k_slot(st), &kmap, full_k(st), h * D, j * KT, b);
        mbar_expect_tx(full_v(st), KV_BYTES);
        tma_load_3d(v_slot(st), &vmap, full_v(st), h * D, j * KT, b);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;  // this consumer's rows: q0 + 64 c ..
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const unsigned qw = q_s + c * WG_ROWS_BYTES;
  const int tail = L - (n_kv - 1) * KT;  // live keys of the last tile, 1 .. 128
  const bool ragged = tail < KT;
  // consumer c issues when it holds the turn BAR_TURN + c; the other
  // arrives there once it has issued (consumer 1 once ahead, so that
  // consumer 0 goes first, and not after its last step)
  auto take_turn = [&] { named_sync(BAR_TURN + c, CONSUMERS); };
  auto pass_turn = [&](int j) {
    if (!(c == 1 && j == n_kv - 1)) named_arrive(BAR_TURN + (c ^ 1), CONSUMERS);
  };
  if (c == 1) named_arrive(BAR_TURN, CONSUMERS);

  float o[32], s[64];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  unsigned pa[KT / 16][4];
  mbar_wait(q_bar, 0);

  // step 0: S_0 alone
  mbar_wait(full_k(0), 0);
  take_turn();
  wgmma_fence();
  issue_qk(s, qw, k_slot(0));
  wgmma_commit();
  pass_turn(0);
  wgmma_wait<0>();
  fence_acc(s);
  softmax_tile(s, m, l, alpha, ragged && n_kv == 1, tail, scale);
  pack_p(pa, s);

  // step j: S_j, then P_{j-1} . V_{j-1} behind it; the exponentials of S_j
  // run while the second product does
  for (int j = 1; j < n_kv; ++j) {
    const int st = j % STAGES, prev = (j - 1) % STAGES;
    mbar_wait(full_k(st), (j / STAGES) & 1);
    mbar_wait(full_v(prev), ((j - 1) / STAGES) & 1);
    take_turn();
    wgmma_fence();
    issue_qk(s, qw, k_slot(st));
    wgmma_commit();
    issue_pv(o, pa, v_slot(prev));
    wgmma_commit();
    pass_turn(j);
    wgmma_wait<1>();  // S_j
    fence_acc(s);
    softmax_tile(s, m, l, alpha, ragged && j == n_kv - 1, tail, scale);
    wgmma_wait<0>();  // P_{j-1} . V_{j-1}
    fence_acc(o);
    fence_frags(pa);
    mbar_arrive(empty(prev));  // K_{j-1} and V_{j-1} are done with
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[4 * e] *= alpha[0];
      o[4 * e + 1] *= alpha[0];
      o[4 * e + 2] *= alpha[1];
      o[4 * e + 3] *= alpha[1];
    }
    pack_p(pa, s);
  }
  {  // the last tile's P . V
    const int last = (n_kv - 1) % STAGES;
    mbar_wait(full_v(last), ((n_kv - 1) / STAGES) & 1);
    wgmma_fence();
    issue_pv(o, pa, v_slot(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_frags(pa);
  }

  // O / l, rounded to bf16, into this consumer's q rows (its products are
  // done with them), then one TMA store; rows past Sq are dropped by it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  unsigned char* out_ptr = base_ptr + (qw - base);
  named_sync(BAR_EPI + c, 128);  // every warp's products are done with q
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<unsigned*>(out_ptr + swz(row, j) + tig * 4) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  fence_proxy_async();
  named_sync(BAR_EPI + c, 128);
  if (lt == 0) {
    tma_store_3d(&omap, qw, h * D, q0 + 64 * c, b);
    bulk_commit();
  }
  float* lg = lse + ((long long)b * H + h) * Sq;
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * c + warp * 16 + g + 8 * r;
      if (row < Sq) lg[row] = m[r] * LN2 + logf(l[r]);
    }
  }
  if (lt == 0) bulk_wait_read<0>();  // shared memory stays until the store has read it
}

// ---- f32: scalar FMAs, logits and p in shared memory --------------------------

// 64 rows of D f32 values from global rows r0.. into a padded shared tile;
// rows >= n are zero-filled.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long rs, int r0,
                                              int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LDF + c] = (r0 + r < n) ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

constexpr size_t F32_SMEM = (3 * (size_t)BQ * LDF + 3 * BQ) * sizeof(float);

// Thread -> column c (a key in q . k^T, a head-dim lane in p . v) and rows
// rg + 2*i. Each warp runs the online softmax of 16 rows, a lane holding
// two keys of the tile.
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + BQ * LDF;   // K, then V, of the current tile
  float* sP = sKV + BQ * LDF;   // logits, then p
  float* s_alpha = sP + BQ * LDF;
  float* s_m = s_alpha + BQ;
  float* s_l = s_m + BQ;

  const int L = a.L;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const int c = threadIdx.x % 64, rg = threadIdx.x / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int RPT = BQ / (THREADS / 64);  // rows per thread
  const int n_kv = (L + BK - 1) / BK;

  load_tile_f32(sQ, qg, a.q_rs, q0, a.Sq);
  if (threadIdx.x < BQ) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
  }
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's p . v is done with sKV and sP
    load_tile_f32(sKV, kg, a.k_rs, k0, L);
    __syncthreads();
    {
      float dot[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dot[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = sKV[c * LDF + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dot[i] = fmaf(sQ[(rg + 2 * i) * LDF + d], kv, dot[i]);
      }
      const bool live = k0 + c < L;
#pragma unroll
      for (int i = 0; i < RPT; ++i) sP[(rg + 2 * i) * LDF + c] = live ? dot[i] * a.scale : -INFINITY;
    }
    __syncthreads();
    // online softmax, warp w on rows w*16 .. w*16+15
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float* row = sP + r * LDF;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a live key
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        s_alpha[r] = alpha;
        s_m[r] = m_new;
        s_l[r] = s_l[r] * alpha + sum;
      }
      __syncwarp();
    }
    load_tile_f32(sKV, vg, a.v_rs, k0, L);  // q . k^T is done with K
    __syncthreads();
    const int n = min(BK, L - k0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] *= s_alpha[rg + 2 * i];
    for (int jj = 0; jj < n; ++jj) {
      const float vv = sKV[jj * LDF + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sP[(rg + 2 * i) * LDF + jj], vv, acc[i]);
    }
  }
  __syncthreads();

  const long long hd = (long long)a.H * D;
  float* og = static_cast<float*>(a.out) + (long long)b * a.Sq * hd + h * D;
  float* lg = a.lse + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + 2 * i, row = q0 + r;
    if (row >= a.Sq) continue;
    og[row * hd + c] = acc[i] / s_l[r];
    if (c == 0) lg[row] = s_m[r] * LN2 + logf(s_l[r]);
  }
}

// bf16: the tensor maps (q and out over Sq rows, k and v over the L live
// keys), then one block per (128-row q tile, head, batch item)
int launch_bf16(const Args& a, int B, cudaStream_t st) {
  const long long cols = (long long)a.H * D;
  CUtensorMap qm, km, vm, om;
  int err = encode_rows_bf16(&qm, a.q, cols, a.Sq, B, a.q_rs, a.q_bs, QT);
  if (!err) err = encode_rows_bf16(&km, a.k, cols, a.L, B, a.k_rs, a.k_bs, KT);
  if (!err) err = encode_rows_bf16(&vm, a.v, cols, a.L, B, a.v_rs, a.v_bs, KT);
  if (!err) err = encode_rows_bf16(&om, a.out, cols, a.Sq, B, cols, (long long)a.Sq * cols, 64);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WS_SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_bf16_kernel<<<dim3((a.Sq + QT - 1) / QT, a.H, B), WS_THREADS, WS_SMEM, st>>>(
      qm, km, vm, om, a.lse, a.Sq, a.L, a.H, a.scale);
  return (int)cudaGetLastError();
}

int launch(bool bf16, const void* q, const void* k, const void* v, void* out, float* lse,
           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
           long long v_bs, long long v_rs, int B, int Sq, int Sk, int L, int H, float scale,
           void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || L < 1 || L > Sk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, Sq, L, H, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bf16(a, B, st);
  // Q, K/V and logit tiles + row state: above 48 KB, so opt in
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_f32_kernel<<<grid, THREADS, F32_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int k4_flash_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                  long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                  long long v_bs, long long v_rs, int B, int Sq, int Sk, int L, int H,
                  float scale, void* stream) {
  return launch(true, q, k, v, out, lse, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Sq, Sk, L, H,
                scale, stream);
}

int k4_flash_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                 long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                 long long v_bs, long long v_rs, int B, int Sq, int Sk, int L, int H,
                 float scale, void* stream) {
  return launch(false, q, k, v, out, lse, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Sq, Sk, L, H,
                scale, stream);
}

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
