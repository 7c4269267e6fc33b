// K2: fused SwiGLU fc1 for the ViT MLP, optionally behind a LayerNorm, and K7:
// the fused LayerNorm + matmul (third entry point, k7_ln_matmul_*).
//
// K2 replaces the TPU kernel mipheivit_tpu/ops/mlp.py::_swiglu_kernel (variants
// _swiglu_kernel_noln and _swiglu_kernel_ln), launched there by
// _swiglu_forward. Same math, per row of x [M, K]:
//
//   xn  = x, or LN(x) with f32 row mean / variance, rounded to x's dtype
//   a   = xn . W1^T + b1        f32 accumulation, f32 bias
//   g   = xn . W2^T + b2        f32 accumulation, f32 bias
//   out = a * sigmoid(a) * g    f32, rounded once to x's dtype
//
// W is the packed nn.Linear weight [2H, K]: rows [0, H) are W1 (the value
// half) and rows [H, 2H) are W2 (the gate half). Each output tile reads both
// halves in place at row offsets n0 and H + n0 (the counterpart of the
// shifted block index maps of _swiglu_forward), so no split copy exists and
// the [M, 2H] product never reaches device memory.
//
// What bounds it on the H100. At the flagship shape (M = 64 * 329 = 21056,
// K = 1536, H = 4096) one call is 2*M*K*2H = 530 GFLOP against 0.26 GB of x,
// W and the output: ~2000 FLOP/byte, far above the card's ~295, so the floor
// is the bf16 tensor-core time (0.54 ms at the dense peak). Both halves of W
// (25 MB) sit in L2, so what a tile can do is bounded by how many operand
// bytes it pulls from L2 per product, and by how much of the time the
// tensor cores wait for anything else (loads, the SwiGLU epilogue, a last
// wave that leaves SMs idle).
//
// The bf16 path without LayerNorm, the one every model path runs
// (swiglu_ws_kernel), answers that with Hopper's own means: a persistent
// grid of one block per SM walking output tiles of 128 rows x (128 value +
// 128 gate) columns (5280 tiles at the flagship shape: 40 per SM on 132,
// where the first design's 3569 blocks made 27.04 waves); a producer warp
// that keeps a ring of four 64-deep stages (x, the value rows, the gate
// rows) in flight by TMA, with full and empty mbarriers, so no consumer
// spends an instruction on a load; two consumer warpgroups (setmaxnreg:
// 240 registers) that run wgmma m64n128k16 from shared memory, 43 FMA per
// byte a stage brings from L2 (the first design's 256 x 192 tile: 55); and
// an epilogue that writes through shared
// memory and a TMA store while the producer already loads the next tile.
// Each consumer owns 64 rows of the tile with both accumulators (128 f32
// registers a thread), so the two warpgroups work on one tile at a time and
// the epilogue's exponentials do not run under products: a schedule where
// each warpgroup owns a tile of its own (ping-pong) needs either 256
// accumulator registers a thread at this tile or a tile that brings 1.3 to
// 1.7 times the L2 bytes per product.
//
// The LayerNorm variant and K7 stay on the first design (gemm_bf16_kernel):
// one block per 256 x (96 + 96) product tile, 55 FMA per byte it loads, two
// warpgroups of two 64-row slabs each, four m64n96k16 products per 16 of
// depth, a 4-slot cp.async ring of 64-deep tiles in the 128-byte swizzled
// layout, one wgmma group in flight while the next stage is issued, the
// epilogue on the registers.
//
// The LayerNorm variant does not cache the normed [BM, K] block as the TPU
// kernel does in VMEM (a 128-row block of K = 1536 in bf16 is 384 KB, more
// than the SM's shared memory): a first small kernel of the same call
// computes each row's f32 mean and rstd once (row_stats_kernel, one warp per
// row, 16-byte loads; the stats were once a prologue of every block, which
// read each row once per 96 output columns, 2 bytes at a time), and every A
// tile is normalised in shared memory after it lands.
//
// K7 replaces mipheivit_tpu/ops/mlp.py::_ln_matmul_kernel (:251), launched by
// _ln_matmul_forward (:262): LN(x) . W^T + b with W the nn.Linear weight
// [N, K], the LN rows rounded to x's dtype, f32 accumulation, the f32 bias,
// one rounding at the output. It is K2's LayerNorm kernel with another
// epilogue (the same template, GATE = false): a block's B tile is W's rows
// n0 .. n0 + 191, one contiguous run, and the two 96-column accumulators
// are written side by side with the bias added. At ViT-g's qkv projection
// (M = 64 * 329, K = 1536, N = 4608) a call is 298 GFLOP against 0.27 GB:
// the floor is the bf16 tensor-core time, 0.30 ms; the design and what it
// leaves for later are K2's.
//
// Ragged M (329 tokens per tile is no multiple of any tile size) and ragged
// H or K tails are masked in the kernel: rows and columns past the end are
// zero-filled on load and not stored.
//
// Two paths:
//   bf16  the main path (wgmma);
//   f32   scalar FMAs on 64 x 64 output tiles (tests and f32 numerics).
//
// A second entry point forms the training backward's elementwise terms in
// one pass (gate_bwd_kernel below); the backward's matmuls run on cuBLAS.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

struct Args {
  const void* x;       // [M, K], row stride x_rs, unit column stride
  long long x_rs;
  const void* w;       // K2: [2H, K]; K7: [H, K] (H = N); contiguous
  const void* b;       // [2H] or [H]
  const float* ln_w;   // [K] f32, or null: no LayerNorm
  const float* ln_b;   // [K] f32
  const float* stats;  // [2, M] f32: row means, then rstds (row_stats_kernel); with ln_w
  void* out;           // [M, H] contiguous
  int M, K, H;         // H: K2's hidden width, K7's output width N
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float swiglu(float a, float g) {
  const float sig = 1.f / (1.f + expf(-a));
  return a * sig * g;
}

// f32 mean and rstd of every row of x [M, K] into stats (means [0, M), rstds
// [M, 2M)): one warp per row, two passes as _ln_rows (the mean, then the
// mean of squared deviations); bf16 rows are read 16 bytes at a time (K a
// multiple of 8, aligned rows), f32 one value at a time.
template <typename T>
__global__ void __launch_bounds__(256) row_stats_kernel(const T* __restrict__ x, long long rs,
                                                        int M, int K, float eps,
                                                        float* __restrict__ stats) {
  constexpr int V = sizeof(T) == 2 ? 8 : 1;  // values per load
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * rs;
  auto sum_over = [&](auto term) {
    float s = 0.f;
    for (int k = lane * V; k < K; k += 32 * V) {
      if constexpr (V == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i) s += term(to_f(e[i]));
      } else {
        s += term(to_f(xr[k]));
      }
    }
    return warp_sum(s);
  };
  const float mean = sum_over([](float v) { return v; }) / K;
  const float var = sum_over([mean](float v) { return (v - mean) * (v - mean); }) / K;
  if (lane == 0) {
    stats[row] = mean;
    stats[M + row] = rsqrtf(var + eps);
  }
}

// The block's rows m0 .. m0 + rows - 1 of the row statistics into shared
// memory (rows past M get 0 and 0)
__device__ __forceinline__ void stage_stats(const Args& a, int m0, int rows, float* mean_s,
                                            float* rstd_s) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool ok = m0 + r < a.M;
    mean_s[r] = ok ? a.stats[m0 + r] : 0.f;
    rstd_s[r] = ok ? a.stats[a.M + m0 + r] : 0.f;
  }
}

// ---- bf16: wgmma GEMM with the SwiGLU epilogue ----------------------------

constexpr int BM = 256;             // rows of x per block: two 64-row slabs per warpgroup
constexpr int BN = 96;              // output columns per block: BN value + BN gate rows of W
constexpr int BK = 64;              // depth of one stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 2;   // stages in flight ahead of the one computed
constexpr int MT = 2;               // 64-row slabs per warpgroup
constexpr int THREADS = 256;        // two warpgroups
constexpr int NR = BN / 2;          // accumulator registers per slab and half
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = 2 * BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, its 1024-byte alignment, and the LayerNorm's row statistics:
// exactly the 227 KB a block may use
constexpr size_t SMEM_BF16 = (size_t)STAGES * STAGE_BYTES + 1024 + 2 * BM * sizeof(float);

static_assert(BM == 2 * MT * 64 && BN % 8 == 0 && (BN * 128) % 1024 == 0, "wgmma tiling");

// K2's LayerNorm variant (GATE) and K7, every A tile normalised after it
// lands. One block per (96 output columns, 256 rows); grid (H / BN, M / BM).
// Warpgroup wg owns rows wg*128 .. +127 of the tile as two 64-row slabs and
// all BN output columns of both halves: per 16 of depth, four m64n96k16
// products into the a and g accumulators (2 x 2 x 48 f32 registers per
// thread). One wgmma group stays in flight while the next stage is issued.
// GATE = false (K7): one block per (192 output columns, 256 rows), grid
// (N / 2BN, M / BM); the "a" and "g" accumulators hold columns n0 .. +95 and
// n0 + 96 .. +191 of one product.
template <bool GATE>
__global__ void __launch_bounds__(THREADS, 1) gemm_bf16_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  float* mean_s = reinterpret_cast<float*>(ring_ptr + STAGES * STAGE_BYTES);
  float* rstd_s = mean_s + BM;

  const int n0 = blockIdx.x * (GATE ? BN : 2 * BN), m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, warp_in_wg = (tid % 128) / 32;
  const int g = lane >> 2, tig = lane & 3;  // accumulator row group / column pair
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int n_k = (a.K + BK - 1) / BK;

  // x rows m0.. and W rows n0.. (value) and H + n0.. (gate) of depth
  // k0..k0+63 into one ring slot, swizzled (K7: W rows n0 .. n0 + 191);
  // out-of-range 16-byte chunks are zero-filled
  auto load_stage = [&](int slot, int k0) {
    const unsigned As = ring + slot * STAGE_BYTES, Bs = As + A_BYTES;
#pragma unroll
    for (int i = tid; i < BM * 8; i += THREADS) {
      const int r = i / 8, c = i % 8;
      const bool ok = m0 + r < a.M && k0 + c * 8 < a.K;
      cp_async16(As + swz(r, c), x + (ok ? (long long)(m0 + r) * a.x_rs + k0 + c * 8 : 0), ok);
    }
#pragma unroll
    for (int i = tid; i < 2 * BN * 8; i += THREADS) {
      const int r = i / 8, c = i % 8;
      const int col = GATE ? n0 + r % BN : n0 + r;
      const long long wrow = GATE ? (long long)(r / BN) * a.H + col : col;
      const bool ok = col < a.H && k0 + c * 8 < a.K;
      cp_async16(Bs + swz(r, c), w + (ok ? wrow * a.K + k0 + c * 8 : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_k) load_stage(s, s * BK);
    cp_async_commit();
  }
  stage_stats(a, m0, BM, mean_s, rstd_s);  // first read after a __syncthreads

  float acc_a[MT][NR], acc_g[MT][NR];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < NR; ++e) acc_a[mt][e] = acc_g[mt][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<AHEAD - 1>();  // this thread's part of stage kt landed
    const int slot = kt % STAGES;
    __syncthreads();  // every thread's part of stage kt landed
    {  // normalise the landed A tile in place, rounded to bf16 (_ln_rows)
      const int k0 = kt * BK;
      unsigned char* As = ring_ptr + slot * STAGE_BYTES;
      for (int i = tid; i < BM * 8; i += THREADS) {
        const int r = i / 8, c = i % 8;
        if (k0 + c * 8 >= a.K) continue;  // the zero-filled tail stays zero
        uint4* p = reinterpret_cast<uint4*>(As + swz(r, c));
        uint4 raw4 = *p;
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw4);
        const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = (__bfloat162float(v[e]) - mu) * rs;
          v[e] = __float2bfloat16(y * a.ln_w[k0 + c * 8 + e] + a.ln_b[k0 + c * 8 + e]);
        }
        *p = raw4;
      }
    }
    // this thread's generic-proxy writes (cp.async, the LayerNorm) become
    // visible to the tensor cores' async proxy; then every thread's are, and
    // every warpgroup has retired its products of stage kt - 2
    fence_proxy_async();
    __syncthreads();
    {
      const int nxt = kt + AHEAD;  // refills the slot of stage kt - 2
      if (nxt < n_k) load_stage(nxt % STAGES, nxt * BK);
      cp_async_commit();
    }
    const unsigned As = ring + slot * STAGE_BYTES, Bs = As + A_BYTES;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fence_acc(acc_a[mt]);
      fence_acc(acc_g[mt]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned long long dv = smem_desc(Bs + kk * 32);
      const unsigned long long dg = smem_desc(Bs + BN * 128 + kk * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned long long da = smem_desc(As + (wg * MT + mt) * 64 * 128 + kk * 32);
        wgmma_ss_n96<0, 0>(acc_a[mt], da, dv, 1);
        wgmma_ss_n96<0, 0>(acc_g[mt], da, dg, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage kt - 1's products done; stage kt's in flight
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fence_acc(acc_a[mt]);
      fence_acc(acc_g[mt]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_acc(acc_a[mt]);
    fence_acc(acc_g[mt]);
  }
  cp_async_wait<0>();

  // epilogue: f32 biases, a * sigmoid(a) * g, one rounding to bf16. Thread
  // (warp w of its warpgroup, g, tig) holds, for each 8-column chunk j,
  // rows w*16 + g (+8) of each slab and columns j*8 + tig*2 (+1).
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.b);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  if (!GATE) {  // K7: acc + f32 bias, one rounding; the two halves side by side
    auto emit = [&](const float (&acc)[NR], int mt, int c0) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + j * 8 + tig * 2;
        if (col >= a.H) continue;
        const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + (wg * MT + mt) * 64 + warp_in_wg * 16 + g + 8 * r;
          if (row >= a.M) continue;
          *reinterpret_cast<unsigned*>(out + (long long)row * a.H + col) =
              pack_bf16(acc[4 * j + 2 * r] + b0, acc[4 * j + 2 * r + 1] + b1);
        }
      }
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      emit(acc_a[mt], mt, n0);
      emit(acc_g[mt], mt, n0 + BN);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + tig * 2;
    if (col >= a.H) continue;
    const float ba0 = __bfloat162float(bias[col]), ba1 = __bfloat162float(bias[col + 1]);
    const float bg0 = __bfloat162float(bias[a.H + col]);
    const float bg1 = __bfloat162float(bias[a.H + col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + (wg * MT + mt) * 64 + warp_in_wg * 16 + g + 8 * r;
        if (row >= a.M) continue;
        const float v0 = swiglu(acc_a[mt][4 * j + 2 * r] + ba0, acc_g[mt][4 * j + 2 * r] + bg0);
        const float v1 =
            swiglu(acc_a[mt][4 * j + 2 * r + 1] + ba1, acc_g[mt][4 * j + 2 * r + 1] + bg1);
        *reinterpret_cast<unsigned*>(out + (long long)row * a.H + col) = pack_bf16(v0, v1);
      }
  }
}

// ---- K2 bf16 without LayerNorm: persistent, warp-specialised, TMA-fed ------

constexpr int TM = 128;             // rows of x per tile: 64 per consumer warpgroup
constexpr int TN = 128;             // output columns per tile: TN value + TN gate rows of W
constexpr int TK = 64;              // depth of one stage: one 128-byte swizzled row
constexpr int WS_STAGES = 4;
constexpr int WS_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int WS_CONSUMERS = 256;
// registers: 168 a thread at launch; the producer keeps 24, the consumers take 240
constexpr int WS_PRODUCER_REGS = 24, WS_CONSUMER_REGS = 240;
static_assert(128 * WS_PRODUCER_REGS + WS_CONSUMERS * WS_CONSUMER_REGS <= 65536,
              "register file");
constexpr int WS_A_BYTES = TM * TK * 2;                    // 16 KB
constexpr int WS_B_BYTES = TN * TK * 2;                    // 16 KB each of value and gate
constexpr int WS_STAGE_BYTES = WS_A_BYTES + 2 * WS_B_BYTES;
constexpr int WS_OUT_BYTES = 64 * 64 * 2;                  // one 64 x 64 output box
constexpr int WS_BAR_EPI = 1;                              // + consumer index
// alignment, the ring, two output boxes per consumer, the mbarriers:
// 230,464 of the 232,448 bytes a block may use
constexpr size_t WS_SMEM = 1024 + (size_t)WS_STAGES * WS_STAGE_BYTES + 4 * (size_t)WS_OUT_BYTES +
                           8 * 2 * WS_STAGES;

__device__ __forceinline__ float swiglu_fast(float a, float g) {
  return a * rcp_approx(1.f + ex2_approx(-1.4426950408889634f * a)) * g;
}

// A persistent grid of one block per SM walks the tiles of 128 rows x 128
// output columns, t = blockIdx.x, + gridDim.x, ..., in row-block-major order
// (the blocks in flight share a few 128-row blocks of x; W, 25 MB at
// ViT-g's fc1, stays in L2). One producer thread streams each tile's stages
// (x rows, the value rows n0.. and the gate rows H + n0.. of W, 64 deep) by
// TMA into a ring of four; rows and columns past M, 2H or K arrive as
// zeros. Two consumer warpgroups take 64 rows each: per 16 of depth a
// m64n128k16 product into the value and one into the gate accumulator
// (2 x 64 f32 registers a thread), one stage's group left in flight while
// the next is issued; then the epilogue (f32 bias, silu(a) * g, one
// rounding) into two 64 x 64 boxes of shared memory and a TMA store, which
// drops rows past M and columns past H. The producer keeps loading the
// next tile's stages meanwhile.
__global__ void __launch_bounds__(WS_THREADS, 1)
    swiglu_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __nv_bfloat16* __restrict__ bias, int M, int K, int H) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const unsigned out_s = base + WS_STAGES * WS_STAGE_BYTES;
  const unsigned bars = out_s + 4 * WS_OUT_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (WS_STAGES + st); };

  const int tid = threadIdx.x;
  const int n_n = (H + TN - 1) / TN, n_k = (K + TK - 1) / TK;
  const int tiles = ((M + TM - 1) / TM) * n_n;

  if (tid == 0) {
    for (int st = 0; st < WS_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), WS_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // the producer: one thread issues every copy
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_n) * TM, n0 = (t % n_n) * TN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % WS_STAGES;
          mbar_wait(empty(st), ((it / WS_STAGES) & 1) ^ 1);  // the first round passes
          const unsigned sb = base + st * WS_STAGE_BYTES;
          mbar_expect_tx(full(st), WS_STAGE_BYTES);
          tma_load_3d(sb, &xmap, full(st), kt * TK, m0, 0);
          tma_load_3d(sb + WS_A_BYTES, &wmap, full(st), kt * TK, n0, 0);
          tma_load_3d(sb + WS_A_BYTES + WS_B_BYTES, &wmap, full(st), kt * TK, H + n0, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<WS_CONSUMER_REGS>();
  const int c = wg - 1;  // this consumer's rows: m0 + 64 c ..
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const unsigned my_out = out_s + c * 2 * WS_OUT_BYTES;
  unsigned char* my_out_ptr = base_ptr + (my_out - base);
  float acc_a[64], acc_g[64];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_n) * TM, n0 = (t % n_n) * TN;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int st = it % WS_STAGES;
      mbar_wait(full(st), (it / WS_STAGES) & 1);
      const unsigned sb = base + st * WS_STAGE_BYTES;
      const unsigned a_s = sb + c * 64 * 128, v_s = sb + WS_A_BYTES, g_s = v_s + WS_B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const unsigned long long da = smem_desc(a_s + kk * 32);
        wgmma_ss_n128<0, 0>(acc_a, da, smem_desc(v_s + kk * 32), kt > 0 || kk > 0);
        wgmma_ss_n128<0, 0>(acc_g, da, smem_desc(g_s + kk * 32), kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc_a);
      fence_acc(acc_g);
      if (kt > 0) mbar_arrive(empty((it - 1) % WS_STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc_a);
    fence_acc(acc_g);
    mbar_arrive(empty((it - 1) % WS_STAGES));

    // epilogue: f32 biases, a * sigmoid(a) * g, one rounding to bf16, into
    // this consumer's two output boxes once the last store has read them.
    // Thread (warp, g, tig) holds rows warp*16 + g (+8) and, for each
    // 8-column chunk j, columns 8j + 2 tig (+1) of both accumulators.
    if (lt == 0) bulk_wait_read<0>();
    named_sync(WS_BAR_EPI + c, 128);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;
      float ba0 = 0.f, ba1 = 0.f, bg0 = 0.f, bg1 = 0.f;
      if (col < H) {
        ba0 = __bfloat162float(bias[col]);
        ba1 = __bfloat162float(bias[col + 1]);
        bg0 = __bfloat162float(bias[H + col]);
        bg1 = __bfloat162float(bias[H + col + 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const float v0 = swiglu_fast(acc_a[4 * j + 2 * r] + ba0, acc_g[4 * j + 2 * r] + bg0);
        const float v1 =
            swiglu_fast(acc_a[4 * j + 2 * r + 1] + ba1, acc_g[4 * j + 2 * r + 1] + bg1);
        *reinterpret_cast<unsigned*>(my_out_ptr + (j >> 3) * WS_OUT_BYTES + swz(row, j & 7) +
                                     tig * 4) = pack_bf16(v0, v1);
      }
    }
    fence_proxy_async();
    named_sync(WS_BAR_EPI + c, 128);
    if (lt == 0) {
      tma_store_3d(&omap, my_out, n0, m0 + 64 * c, 0);
      tma_store_3d(&omap, my_out + WS_OUT_BYTES, n0 + 64, m0 + 64 * c, 0);
      bulk_commit();
    }
  }
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

// K2 bf16 without LayerNorm: the tensor maps of x [M, K] (row stride
// x_rs), the packed W [2H, K] and out [M, H], then the persistent grid
int launch_swiglu_ws(const Args& a, cudaStream_t st) {
  CUtensorMap xm, wm, om;
  int err = encode_rows_bf16(&xm, a.x, a.K, a.M, 1, a.x_rs, 0, TM);
  if (!err) err = encode_rows_bf16(&wm, a.w, a.K, 2LL * a.H, 1, a.K, 0, TN);
  if (!err) err = encode_rows_bf16(&om, a.out, a.H, a.M, 1, a.H, 0, 64);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      swiglu_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WS_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((a.M + TM - 1) / TM) * ((a.H + TN - 1) / TN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  swiglu_ws_kernel<<<grid, WS_THREADS, WS_SMEM, st>>>(
      xm, wm, om, static_cast<const __nv_bfloat16*>(a.b), a.M, a.K, a.H);
  return (int)cudaGetLastError();
}

// ---- f32 (tests): scalar FMAs --------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int FTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs of each half

// GATE = false (K7): the "a" and "g" accumulators hold columns n0 .. +63 and
// n0 + 64 .. +127 of one product, grid (N / 2FBN, M / FBM).
template <bool GATE>
__global__ void __launch_bounds__(FTHREADS) gemm_f32_kernel(Args a) {
  __shared__ float As[FBK][FBM + 4];  // depth-major: broadcast reads along rows
  __shared__ float Bv[FBK][FBN + 4];
  __shared__ float Bg[FBK][FBN + 4];
  __shared__ float mean_s[FBM], rstd_s[FBM];

  const int n0 = blockIdx.x * (GATE ? FBN : 2 * FBN), m0 = blockIdx.y * FBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const bool ln = a.ln_w != nullptr;
  if (ln) stage_stats(a, m0, FBM, mean_s, rstd_s);
  __syncthreads();
  // W rows of the two B tiles: value and gate halves (K2), or two runs of
  // FBN rows (K7)
  const long long row_v = n0, row_g = GATE ? (long long)a.H + n0 : n0 + FBN;
  const int lim_v = a.H - n0, lim_g = GATE ? a.H - n0 : a.H - n0 - FBN;

  float acc_a[4][4], acc_g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_g[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += FBK) {
    for (int i = threadIdx.x; i < FBM * FBK; i += FTHREADS) {
      const int r = i / FBK, c = i % FBK, row = m0 + r, k = k0 + c;
      float v = 0.f;
      if (row < a.M && k < a.K) {
        v = x[(long long)row * a.x_rs + k];
        if (ln) v = (v - mean_s[r]) * rstd_s[r] * a.ln_w[k] + a.ln_b[k];
      }
      As[c][r] = v;
    }
    for (int i = threadIdx.x; i < FBN * FBK; i += FTHREADS) {
      const int r = i / FBK, c = i % FBK, k = k0 + c;
      Bv[c][r] = r < lim_v && k < a.K ? w[(row_v + r) * a.K + k] : 0.f;
      Bg[c][r] = r < lim_g && k < a.K ? w[(row_g + r) * a.K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float av[4], bv[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        bv[i] = Bv[kk][tx * 4 + i];
        bg[i] = Bg[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[i][j] = fmaf(av[i], bv[j], acc_a[i][j]);
          acc_g[i][j] = fmaf(av[i], bg[j], acc_g[i][j]);
        }
    }
    __syncthreads();
  }

  const float* bias = static_cast<const float*>(a.b);
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= a.M) continue;
    float* orow = out + (long long)row * a.H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (GATE) {
        if (col < a.H) orow[col] = swiglu(acc_a[i][j] + bias[col], acc_g[i][j] + bias[a.H + col]);
      } else {
        if (col < a.H) orow[col] = acc_a[i][j] + bias[col];
        if (col + FBN < a.H) orow[col + FBN] = acc_g[i][j] + bias[col + FBN];
      }
    }
  }
}

// The backward's elementwise terms (mipheivit_tpu/ops/mlp.py::_swiglu_bwd_rule,
// which XLA fuses on the TPU): from the recomputed ag = a | g [M, 2H] and the
// output gradient dh [M, H], both in x's dtype and contiguous, in f32
//
//   s = sigmoid(a), silu = a * s
//   da = dh * g * (s + silu * (1 - s)),  dg = dh * silu
//
// rounded once into dc = da | dg [M, 2H]. One pass of 16-byte vectors reads
// ag and dh once and writes dc once; eager PyTorch formed the same terms in
// about a dozen f32 passes over [M, H].
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256) gate_bwd_kernel(const T* __restrict__ ag,
                                                       const T* __restrict__ dh,
                                                       T* __restrict__ dc, long long M, int H) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int hv = H / V;
  const long long n = M * hv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / hv;
    const long long c = (i - row * hv) * V;
    const uint4 ua = *reinterpret_cast<const uint4*>(ag + row * 2 * H + c);
    const uint4 ug = *reinterpret_cast<const uint4*>(ag + row * 2 * H + H + c);
    const uint4 ud = *reinterpret_cast<const uint4*>(dh + row * H + c);
    const T* va = reinterpret_cast<const T*>(&ua);
    const T* vg = reinterpret_cast<const T*>(&ug);
    const T* vd = reinterpret_cast<const T*>(&ud);
    uint4 uda, udg;
    T* pda = reinterpret_cast<T*>(&uda);
    T* pdg = reinterpret_cast<T*>(&udg);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a = to_f(va[j]), g = to_f(vg[j]), d = to_f(vd[j]);
      const float s = 1.f / (1.f + expf(-a));
      const float silu = a * s;
      pda[j] = from_f<T>(d * g * (s + silu * (1.f - s)));
      pdg[j] = from_f<T>(d * silu);
    }
    *reinterpret_cast<uint4*>(dc + row * 2 * H + c) = uda;
    *reinterpret_cast<uint4*>(dc + row * 2 * H + H + c) = udg;
  }
}

int launch_gate_bwd(bool bf16, const void* ag, const void* dh, void* dc, long long M, int H,
                    void* stream) {
  if (M < 1 || H < 8 || H % 8) return (int)cudaErrorInvalidValue;
  const long long n = M * (H / (bf16 ? 8 : 4));
  const long long want = (n + 255) / 256, cap = 132LL * 16;  // 16 blocks per SM, then stride
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    gate_bwd_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(ag), static_cast<const __nv_bfloat16*>(dh),
        static_cast<__nv_bfloat16*>(dc), M, H);
  else
    gate_bwd_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(ag),
                                                   static_cast<const float*>(dh),
                                                   static_cast<float*>(dc), M, H);
  return (int)cudaGetLastError();
}

// K2 (gate) or K7, bf16 or f32; with ln_w the row statistics first
int launch(bool bf16, bool gate, const void* x, long long x_rs, const void* w, const void* b,
           const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K, int H,
           float eps, void* stream) {
  if (M < 1 || K < 8 || H < 8 || K % 8 || H % 8) return (int)cudaErrorInvalidValue;
  if ((ln_w == nullptr) != (ln_b == nullptr) || (ln_w != nullptr) != (stats != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!gate && ln_w == nullptr) return (int)cudaErrorInvalidValue;  // K7 is LN + matmul
  const Args a{x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, H, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln_w != nullptr) {
    const int blocks = (M + 7) / 8;
    if (bf16)
      row_stats_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), x_rs, M, K, eps, stats);
    else
      row_stats_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), x_rs, M, K,
                                                      eps, stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16 && ln_w == nullptr) return launch_swiglu_ws(a, st);
  if (bf16) {  // with the LayerNorm: K2's LN variant and K7
    auto kernel = gate ? gemm_bf16_kernel<true> : gemm_bf16_kernel<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    const int bn = gate ? BN : 2 * BN;
    const dim3 grid((H + bn - 1) / bn, (M + BM - 1) / BM);
    kernel<<<grid, THREADS, SMEM_BF16, st>>>(a);
  } else {
    const int bn = gate ? FBN : 2 * FBN;
    const dim3 grid((H + bn - 1) / bn, (M + FBM - 1) / FBM);
    if (gate) gemm_f32_kernel<true><<<grid, FTHREADS, 0, st>>>(a);
    else gemm_f32_kernel<false><<<grid, FTHREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). ln_w / ln_b are
// both null (no LayerNorm) or both f32 [K], and stats ([2, M] f32 scratch for
// the row statistics) is null exactly when they are.
int k2_swiglu_bf16(const void* x, long long x_rs, const void* w, const void* b,
                   const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                   int H, float eps, void* stream) {
  return launch(true, true, x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, H, eps, stream);
}

int k2_swiglu_f32(const void* x, long long x_rs, const void* w, const void* b,
                  const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                  int H, float eps, void* stream) {
  return launch(false, true, x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, H, eps, stream);
}

// K7: out [M, N] = LN(x) . w^T + b, w [N, K] and b [N] in x's dtype
int k7_ln_matmul_bf16(const void* x, long long x_rs, const void* w, const void* b,
                      const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                      int N, float eps, void* stream) {
  return launch(true, false, x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, N, eps, stream);
}

int k7_ln_matmul_f32(const void* x, long long x_rs, const void* w, const void* b,
                     const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                     int N, float eps, void* stream) {
  return launch(false, false, x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, N, eps, stream);
}

// The backward's elementwise terms: ag [M, 2H], dh [M, H] and dc [M, 2H],
// contiguous, 16-byte aligned, one dtype; H a multiple of 8.
int k2_swiglu_bwd_gate_bf16(const void* ag, const void* dh, void* dc, long long M, int H,
                            void* stream) {
  return launch_gate_bwd(true, ag, dh, dc, M, H, stream);
}

int k2_swiglu_bwd_gate_f32(const void* ag, const void* dh, void* dc, long long M, int H,
                           void* stream) {
  return launch_gate_bwd(false, ag, dh, dc, M, H, stream);
}

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
