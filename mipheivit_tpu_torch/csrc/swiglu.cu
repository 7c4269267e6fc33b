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
// K7 replaces mipheivit_tpu/ops/mlp.py::_ln_matmul_kernel (:251), launched by
// _ln_matmul_forward (:262): LN(x) . W^T + b with W the nn.Linear weight
// [N, K], the LN rows rounded to x's dtype, f32 accumulation, the f32 bias,
// one rounding at the output.
//
// What bounds them on the H100. At the flagship fc1 (M = 64 * 329 = 21056,
// K = 1536, H = 4096) one call is 2*M*K*2H = 530 GFLOP against 0.26 GB of x,
// W and the output: ~2000 FLOP/byte, far above the card's ~295, so the floor
// is the bf16 tensor-core time (0.54 ms at the dense peak); at ViT-g's qkv
// projection (K7, N = 4608) 298 GFLOP against 0.27 GB, 0.30 ms. W (25 MB;
// 14 MB) sits in L2, so what a tile can do is bounded by the operand bytes
// it pulls from L2 per product, and by how much of the time the tensor
// cores wait for anything else (loads, the LayerNorm, the epilogue, a last
// wave that leaves SMs idle).
//
// One design serves the three bf16 kernels (gemm_ws_kernel<LN, GATE>): a
// persistent grid of one block per SM walking output tiles of 128 rows x 256
// product columns (K2: 128 value + 128 gate columns; K7: 256 output
// columns), 5280 tiles at the flagship fc1 (40 per SM on 132); a producer
// warp that keeps a ring of four 64-deep stages (128 x rows and two 128-row
// B tiles of W) in flight by TMA, with full and empty mbarriers, so no
// consumer spends an instruction on a load; two consumer warpgroups
// (setmaxnreg: 240 registers) of 64 rows each, which run two wgmma
// m64n128k16 per 16 of depth into two 64-register accumulators (43 FMA per
// byte a stage brings from L2); and an epilogue that writes through shared
// memory and TMA stores while the producer already loads the next tile. Both
// warpgroups work on one tile at a time, so the epilogue's exponentials do
// not run under products: a ping-pong schedule needs 256 accumulator
// registers a thread at this tile, or a tile that brings 1.3 to 1.7 times
// the L2 bytes per product.
//
// The LayerNorm (K2's LN variant, K7). The TPU kernel caches the normed
// [BM, K] block in VMEM; a 128-row block at K = 1536 in bf16 is 384 KB, more
// than an SM's shared memory, and a normed copy in device memory is the
// traffic the fusion exists to avoid. Here a first small kernel of the same
// call computes each row's f32 mean and rstd once (row_stats_kernel, one warp
// per row, 16-byte loads, 8 bytes a row out), and each consumer builds its A
// fragments from the landed, swizzled x tile in registers: ldmatrix, then
// (x * rstd - mean * rstd) * gamma + beta in f32, rounded to bf16 (ln_pair),
// and wgmma with A from registers (RS). Each fragment feeds both 128-column
// products of the tile, so the normalisation is paid once per 256 product
// columns, and the normed rows never touch shared or device memory. The
// fragments are double-buffered (two register sets, the k loop unrolled by
// 2): stage k + 1 is normalised while stage k's products run, then
// wgmma_wait<1>. Registers: 128 accumulators and 2 x 16 fragment registers
// a thread of the 240. (gamma is not folded into W nor beta into the bias:
// that computes another function, rounding W * gamma instead of the normed
// rows, and cancels badly where |mean| >> std.)
//
// K7's epilogue (GATE = false): a tile's second B tile is W's rows n0 + 128
// .. (not H + n0 ..), and the 128 x 256 output tile leaves in two halves of
// 128 columns through the same two 64 x 64 shared-memory boxes a consumer
// owns (f32 bias, one rounding), each by TMA stores that drop rows past M
// and columns past N.
//
// Ragged M (329 tokens per tile is no multiple of any tile size) and ragged
// H, N or K tails: TMA zero-fills rows and columns past the end on load and
// drops them on store. K, H and N are multiples of 8 (TMA moves 16-byte
// rows): the entry points zero-pad other widths, with zero gamma and beta on
// the padded columns of x, and the row statistics run over the true width.
//
// Two paths:
//   bf16  the main path (wgmma, as above);
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
  const float* ln_w;   // [K rounded up to 64] f32, zeros past width; or null: no LayerNorm
  const float* ln_b;   // [K rounded up to 64] f32, zeros past width
  float* stats;        // [2, M] f32: row means, then rstds (row_stats_kernel); with ln_w
  void* out;           // [M, H] contiguous
  int M, K, H;         // H: K2's hidden width, K7's output width N
  int width;           // the LayerNorm's width: K, or less where x comes zero-padded to K
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
// [M, 2M)) over the row's first ``width`` values (the rest are the zero
// padding, kept out of both sums): one warp per row, two passes as _ln_rows
// (the mean, then the mean of squared deviations); bf16 rows are read 16
// bytes at a time (K a multiple of 8, aligned rows), f32 one value at a time.
template <typename T>
__global__ void __launch_bounds__(256) row_stats_kernel(const T* __restrict__ x, long long rs,
                                                        int M, int width, float eps,
                                                        float* __restrict__ stats) {
  constexpr int V = sizeof(T) == 2 ? 8 : 1;  // values per load
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * rs;
  auto sum_over = [&](auto term) {
    float s = 0.f;
    for (int k = lane * V; k < width; k += 32 * V) {
      if constexpr (V == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (k + i < width) s += term(to_f(e[i]));
      } else {
        s += term(to_f(xr[k]));
      }
    }
    return warp_sum(s);
  };
  const float mean = sum_over([](float v) { return v; }) / width;
  const float var = sum_over([mean](float v) { return (v - mean) * (v - mean); }) / width;
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

// ---- bf16: persistent, warp-specialised, TMA-fed (K2, its LN variant, K7) ----

constexpr int TM = 128;             // rows of x per tile: 64 per consumer warpgroup
constexpr int TN = 128;             // columns of one B tile of W (two a stage)
constexpr int TK = 64;              // depth of one stage: one 128-byte swizzled row
constexpr int WS_STAGES = 4;
constexpr int WS_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int WS_CONSUMERS = 256;
// registers: 168 a thread at launch; the producer keeps 24, the consumers take 240
constexpr int WS_PRODUCER_REGS = 24, WS_CONSUMER_REGS = 240;
static_assert(128 * WS_PRODUCER_REGS + WS_CONSUMERS * WS_CONSUMER_REGS <= 65536,
              "register file");
constexpr int WS_A_BYTES = TM * TK * 2;                    // 16 KB
constexpr int WS_B_BYTES = TN * TK * 2;                    // 16 KB each of the two B tiles
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

// keeps an A fragment's registers live up to here: the wgmma that reads them
// runs asynchronously until a wgmma_wait retires it
__device__ __forceinline__ void keep_frag(unsigned (&af)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[kk][i])::"memory");
}

// A persistent grid of one block per SM walks the tiles of 128 rows x 256
// product columns, t = blockIdx.x, + gridDim.x, ..., in row-block-major order
// (the blocks in flight share a few 128-row blocks of x; W stays in L2).
// One producer thread streams each tile's stages (x rows m0.., and W's rows
// n0.. and H + n0.. for K2 or n0 + 128.. for K7, 64 deep) by TMA into a ring
// of four; rows and columns past M, W's rows or K arrive as zeros. Two
// consumer warpgroups take 64 rows each: per 16 of depth two m64n128k16
// products (value and gate, or K7's two column halves) into two 64-register
// accumulators, A from shared memory (SS) or, with LN, from registers
// normalised as they are loaded (RS); one stage's group left in flight while
// the next is prepared and issued. Then the epilogue (f32 bias; K2 silu(a) *
// g; one rounding) into two 64 x 64 boxes of shared memory per consumer and
// TMA stores, which drop rows past M and columns past H (N). The producer
// keeps loading the next tile's stages meanwhile. With LN, ln_w and ln_b
// are f32 [K rounded up to 64] with zeros past the LayerNorm's width, and
// stats the row means then rstds [2, M].
template <bool LN, bool GATE>
__global__ void __launch_bounds__(WS_THREADS, 1)
    gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __nv_bfloat16* __restrict__ bias, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, const float* __restrict__ stats, int M, int K,
                   int H) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const unsigned out_s = base + WS_STAGES * WS_STAGE_BYTES;
  const unsigned bars = out_s + 4 * WS_OUT_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (WS_STAGES + st); };

  constexpr int TILE_N = GATE ? TN : 2 * TN;  // output columns per tile
  const int tid = threadIdx.x;
  const int n_n = (H + TILE_N - 1) / TILE_N, n_k = (K + TK - 1) / TK;
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
        const int m0 = (t / n_n) * TM, n0 = (t % n_n) * TILE_N;
        // K7's second B tile lies past N when the tile's last 128 columns
        // do: it is not loaded (its products land in columns the store drops)
        const bool second = GATE || n0 + TN < H;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % WS_STAGES;
          mbar_wait(empty(st), ((it / WS_STAGES) & 1) ^ 1);  // the first round passes
          const unsigned sb = base + st * WS_STAGE_BYTES;
          mbar_expect_tx(full(st), second ? WS_STAGE_BYTES : WS_A_BYTES + WS_B_BYTES);
          tma_load_3d(sb, &xmap, full(st), kt * TK, m0, 0);
          tma_load_3d(sb + WS_A_BYTES, &wmap, full(st), kt * TK, n0, 0);
          if (second)
            tma_load_3d(sb + WS_A_BYTES + WS_B_BYTES, &wmap, full(st), kt * TK,
                        GATE ? H + n0 : n0 + TN, 0);
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
  const float2* gamma = reinterpret_cast<const float2*>(ln_w);
  const float2* beta = reinterpret_cast<const float2*>(ln_b);
  float acc_a[64], acc_g[64];
  unsigned af0[4][4], af1[4][4];  // LN: the A fragments of two stages
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_n) * TM, n0 = (t % n_n) * TILE_N;
    float rs[2] = {0.f, 0.f}, nm[2] = {0.f, 0.f};  // LN: rstd and -mean * rstd of rows g, g + 8
    if constexpr (LN) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 64 * c + warp * 16 + g + 8 * r;
        if (row < M) {
          rs[r] = stats[M + row];
          nm[r] = -stats[row] * rs[r];
        }
      }
    }
    // one stage: wait for it to land; with LN build its A fragments in af;
    // issue its products; retire the previous stage's (whose fragments are
    // prev) and hand that stage's slot back to the producer
    auto stage = [&](int kt, unsigned (&af)[4][4], unsigned (&prev)[4][4]) {
      const int st = it % WS_STAGES;
      mbar_wait(full(st), (it / WS_STAGES) & 1);
      const unsigned sb = base + st * WS_STAGE_BYTES;
      const unsigned a_s = sb + c * 64 * 128, v_s = sb + WS_A_BYTES, g_s = v_s + WS_B_BYTES;
      if constexpr (LN) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned xr[4];
          ldmatrix_x4(xr, a_s + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
          const int col2 = (kt * TK + kk * 16 + tig * 2) / 2;
          const float2 g0 = __ldg(gamma + col2), b0 = __ldg(beta + col2);
          const float2 g1 = __ldg(gamma + col2 + 4), b1 = __ldg(beta + col2 + 4);
          af[kk][0] = ln_pair(xr[0], rs[0], nm[0], g0, b0);
          af[kk][1] = ln_pair(xr[1], rs[1], nm[1], g0, b0);
          af[kk][2] = ln_pair(xr[2], rs[0], nm[0], g1, b1);
          af[kk][3] = ln_pair(xr[3], rs[1], nm[1], g1, b1);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const int acc = kt > 0 || kk > 0;
        if constexpr (LN) {
          wgmma_rs_n128<0>(acc_a, af[kk], smem_desc(v_s + kk * 32), acc);
          wgmma_rs_n128<0>(acc_g, af[kk], smem_desc(g_s + kk * 32), acc);
        } else {
          const unsigned long long da = smem_desc(a_s + kk * 32);
          wgmma_ss_n128<0, 0>(acc_a, da, smem_desc(v_s + kk * 32), acc);
          wgmma_ss_n128<0, 0>(acc_g, da, smem_desc(g_s + kk * 32), acc);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc_a);
      fence_acc(acc_g);
      if constexpr (LN) keep_frag(prev);
      if (kt > 0) mbar_arrive(empty((it - 1) % WS_STAGES));
      ++it;
    };
    if constexpr (LN) {  // two fragment sets in turn
      int kt = 0;
      for (; kt + 1 < n_k; kt += 2) {
        stage(kt, af0, af1);
        stage(kt + 1, af1, af0);
      }
      if (kt < n_k) stage(kt, af0, af1);
    } else {
      for (int kt = 0; kt < n_k; ++kt) stage(kt, af0, af0);
    }
    wgmma_wait<0>();
    fence_acc(acc_a);
    fence_acc(acc_g);
    if constexpr (LN) {
      keep_frag(af0);
      keep_frag(af1);
    }
    mbar_arrive(empty((it - 1) % WS_STAGES));

    // epilogue into this consumer's two output boxes, once the last store
    // has read them. Thread (warp, g, tig) holds rows warp*16 + g (+8) and,
    // for each 8-column chunk j, columns 8j + 2 tig (+1) of both
    // accumulators.
    if constexpr (GATE) {  // K2: f32 biases, a * sigmoid(a) * g, one rounding
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
    } else {  // K7: f32 bias, one rounding; columns n0.. then n0 + 128..
      auto half = [&](const float(&acc)[64], int col0) {
        if (lt == 0) bulk_wait_read<0>();
        named_sync(WS_BAR_EPI + c, 128);
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int col = col0 + j * 8 + tig * 2;
          float b0 = 0.f, b1 = 0.f;
          if (col < H) {
            b0 = __bfloat162float(bias[col]);
            b1 = __bfloat162float(bias[col + 1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            *reinterpret_cast<unsigned*>(my_out_ptr + (j >> 3) * WS_OUT_BYTES + swz(row, j & 7) +
                                         tig * 4) =
                pack_bf16(acc[4 * j + 2 * r] + b0, acc[4 * j + 2 * r + 1] + b1);
          }
        }
        fence_proxy_async();
        named_sync(WS_BAR_EPI + c, 128);
        if (lt == 0) {
          tma_store_3d(&omap, my_out, col0, m0 + 64 * c, 0);
          if (col0 + 64 < H) tma_store_3d(&omap, my_out + WS_OUT_BYTES, col0 + 64, m0 + 64 * c, 0);
          bulk_commit();
        }
      };
      half(acc_a, n0);
      if (n0 + TN < H) half(acc_g, n0 + TN);
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

// The bf16 kernels: the tensor maps of x [M, K] (row stride x_rs), W (K2's
// packed [2H, K], K7's [N, K]) and out [M, H], then the persistent grid
template <bool LN, bool GATE>
int launch_ws(const Args& a, cudaStream_t st) {
  CUtensorMap xm, wm, om;
  int err = encode_rows_bf16(&xm, a.x, a.K, a.M, 1, a.x_rs, 0, TM);
  if (!err) err = encode_rows_bf16(&wm, a.w, a.K, GATE ? 2LL * a.H : a.H, 1, a.K, 0, TN);
  if (!err) err = encode_rows_bf16(&om, a.out, a.H, a.M, 1, a.H, 0, 64);
  if (err) return err;
  auto kernel = gemm_ws_kernel<LN, GATE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WS_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tile_n = GATE ? TN : 2 * TN;
  const int tiles = ((a.M + TM - 1) / TM) * ((a.H + tile_n - 1) / tile_n);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, WS_THREADS, WS_SMEM, st>>>(xm, wm, om, static_cast<const __nv_bfloat16*>(a.b),
                                            a.ln_w, a.ln_b, a.stats, a.M, a.K, a.H);
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
int launch(bool bf16, bool gate, const Args& a, void* stream) {
  if (a.M < 1 || a.K < 8 || a.H < 8 || a.K % 8 || a.H % 8) return (int)cudaErrorInvalidValue;
  const bool ln = a.ln_w != nullptr;
  if ((a.ln_b != nullptr) != ln || (a.stats != nullptr) != ln) return (int)cudaErrorInvalidValue;
  if (!gate && !ln) return (int)cudaErrorInvalidValue;  // K7 is LN + matmul
  if (ln && (a.width < 1 || a.width > a.K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) {
    const int blocks = (a.M + 7) / 8;
    if (bf16)
      row_stats_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(a.x), a.x_rs, a.M, a.width, a.eps, a.stats);
    else
      row_stats_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(a.x), a.x_rs, a.M,
                                                      a.width, a.eps, a.stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16) {
    if (!ln) return launch_ws<false, true>(a, st);
    return gate ? launch_ws<true, true>(a, st) : launch_ws<true, false>(a, st);
  }
  const int bn = gate ? FBN : 2 * FBN;
  const dim3 grid((a.H + bn - 1) / bn, (a.M + FBM - 1) / FBM);
  if (gate) gemm_f32_kernel<true><<<grid, FTHREADS, 0, st>>>(a);
  else gemm_f32_kernel<false><<<grid, FTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x [M, K] with row
// stride x_rs (unit column stride); w and b contiguous in x's dtype; K and H
// (N) multiples of 8. ln_w / ln_b are both null (no LayerNorm) or both f32
// [K rounded up to 64] with zeros past ``width`` (the LayerNorm's width,
// 1 .. K: the rest of a row of x is zero padding), and stats ([2, M] f32
// scratch for the row statistics) is null exactly when they are.
int k2_swiglu_bf16(const void* x, long long x_rs, const void* w, const void* b,
                   const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                   int H, int width, float eps, void* stream) {
  return launch(true, true, {x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, H, width, eps}, stream);
}

int k2_swiglu_f32(const void* x, long long x_rs, const void* w, const void* b,
                  const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                  int H, int width, float eps, void* stream) {
  return launch(false, true, {x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, H, width, eps},
                stream);
}

// K7: out [M, N] = LN(x) . w^T + b, w [N, K] and b [N] in x's dtype
int k7_ln_matmul_bf16(const void* x, long long x_rs, const void* w, const void* b,
                      const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                      int N, int width, float eps, void* stream) {
  return launch(true, false, {x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, N, width, eps},
                stream);
}

int k7_ln_matmul_f32(const void* x, long long x_rs, const void* w, const void* b,
                     const float* ln_w, const float* ln_b, float* stats, void* out, int M, int K,
                     int N, int width, float eps, void* stream) {
  return launch(false, false, {x, x_rs, w, b, ln_w, ln_b, stats, out, M, K, N, width, eps},
                stream);
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
