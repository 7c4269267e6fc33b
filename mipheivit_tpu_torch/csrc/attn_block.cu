// K8: the fused ViT attention sublayer, LayerNorm -> qkv projection -> softmax
// attention, for one head of one batch item at a time (Dh = 64).
//
// Replaces the TPU kernel mipheivit_tpu/ops/attn_block.py::_ln_qkv_attn_kernel
// (:32), launched by _fused_forward (:68). Same function, per batch item and
// head h, x [S, D], W the nn.Linear qkv weight [3*H*Dh, D] (q | k | v rows):
//
//   xn     = LN(x), f32 row mean and variance, rounded to W's (= x's) dtype
//   q|k|v  = xn . W_h^T + b_h       f32 accumulation, f32 bias, one rounding
//   s      = (q . k^T) * log2(e)/sqrt(Dh)       f32
//   p      = exp2(s - rowmax), l = rowsum(p)    f32, the exact row max
//   out    = (cast(p, v.dtype) . v) / l          f32 accumulation, divided after
//
// written as [B, S, H*Dh], before the output projection. Like the TPU
// kernel it keeps the normed activations and the [S, 3*H*Dh] qkv buffer out
// of device memory. (Head dims below 64 arrive zero-padded to 64 by the
// caller, with the scale of their own Dh; D not a multiple of 8 arrives
// zero-padded to one, with zero gamma and beta there, and the row statistics
// run over the true width.)
//
// The TPU design does not carry over: it holds the whole 14 MB bf16 qkv
// weight in VMEM and projects all heads at once; an SM has 227 KB. Here a
// block owns one head and projects only that head's 192 weight rows.
//
// What bounds it on the H100. At ViT-g (B = 64, S = 329, D = 1536, 24 heads)
// a call is 298.1 GFLOP of projection and 42.6 of attention against 0.14 GB
// of device memory (x read once, the output written once): the floor is the
// tensor-core time, 0.34 ms. What a block can do is bounded by the operand
// bytes it pulls from L2 per product: each block reads its batch item's x
// rows and its head's weight rows from L2, 2.9 MB for 226 MFLOP at S = 329
// (77 FLOP a byte), 4.5 GB a call.
//
// The bf16 design (block_bf16_kernel), warp-specialised as K2's:
//   * a cluster of CL blocks per (head, batch item), CL = ceil(S / 384):
//     block r owns key tiles [r*tpb, r*tpb + tpb) of 64 rows (tpb <= 6), and
//     keeps q, k and v of its rows in shared memory in the 128-byte swizzled
//     layout (144 KB at 384 rows), so the projection is done once;
//   * phase 1, the projection: a producer warp streams stages of the x rows
//     of a pair of tiles (a 128 x 64 box) and the head's q, k and v weight
//     rows (three 64 x 64 boxes) by TMA into a ring of two, with full and
//     empty mbarriers; rows past S and columns past D arrive as zeros. Two
//     consumer warpgroups (setmaxnreg: 240 registers) take 64 rows each:
//     each loads its x rows from the stage into the A fragment layout
//     (ldmatrix), applies (x - mean) * rstd * gamma + beta in registers from
//     the row statistics of a first small kernel (row_stats_kernel, 8 bytes
//     a row), rounds to bf16 and runs wgmma m64n192k16 with A from those
//     registers and B the weight stage; the epilogue adds the f32 bias,
//     rounds once and writes q, k and v of the tile into shared memory;
//   * phase 2, the attention, after a cluster barrier: the consumers take
//     the block's q tiles in turn, each as K1 does on wgmma (s = q . k^T
//     with both operands in shared memory, p . v with p from registers),
//     in two passes over all S keys: the exact row max first, then p, l and
//     p . v. A key tile another block of the cluster holds is copied from
//     its shared memory (distributed shared memory) into a staging buffer
//     in the ring's space, two buffers a warpgroup. The last key tile is cut
//     to the live keys rounded up to 16; its keys past S, which LayerNorm
//     made from zero rows into beta . W + b rather than 0, are masked.
//
// At S = 329 that is one block per (head, batch item), 1536 blocks at 64
// tiles on 132 SMs, one block an SM (230 KB), so an SM runs a block's
// projection and its attention in turn; at S = 1024 clusters of three, 288
// blocks at 4 tiles: 2.2 waves, the last 18 % full, and each q tile reads
// about 10 of its 16 key tiles (twice for K, once for V) from a
// neighbour. (scripts/profile_k8_parts_torch.py times the projection alone
// and the normalisation's share.) Multicasting each weight stage to a cluster of two batch items
// (30 % fewer L2 bytes a stage) was measured slower on the H100, the
// coupled blocks waiting on each other's consumers, and is not built;
// multicasting the x stages across the heads of a batch item is untried.
//
// Two paths:
//   bf16  the main path, as above;
//   f32   scalar FMAs (tests and f32 numerics): one block per (64 query rows,
//         head, batch item) that projects q, then k and v 32 keys at a time,
//         with an online softmax (in f32, p is not rounded, so only the
//         order of the sums differs from the exact max).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int DH = 64;            // head dim
constexpr int BR = 64;            // rows of a tile
constexpr int MAX_S = 1024;
constexpr int TILE = BR * DH * 2;               // a 64-row tile of 64 bf16 values: 8 KB
constexpr int MAX_TPB = 6;                      // key tiles a block holds: 384 rows
constexpr int X_BYTES = 2 * TILE;               // a stage's x box: 128 rows x 64 deep
constexpr int W_BYTES = 3 * TILE;               // the head's q, k and v weight rows x 64 deep
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;  // 40 KB
constexpr int STAGES = 2;
constexpr int THREADS = 384;                    // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
// registers: the producer keeps 24, the consumers take 240
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "register file");
constexpr int STAGING_BYTES = 4 * TILE;         // per consumer: two buffers of a K and a V tile
static_assert(2 * STAGING_BYTES <= STAGES * STAGE_BYTES, "remote key tiles stage in the ring");

struct Args {
  const void* x;        // [B, S, D], batch stride x_bs, row stride x_rs, unit column stride
  long long x_bs, x_rs;
  const float* ln_w;    // [D rounded up to 64] f32, zeros past D
  const float* ln_b;    // [D rounded up to 64] f32, zeros past D
  const void* w;        // [3*H*DH, D] contiguous, x's dtype
  const void* b;        // [3*H*DH], x's dtype
  float* stats;         // [2, B*S] f32 scratch: row means, then rstds
  void* out;            // [B, S, H*DH] contiguous
  int B, S, D, H;
  int width;            // the LayerNorm's width: D, or less where x comes zero-padded to D
  float eps;
  float scale;          // log2(e) / sqrt(Dh)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// f32 mean and rstd of every row of x [B, S, D] into stats (means [0, B*S),
// rstds [B*S, 2*B*S)) over the row's first ``width`` values (the rest are
// the zero padding, kept out of both sums): one warp per row, two passes as
// _ln_rows (the mean, then the mean of squared deviations); bf16 rows are
// read 16 bytes at a time, f32 one value at a time.
template <typename T>
__global__ void __launch_bounds__(256) row_stats_kernel(Args a) {
  constexpr int V = sizeof(T) == 2 ? 8 : 1;  // values per load
  const int i = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = a.B * a.S;
  if (i >= n) return;
  const T* xr = static_cast<const T*>(a.x) + (long long)(i / a.S) * a.x_bs +
                (long long)(i % a.S) * a.x_rs;
  auto sum_over = [&](auto term) {
    float s = 0.f;
    for (int k = lane * V; k < a.width; k += 32 * V) {
      if constexpr (V == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (k + j < a.width) s += term(to_f(e[j]));
      } else {
        s += term(to_f(xr[k]));
      }
    }
    return warp_sum(s);
  };
  const float mean = sum_over([](float v) { return v; }) / a.width;
  const float var = sum_over([mean](float v) { return (v - mean) * (v - mean); }) / a.width;
  if (lane == 0) {
    a.stats[i] = mean;
    a.stats[n + i] = rsqrtf(var + a.eps);
  }
}

// ---- bf16: warp-specialised, TMA-fed wgmma, clusters of CL blocks ---------------

// the 1024-byte alignment, q, k and v of the block's tpb tiles, the ring,
// the mbarriers: 230,432 bytes at tpb = 6
inline size_t smem_bf16(int tpb) {
  return 1024 + 3 * (size_t)tpb * TILE + (size_t)STAGES * STAGE_BYTES + 8 * 2 * STAGES;
}

// pass 1 over one tile of N keys (key0 the first): the row max of the
// scaled logits of the live keys
template <int N>
__device__ __forceinline__ void k8_max(float (&m)[2], unsigned q_s, unsigned k_s, int key0, int S,
                                       float scale) {
  float s[N / 2];
  qk_tile<N>(s, q_s, k_s);
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + j * 8 + tig * 2 + (e & 1) < S) m[e >> 1] = fmaxf(m[e >> 1], s[4 * j + e] * scale);
}

// pass 2 over the same tile: s again, p = exp2(s - m) and its f32 row sum
// l, o += bf16(p) . v
template <int N>
__device__ __forceinline__ void k8_pv(float (&o)[32], float (&l)[2], const float (&m)[2],
                                      unsigned q_s, unsigned k_s, unsigned v_s, int key0, int S,
                                      float scale) {
  float s[N / 2];
  qk_tile<N>(s, q_s, k_s);
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + tig * 2 + (e & 1);
      s[4 * j + e] = key < S ? exp2f(s[4 * j + e] * scale - m[e >> 1]) : 0.f;
      l[e >> 1] += s[4 * j + e];
    }
  unsigned pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  pv_tile<N>(o, pa, v_s);
}

// 8 KB (a tile) from block ``owner`` of the cluster, at the same offset as
// ``src`` here, into this block's shared memory at ``dst``; the warpgroup's
// 128 threads, 16 bytes a load
__device__ __forceinline__ void copy_from(unsigned dst, unsigned src, unsigned owner) {
  const unsigned from = map_rank(src, owner), lt = threadIdx.x % 128;
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld_cluster_v4(from + (lt + 128 * i) * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) st_shared_v4(dst + (lt + 128 * i) * 16, v[i]);
}

// grid (CL*H, B), clusters of CL blocks along x: block rank r of the cluster
// for head blockIdx.x / CL of batch item blockIdx.y owns the rows of key
// tiles [r*tpb, r*tpb + tpb).
template <int CL>
__global__ void __launch_bounds__(THREADS, 1)
    block_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, Args a, int tpb) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int h = blockIdx.x / CL, bi = blockIdx.y, S = a.S;
  const int n_kt = (S + BR - 1) / BR, t0 = rank * tpb;
  const int live = min(tpb, n_kt - t0);  // this block's tiles with rows < S
  const int n_pairs = (live + 1) / 2, n_k = (a.D + 63) / 64;
  const long long HD = (long long)a.H * DH;
  const unsigned q_s = base, k_s = q_s + tpb * TILE, v_s = k_s + tpb * TILE;
  const unsigned ring = v_s + tpb * TILE, bars = ring + STAGES * STAGE_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  const int tid = threadIdx.x, wg = warpgroup();

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the barrier between the projection and the attention (all threads of
  // the cluster), and the one after the attention: the cluster is done
  // reading this block's k and v
  auto phase_sync = [] {
    if constexpr (CL > 1)
      cluster_sync();
    else
      __syncthreads();
  };

  // 1. q, k and v of the block's rows into shared memory
  if (wg == 0) {  // the producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      int it = 0;
      for (int p = 0; p < n_pairs; ++p) {
        const int row0 = (t0 + 2 * p) * BR;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);  // the first round passes
          const unsigned sb = ring + st * STAGE_BYTES;
          mbar_expect_tx(full(st), STAGE_BYTES);
          tma_load_3d(sb, &xmap, full(st), kt * 64, row0, bi);
          for (int sec = 0; sec < 3; ++sec)
            tma_load_3d(sb + X_BYTES + sec * TILE, &wmap, full(st), kt * 64, sec * HD + h * DH, 0);
        }
      }
    }
    __syncwarp();
    phase_sync();
    if constexpr (CL > 1) cluster_sync();
    return;
  }

  {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, lt = tid % 128, warp = lt / 32, lane = tid % 32;
    const int g = lane >> 2, tig = lane & 3;
    const float2* gamma = reinterpret_cast<const float2*>(a.ln_w);
    const float2* beta = reinterpret_cast<const float2*>(a.ln_b);
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.b);
    const int n = a.B * S;
    float acc[96];
    int it = 0;
    for (int p = 0; p < n_pairs; ++p) {
      const int tl = 2 * p + c;  // this consumer's tile of the pair
      const bool mine = tl < live;
      float rs[2], nm[2];  // rows warp*16 + g and + 8: rstd and -mean * rstd
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (t0 + tl) * BR + warp * 16 + g + 8 * r;
        const bool ok = mine && row < S;
        const float mean = ok ? a.stats[bi * S + row] : 0.f;
        rs[r] = ok ? a.stats[n + bi * S + row] : 0.f;
        nm[r] = -mean * rs[r];
      }
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(full(st), (it / STAGES) & 1);
        if (mine) {
          const unsigned sb = ring + st * STAGE_BYTES, xs = sb + c * TILE;
          unsigned af[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            unsigned raw[4];
            ldmatrix_x4(raw, xs + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
            const int col2 = (kt * 64 + kk * 16 + tig * 2) / 2;
            const float2 g0 = __ldg(gamma + col2), b0 = __ldg(beta + col2);
            const float2 g1 = __ldg(gamma + col2 + 4), b1 = __ldg(beta + col2 + 4);
            af[kk][0] = ln_pair(raw[0], rs[0], nm[0], g0, b0);
            af[kk][1] = ln_pair(raw[1], rs[1], nm[1], g0, b0);
            af[kk][2] = ln_pair(raw[2], rs[0], nm[0], g1, b1);
            af[kk][3] = ln_pair(raw[3], rs[1], nm[1], g1, b1);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n192<0>(acc, af[kk], smem_desc(sb + X_BYTES + kk * 32), kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
        }
        mbar_arrive(empty(st));
      }
      if (mine) {
        // f32 bias, one rounding, into the tile's q, k and v: thread (warp,
        // g, tig) holds rows warp*16 + g (+8) and, for each 8-column chunk
        // j of q | k | v, columns 8j + 2 tig (+1)
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          const int sec = j / 8, col = (j % 8) * 8 + tig * 2;
          const long long bcol = sec * HD + h * DH + col;
          const float b0 = __bfloat162float(bias[bcol]), b1 = __bfloat162float(bias[bcol + 1]);
          const unsigned dst = (sec == 0 ? q_s : sec == 1 ? k_s : v_s) + tl * TILE;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared_u32(dst + swz(warp * 16 + g + 8 * r, j % 8) + tig * 4,
                          pack_bf16(acc[4 * j + 2 * r] + b0, acc[4 * j + 2 * r + 1] + b1));
        }
      }
    }
    fence_proxy_async();
  }
  phase_sync();  // every block's q, k and v are in place

  // 2. the attention of the block's q tiles over all keys
  {
    const int c = wg - 1, lt = tid % 128, warp = lt / 32, lane = tid % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int c_last = n_kt - 1, tail = (S - BR * c_last + 15) / 16 * 16;
    const unsigned stg = ring + c * STAGING_BYTES;
    int staged = 0;
    // key tile t (with its V tile when with_v): in place, or copied from the
    // block of the cluster that holds it into one of two staging buffers
    auto key_tile = [&](int t, bool with_v, unsigned& ks, unsigned& vs) {
      const int owner = t / tpb, local = t % tpb;
      ks = k_s + local * TILE;
      vs = v_s + local * TILE;
      if (CL == 1 || owner == rank) return;
      const unsigned buf = stg + (staged++ & 1) * 2 * TILE;
      copy_from(buf, ks, owner);
      if (with_v) copy_from(buf + TILE, vs, owner);
      fence_proxy_async();
      named_sync(1 + c, 128);
      ks = buf;
      vs = buf + TILE;
    };
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + (long long)bi * S * HD + h * DH;
    for (int tl = c; tl < live; tl += 2) {
      const unsigned qt = q_s + tl * TILE;
      unsigned ks, vs;
      float m[2] = {-INFINITY, -INFINITY};
      for (int t = 0; t < c_last; ++t) {
        key_tile(t, false, ks, vs);
        k8_max<64>(m, qt, ks, t * BR, S, a.scale);
      }
      key_tile(c_last, false, ks, vs);
      switch (tail) {
        case 16: k8_max<16>(m, qt, ks, c_last * BR, S, a.scale); break;
        case 32: k8_max<32>(m, qt, ks, c_last * BR, S, a.scale); break;
        case 48: k8_max<48>(m, qt, ks, c_last * BR, S, a.scale); break;
        default: k8_max<64>(m, qt, ks, c_last * BR, S, a.scale); break;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      }
      float o[32], l[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] = 0.f;
      for (int t = 0; t < c_last; ++t) {
        key_tile(t, true, ks, vs);
        k8_pv<64>(o, l, m, qt, ks, vs, t * BR, S, a.scale);
      }
      key_tile(c_last, true, ks, vs);
      switch (tail) {
        case 16: k8_pv<16>(o, l, m, qt, ks, vs, c_last * BR, S, a.scale); break;
        case 32: k8_pv<32>(o, l, m, qt, ks, vs, c_last * BR, S, a.scale); break;
        case 48: k8_pv<48>(o, l, m, qt, ks, vs, c_last * BR, S, a.scale); break;
        default: k8_pv<64>(o, l, m, qt, ks, vs, c_last * BR, S, a.scale); break;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (t0 + tl) * BR + warp * 16 + g + 8 * r;
        if (row >= S) continue;
        const float inv = 1.f / l[r];
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<unsigned*>(og + row * HD + j * 8 + tig * 2) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
  if constexpr (CL > 1) cluster_sync();
}

// K8 bf16 with clusters of CL blocks: launched with the cluster dimension
template <int CL>
int launch_bf16(const Args& a, const CUtensorMap& xm, const CUtensorMap& wm, int tpb,
                cudaStream_t st) {
  const size_t smem = smem_bf16(tpb);
  cudaError_t e = cudaFuncSetAttribute(block_bf16_kernel<CL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, block_bf16_kernel<CL>, xm, wm, a, tpb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- f32 (tests): scalar FMAs -------------------------------------------------

constexpr int FKC = 32;           // keys per chunk
constexpr int FDK = 16;           // depth per projection step
constexpr int FTHREADS = 256;
constexpr int LDF = DH + 1;

// Shared memory of the f32 kernel: q [64][65], k and v [32][65], p [64][33],
// an x tile [64][17] and a weight tile [128][17]
__host__ __device__ inline size_t smem_f32() {
  return ((size_t)BR * LDF + 2 * FKC * LDF + BR * (FKC + 1) + BR * (FDK + 1) +
          2 * BR * (FDK + 1)) * sizeof(float);
}

// rows R0 .. R0 + 4*RG - 1 of LN(x) times NC weight rows (j < 64: w0 + j,
// else w1 + j - 64): thread t accumulates rows (t / (NC/4))*4 .. +3 and
// columns (t % (NC/4))*4 .. +3.
template <int RG, int NC>
__device__ __forceinline__ void project_f32(float (&acc)[4][4], const Args& a, const float* xb,
                                            int R0, long long w0, long long w1, float* sXs,
                                            float* sWs) {
  static_assert(RG * (NC / 4) == FTHREADS, "one 4x4 tile per thread");
  const int tid = threadIdx.x, ty = tid / (NC / 4), tx = tid % (NC / 4);
  const float* w = static_cast<const float*>(a.w);
  const int n = a.B * a.S, bi = blockIdx.z;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < a.D; k0 += FDK) {
    __syncthreads();
    for (int i = tid; i < 4 * RG * FDK; i += FTHREADS) {
      const int r = i / FDK, c = i % FDK, row = R0 + r, k = k0 + c;
      float v = 0.f;
      if (row < a.S && k < a.D) {
        const float mu = a.stats[bi * a.S + row], rs = a.stats[n + bi * a.S + row];
        v = (xb[(long long)row * a.x_rs + k] - mu) * rs * a.ln_w[k] + a.ln_b[k];
      }
      sXs[r * (FDK + 1) + c] = v;
    }
    for (int i = tid; i < NC * FDK; i += FTHREADS) {
      const int r = i / FDK, c = i % FDK;
      const long long row = r < 64 ? w0 + r : w1 + r - 64;
      sWs[r * (FDK + 1) + c] = k0 + c < a.D ? w[row * a.D + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FDK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = sXs[(ty * 4 + i) * (FDK + 1) + kk];
        wv[i] = sWs[(tx * 4 + i) * (FDK + 1) + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }
}

// One block per (64 query rows, head, batch item), 256 threads: q projected
// once, then k and v 32 keys at a time, each chunk's logits, an online
// softmax in f32 and p . v; out = acc / l.
__global__ void __launch_bounds__(FTHREADS) block_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BR * LDF;
  float* sV = sK + FKC * LDF;
  float* sP = sV + FKC * LDF;
  float* sXs = sP + BR * (FKC + 1);
  float* sWs = sXs + BR * (FDK + 1);

  const int q0 = blockIdx.x * BR, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int S = a.S;
  const long long HD = (long long)a.H * DH;
  const float* xb = static_cast<const float*>(a.x) + bi * a.x_bs;
  const float* bias = static_cast<const float*>(a.b);

  {
    float acc[4][4];
    project_f32<16, 64>(acc, a, xb, q0, h * DH, 0, sXs, sWs);
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sQ[(ty * 4 + i) * LDF + tx * 4 + j] = acc[i][j] + bias[h * DH + tx * 4 + j];
  }

  // thread -> query row r, keys (and then head dims) of quarter qt
  const int r = tid / 4, qt = tid % 4;
  float m = -INFINITY, l = 0.f, o[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d] = 0.f;
  for (int k0 = 0; k0 < S; k0 += FKC) {
    float acc[4][4];
    project_f32<8, 128>(acc, a, xb, k0, HD + h * DH, 2 * HD + h * DH, sXs, sWs);
    {
      const int ty = tid / 32, tx = tid % 32;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx * 4 + j;  // < 64: k, else v
          const float v = acc[i][j] + bias[(col < 64 ? HD : 2 * HD) + h * DH + col % 64];
          (col < 64 ? sK : sV)[(ty * 4 + i) * LDF + col % 64] = v;
        }
    }
    __syncthreads();
    float s[8], mx = m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = qt * 8 + j;
      float dot = 0.f;
      for (int d = 0; d < DH; ++d) dot = fmaf(sQ[r * LDF + d], sK[key * LDF + d], dot);
      s[j] = k0 + key < S ? dot * a.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m - mx);
    m = mx;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = exp2f(s[j] - m);
      ls += s[j];
      sP[r * (FKC + 1) + qt * 8 + j] = s[j];
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    __syncwarp();  // the row's four threads are one quad of this warp
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      float acc_d = o[d] * alpha;
      for (int j = 0; j < FKC; ++j)
        acc_d = fmaf(sP[r * (FKC + 1) + j], sV[j * LDF + qt * 16 + d], acc_d);
      o[d] = acc_d;
    }
  }
  if (q0 + r < S) {
    float* og = static_cast<float*>(a.out) + ((long long)bi * S + q0 + r) * HD + h * DH + qt * 16;
#pragma unroll
    for (int d = 0; d < 16; ++d) og[d] = o[d] / l;
  }
}

int launch(bool bf16, const Args& a, void* stream) {
  if (a.B < 1 || a.H < 1 || a.S < 1 || a.S > MAX_S || a.D < 8 || a.D % 8 || a.width < 1 ||
      a.width > a.D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = a.B * a.S;
  if (bf16)
    row_stats_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, st>>>(a);
  else
    row_stats_kernel<float><<<(rows + 7) / 8, 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    // the tiles of S over clusters of CL blocks, at most MAX_TPB a block
    const int n_kt = (a.S + BR - 1) / BR, cl = (n_kt + MAX_TPB - 1) / MAX_TPB;
    const int tpb = (n_kt + cl - 1) / cl;
    CUtensorMap xm, wm;
    int e = encode_rows_bf16(&xm, a.x, a.D, a.S, a.B, a.x_rs, a.x_bs, 2 * BR);
    if (!e) e = encode_rows_bf16(&wm, a.w, a.D, 3LL * a.H * DH, 1, a.D, 0, BR);
    if (e) return e;
    switch (cl) {
      case 1: return launch_bf16<1>(a, xm, wm, tpb, st);
      case 2: return launch_bf16<2>(a, xm, wm, tpb, st);
      default: return launch_bf16<3>(a, xm, wm, tpb, st);
    }
  }
  const size_t smem = smem_f32();
  err = cudaFuncSetAttribute(block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_f32_kernel<<<dim3((a.S + BR - 1) / BR, a.H, a.B), FTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x [B, S, D] with
// batch stride x_bs and row stride x_rs (unit column stride; bf16: 16-byte
// aligned base and strides); ln_w, ln_b f32 [D rounded up to 64], zeros past
// D; w [3*H*64, D] and b [3*H*64] contiguous in x's dtype; stats [2, B*S]
// f32 scratch; out [B, S, H*64] contiguous. 1 <= S <= 1024, D a multiple of 8;
// the LayerNorm's statistics over the first ``width`` (1 .. D) values of a
// row, the rest of the row x's zero padding (with zero gamma and beta).
int k8_attn_block_bf16(const void* x, long long x_bs, long long x_rs, const float* ln_w,
                       const float* ln_b, const void* w, const void* b, float* stats, void* out,
                       int B, int S, int D, int H, int width, float eps, float scale,
                       void* stream) {
  const Args a{x, x_bs, x_rs, ln_w, ln_b, w, b, stats, out, B, S, D, H, width, eps, scale};
  return launch(true, a, stream);
}

int k8_attn_block_f32(const void* x, long long x_bs, long long x_rs, const float* ln_w,
                      const float* ln_b, const void* w, const void* b, float* stats, void* out,
                      int B, int S, int D, int H, int width, float eps, float scale,
                      void* stream) {
  const Args a{x, x_bs, x_rs, ln_w, ln_b, w, b, stats, out, B, S, D, H, width, eps, scale};
  return launch(false, a, stream);
}

const char* k8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
