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
//   p      = exp2(s - rowmax), l = rowsum(p)    f32
//   out    = (cast(p, v.dtype) . v) / l          f32 accumulation, divided after
//
// written as [B, S, H*Dh], before the output projection. Like the TPU
// kernel it keeps the normed activations and the [S, 3*H*Dh] qkv buffer out
// of device memory.
//
// The TPU design does not carry over: it holds the whole 14 MB bf16 qkv
// weight in VMEM and projects all heads at once; an SM has 227 KB. Here a
// block owns one head and projects only that head's 192 weight rows, which
// stream from L2 in 64-deep chunks. The keys and values of the head stay in
// shared memory for the attention. At S = 1024 they are 256 KB, more than a
// block can hold, so each (batch item, head) is a cluster of two blocks on
// neighbouring SMs (distributed shared memory): block r projects k and v of
// its half of the rows (S padded to a multiple of 128, so a half is whole
// 64-row chunks; 147 KB at S = 1024, 55 KB at S = 329) and keeps them, then
// both blocks wait at the cluster barrier, and each runs the attention of
// its own half of the query rows over all the keys, reading the partner's
// key and value chunks through the cluster's shared-memory window into a
// local staging tile. The projection is done once; recomputing the keys
// per query block instead would have cost S/64 times the projection.
//
// Per 64-row block of rows, 4 warps of 16 rows each: the x rows and the
// weight rows land in shared memory by cp.async (two buffers), each x tile
// is layer-normed in place with row statistics computed once per row by a
// first small kernel of the same call (row_stats_kernel, 8 bytes per row in
// device memory), and the products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). The query rows' C fragments, biased
// and rounded, are the A fragments of q . k^T, so q never leaves registers.
// The row max is exact, as on the TPU: one pass of q . k^T takes the max,
// a second recomputes the logits and forms p, l and p . v.
//
// What bounds it on the H100. At ViT-g (B = 64, S = 329, D = 1536, 24 heads)
// a call is 298.1 GFLOP of projection and 42.6 of attention against 0.14 GB
// (x read once, the output written once): the floor is the tensor-core time,
// 0.34 ms. Each block re-reads its head's weight rows (590 KB) and its x
// rows from L2. wgmma, TMA multicast of the weight across the heads of a
// cluster, and a wider block are left for later.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64;            // head dim
constexpr int BR = 64;            // rows per block step: 4 warps of 16
constexpr int BKD = 64;           // depth of one projection stage
constexpr int THREADS = 128;
constexpr int LDT = 72;           // bf16 tile row stride: conflict-free ldmatrix rows
constexpr int MAX_S = 1024;
constexpr int TILE = BR * LDT;    // elements of one 64-row tile

struct Args {
  const void* x;        // [B, S, D], batch stride x_bs, row stride x_rs, unit column stride
  long long x_bs, x_rs;
  const float* ln_w;    // [D] f32
  const float* ln_b;    // [D] f32
  const void* w;        // [3*H*DH, D] contiguous, x's dtype
  const void* b;        // [3*H*DH], x's dtype
  float* stats;         // [2, B*S] f32 scratch: row means, then rstds
  void* out;            // [B, S, H*DH] contiguous
  int B, S, D, H;
  float eps;
  float scale;          // log2(e) / sqrt(DH)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// f32 mean and rstd of every row of x [B, S, D] into stats (means [0, B*S),
// rstds [B*S, 2*B*S)): one warp per row, two passes as _ln_rows (the mean,
// then the mean of squared deviations); bf16 rows are read 16 bytes at a
// time, f32 one value at a time.
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
    for (int k = lane * V; k < a.D; k += 32 * V) {
      if constexpr (V == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j) s += term(to_f(e[j]));
      } else {
        s += term(to_f(xr[k]));
      }
    }
    return warp_sum(s);
  };
  const float mean = sum_over([](float v) { return v; }) / a.D;
  const float var = sum_over([mean](float v) { return (v - mean) * (v - mean); }) / a.D;
  if (lane == 0) {
    a.stats[i] = mean;
    a.stats[n + i] = rsqrtf(var + a.eps);
  }
}

// ---- bf16: mma.sync, a cluster of two blocks per (head, batch item) -------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c += a . b for one 16x8 f32 tile, a 16x16 (row) and b 16x8 (col) bf16
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Shared memory of the bf16 kernel: the head's k and v for this block's SH
// rows, two x tiles and two weight tiles of 128 rows (the attention reuses
// the x tiles to stage the partner's key and value chunks), and the row
// statistics of this block's rows.
__host__ __device__ inline size_t smem_bf16(int sh) {
  return (size_t)2 * sh * LDT * 2 + (size_t)2 * (BR + 2 * BR) * LDT * 2 + (size_t)2 * sh * 4;
}

// acc[NT][4] = LN(x rows R0 .. R0 + 63) . W^T over the whole depth D, for NT*8
// weight rows: rows j < 64 are W's rows w0 + j, rows j >= 64 are w1 + j - 64.
// Warp w computes rows w*16 .. +15; its C fragments (tile t = columns t*8 ..
// t*8 + 7; rows g and g + 8, columns tig*2 and +1).
template <int NT>
__device__ __forceinline__ void project(float (&acc)[NT][4], const Args& a, const __nv_bfloat16* xb,
                                        int R0, int lr0, long long w0, long long w1,
                                        __nv_bfloat16* sX, __nv_bfloat16* sW,
                                        const float* mean_s, const float* rstd_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int n_k = a.D / BKD;
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BKD;
    for (int i = tid; i < BR * 8; i += THREADS) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = R0 + r < a.S;
      cp_async16(sX + buf * TILE + r * LDT + c, xb + (ok ? (long long)(R0 + r) * a.x_rs : 0) + k0 + c,
                 ok);
    }
    for (int i = tid; i < NT * 8 * 8; i += THREADS) {
      const int r = i / 8, c = (i % 8) * 8;
      const long long row = r < 64 ? w0 + r : w1 + r - 64;
      cp_async16(sW + buf * 2 * TILE + r * LDT + c, w + row * a.D + k0 + c, true);
    }
  };
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      stage(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // layer-norm the landed x tile in place, rounded to bf16 (_ln_rows)
    __nv_bfloat16* xs = sX + (kt & 1) * TILE;
    const int k0 = kt * BKD;
    for (int i = tid; i < BR * 8; i += THREADS) {
      const int r = i / 8, c = (i % 8) * 8;
      uint4* p = reinterpret_cast<uint4*>(xs + r * LDT + c);
      uint4 raw = *p;
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
      const float mu = mean_s[lr0 + r], rs = rstd_s[lr0 + r];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = (__bfloat162float(v[e]) - mu) * rs;
        v[e] = __float2bfloat16(y * __ldg(a.ln_w + k0 + c + e) + __ldg(a.ln_b + k0 + c + e));
      }
      *p = raw;
    }
    __syncthreads();
    const __nv_bfloat16* ws = sW + (kt & 1) * 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      unsigned af[4];
      ldmatrix_x4(af, xs + (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bf[4];  // weight rows np*16 + 0..7 and + 8..15, depth kk*16 + 0..15
        ldmatrix_x4(bf, ws + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * np], af, bf);
        mma16816(acc[2 * np + 1], af, bf + 2);
      }
    }
    __syncthreads();  // every warp is done with these buffers before they are refilled
  }
}

// s = q . k^T over one chunk of 64 keys (ks, a padded shared tile), in log2
// units; keys >= S get -inf
__device__ __forceinline__ void qk_chunk(float (&s)[8][4], const unsigned (&qf)[4][4],
                                         const __nv_bfloat16* ks, int key0, int S, float scale) {
  const int lane = threadIdx.x % 32, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned kb[4];
      ldmatrix_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], qf[kk], kb);
      mma16816(s[2 * np + 1], qf[kk], kb + 2);
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + t * 8 + tig * 2 + (e & 1);
      s[t][e] = key < S ? s[t][e] * scale : -INFINITY;
    }
}

// grid (2*H, B), clusters of two blocks along x: block rank r of the cluster
// for head blockIdx.x / 2 of batch item blockIdx.y owns rows [r*SH, r*SH + SH)
// with SH = (S rounded up to 128) / 2.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
    block_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / 2, bi = blockIdx.y;
  const int S = a.S, SH = (S + 2 * BR - 1) / (2 * BR) * BR, r0 = rank * SH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const long long HD = (long long)a.H * DH;

  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + SH * LDT;
  __nv_bfloat16* sX = sV + SH * LDT;        // 2 tiles
  __nv_bfloat16* sW = sX + 2 * TILE;        // 2 x 2 tiles
  float* mean_s = reinterpret_cast<float*>(sW + 4 * TILE);
  float* rstd_s = mean_s + SH;

  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + bi * a.x_bs;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.b);
  const int n = a.B * S;
  for (int r = tid; r < SH; r += THREADS) {
    const bool ok = r0 + r < S;
    mean_s[r] = ok ? a.stats[bi * S + r0 + r] : 0.f;
    rstd_s[r] = ok ? a.stats[n + bi * S + r0 + r] : 0.f;
  }
  __syncthreads();

  // 1. k and v of this block's rows into shared memory, biased, rounded once
  for (int lr = 0; lr < SH; lr += BR) {
    if (r0 + lr >= S) {  // a block of padding rows: zeros
      for (int i = tid; i < BR * DH / 2; i += THREADS) {
        const int r = i / (DH / 2), c = (i % (DH / 2)) * 2;
        *reinterpret_cast<unsigned*>(sK + (lr + r) * LDT + c) = 0u;
        *reinterpret_cast<unsigned*>(sV + (lr + r) * LDT + c) = 0u;
      }
      continue;
    }
    float acc[16][4];
    project<16>(acc, a, xb, r0 + lr, lr, HD + h * DH, 2 * HD + h * DH, sX, sW, mean_s, rstd_s);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int col = (t % 8) * 8 + tig * 2;
      const long long bcol = (t < 8 ? HD : 2 * HD) + h * DH + col;
      const float b0 = __bfloat162float(bias[bcol]), b1 = __bfloat162float(bias[bcol + 1]);
      __nv_bfloat16* dst = t < 8 ? sK : sV;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lr + warp * 16 + g + 8 * r;
        *reinterpret_cast<unsigned*>(dst + row * LDT + col) =
            r0 + row < S ? pack_bf16(acc[t][2 * r] + b0, acc[t][2 * r + 1] + b1) : 0u;
      }
    }
  }
  cluster.sync();  // both halves of k and v are in place

  // 2. the attention of this block's query rows over all keys
  const __nv_bfloat16* pK = cluster.map_shared_rank(sK, rank ^ 1);
  const __nv_bfloat16* pV = cluster.map_shared_rank(sV, rank ^ 1);
  const int n_kv = (S + BR - 1) / BR, per = SH / BR;
  // chunk c of the keys: in place if this block holds it, else copied from
  // the partner into the staging tile dst
  auto chunk = [&](const __nv_bfloat16* mine, const __nv_bfloat16* theirs, int c,
                   __nv_bfloat16* dst) -> const __nv_bfloat16* {
    if (c / per == rank) return mine + (c % per) * TILE;
    const __nv_bfloat16* src = theirs + (c % per) * TILE;
    for (int i = tid; i < BR * DH / 8; i += THREADS) {
      const int r = i / (DH / 8), col = (i % (DH / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * LDT + col) =
          *reinterpret_cast<const uint4*>(src + r * LDT + col);
    }
    return dst;
  };
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + (long long)bi * S * HD + h * DH;
  for (int lr = 0; lr < SH && r0 + lr < S; lr += BR) {
    float qa[8][4];
    project<8>(qa, a, xb, r0 + lr, lr, h * DH, 0, sX, sW, mean_s, rstd_s);
    unsigned qf[4][4];  // q rounded once, as the A fragments of q . k^T
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = t * 8 + tig * 2;
      const float b0 = __bfloat162float(bias[h * DH + col]);
      const float b1 = __bfloat162float(bias[h * DH + col + 1]);
      qf[t / 2][(t & 1) * 2] = pack_bf16(qa[t][0] + b0, qa[t][1] + b1);
      qf[t / 2][(t & 1) * 2 + 1] = pack_bf16(qa[t][2] + b0, qa[t][3] + b1);
    }
    float m[2] = {-INFINITY, -INFINITY};
    for (int c = 0; c < n_kv; ++c) {  // pass 1: the exact row max
      const __nv_bfloat16* ks = chunk(sK, pK, c, sX);
      __syncthreads();
      float s[8][4];
      qk_chunk(s, qf, ks, c * BR, S, a.scale);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[t][e]);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    float o[8][4], l[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    for (int c = 0; c < n_kv; ++c) {  // pass 2: p, its f32 sum and bf16(p) . v
      const __nv_bfloat16* ks = chunk(sK, pK, c, sX);
      const __nv_bfloat16* vs = chunk(sV, pV, c, sX + TILE);
      __syncthreads();
      float s[8][4];
      qk_chunk(s, qf, ks, c * BR, S, a.scale);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = exp2f(s[t][e] - m[e >> 1]);
          l[e >> 1] += s[t][e];
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LDT + dp * 16 + (lane >> 4) * 8);
          mma16816(o[2 * dp], pa, vb);
          mma16816(o[2 * dp + 1], pa, vb + 2);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + lr + warp * 16 + g + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        *reinterpret_cast<unsigned*>(og + row * HD + t * 8 + tig * 2) =
            pack_bf16(o[t][2 * r] / l[r], o[t][2 * r + 1] / l[r]);
    }
  }
  cluster.sync();  // the partner has read its last chunk of this block's k and v
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
      if (row < a.S) {
        const float mu = a.stats[bi * a.S + row], rs = a.stats[n + bi * a.S + row];
        v = (xb[(long long)row * a.x_rs + k] - mu) * rs * a.ln_w[k] + a.ln_b[k];
      }
      sXs[r * (FDK + 1) + c] = v;
    }
    for (int i = tid; i < NC * FDK; i += FTHREADS) {
      const int r = i / FDK, c = i % FDK;
      const long long row = r < 64 ? w0 + r : w1 + r - 64;
      sWs[r * (FDK + 1) + c] = w[row * a.D + k0 + c];
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
  if (a.B < 1 || a.H < 1 || a.S < 8 || a.S > MAX_S || a.D < BKD || a.D % 128)
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
    const int sh = (a.S + 2 * BR - 1) / (2 * BR) * BR;
    const size_t smem = smem_bf16(sh);
    err = cudaFuncSetAttribute(block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_bf16_kernel<<<dim3(2 * a.H, a.B), THREADS, smem, st>>>(a);
  } else {
    const size_t smem = smem_f32();
    err = cudaFuncSetAttribute(block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_f32_kernel<<<dim3((a.S + BR - 1) / BR, a.H, a.B), FTHREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x [B, S, D] with
// batch stride x_bs and row stride x_rs (unit column stride); ln_w, ln_b f32
// [D]; w [3*H*64, D] and b [3*H*64] contiguous in x's dtype; stats [2, B*S]
// f32 scratch; out [B, S, H*64] contiguous. 8 <= S <= 1024, D a multiple of 128.
int k8_attn_block_bf16(const void* x, long long x_bs, long long x_rs, const float* ln_w,
                       const float* ln_b, const void* w, const void* b, float* stats, void* out,
                       int B, int S, int D, int H, float eps, float scale, void* stream) {
  const Args a{x, x_bs, x_rs, ln_w, ln_b, w, b, stats, out, B, S, D, H, eps, scale};
  return launch(true, a, stream);
}

int k8_attn_block_f32(const void* x, long long x_bs, long long x_rs, const float* ln_w,
                      const float* ln_b, const void* w, const void* b, float* stats, void* out,
                      int B, int S, int D, int H, float eps, float scale, void* stream) {
  const Args a{x, x_bs, x_rs, ln_w, ln_b, w, b, stats, out, B, S, D, H, eps, scale};
  return launch(false, a, stream);
}

const char* k8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
