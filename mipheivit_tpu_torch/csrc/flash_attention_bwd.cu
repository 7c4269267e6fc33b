// K5: flash-attention backward (any S, D = 64) from K4's saved row
// log-sum-exp.
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
// Two kernels, as on the TPU. dK/dV: one block per (64-key tile, head,
// batch) holds its key and value tile and loops over every query tile; dQ:
// one block per (64-row query tile, head, batch) loops over the key tiles
// that hold a live key. delta is computed outside (one f32 reduction, as the
// JAX package computes it in XLA).
//
// Layout. q, dO are [B, Sq, H*D] and k, v are [B, Sk, H*D], each with a
// base pointer, a batch stride and a row stride (the sections of a fused
// qkv buffer are read in place); lse and delta are [B, H, Sq] f32; dq is
// written as [B, Sq, H*D], dk and dv as [B, Sk, H*D], in q's dtype. Every
// offset is 64-bit.
//
// Masking. Keys at or past seq_len_k (L) are a suffix. K/V rows at or past
// L and q/dO rows at or past Sq are zero-filled on load, so padding that
// holds NaN or Inf reaches no product; p of a masked key is set to 0, and
// query rows at or past Sq get lse = +inf (p = 0) and delta = 0 in the
// dK/dV kernel. Rows of dK/dV at or past L are written as zeros.
//
// bf16 path: all five products on mma.sync m16n8k16 (bf16 in, f32
// accumulate), logits, p, dP and dS in registers; p is rounded to bf16 for
// p^T . dO and dS for dS^T . q and dS . k, as K4 rounds p for p . v. The
// lse is K4's, taken from the f32 p (rounded p never enters it). f32 path:
// scalar FMAs with every tile in shared memory, p and dS kept f32 (tests,
// numerics). wgmma, TMA and warp specialisation are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 4;     // bf16: each warp owns 16 rows of its block's tile
constexpr int THREADS = WARPS * 32;
constexpr int LDT = D + 8;   // bf16 tile row stride: conflict-free ldmatrix rows
constexpr int LDF = D + 1;   // f32 tile row stride: conflict-free column reads
constexpr int TILE = BQ * LDT;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ == BK && BQ == WARPS * 16, "one 16-row mma tile per warp");

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

// ---- bf16: register-resident tiles on mma.sync (m16n8k16) ---------------------

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

// 64 rows of D bf16 values from global rows r0.. into a padded shared tile,
// asynchronously; rows >= n are zero-filled.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long rs, int r0, int n) {
  constexpr int VPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LDT + c, src + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// acc[16 rows x 64 cols] += a_tile(16 x 64, A fragments) . t^T, where t is a
// 64-row shared tile read as the col-major B operand: c[n][..] over t's rows
// n*8.. (the q . k^T pattern of K4).
__device__ __forceinline__ void mma_abt(float (*acc)[4], unsigned (*af)[4],
                                        const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];  // t rows np*16 + 0..7 and + 8..15, cols kk*16 + 0..15
      ldmatrix_x4(b, t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], af[kk], b);
      mma16816(acc[2 * np + 1], af[kk], b + 2);
    }
  }
}

// acc[16 rows x D] += x(16 x 64, C fragments, rounded to bf16) . t, where t
// is a 64-row shared tile [row][D] (the p . v pattern of K4).
__device__ __forceinline__ void mma_ct(float (*acc)[4], float (*x)[4],
                                       const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];  // t rows kk*16 + 0..15, cols dp*16 + 0..7 and + 8..15
      ldmatrix_x4_trans(b, t + (kk * 16 + (lane & 15)) * LDT + dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], xa, b);
      mma16816(acc[2 * dp + 1], xa, b + 2);
    }
  }
}

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

// 16 rows (this warp's) of a 16 x 64 accumulator -> bf16 rows of dst; rows
// >= n are not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long rs, int row0, int n,
                                           float (*acc)[4], float mul, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<unsigned*>(dst + row * rs + t * 8 + tig * 2) =
          pack_bf16(acc[t][2 * r] * mul, acc[t][2 * r + 1] * mul);
  }
}

constexpr size_t BF16_SMEM = 6 * (size_t)TILE * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);

// dK/dV: one block per (64-key tile, head, batch); each warp owns 16 keys.
// Q, dO, lse and delta tiles stream through double-buffered shared memory.
__global__ void __launch_bounds__(THREADS) dkdv_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* sQ = sV + TILE;      // [2][TILE]
  __nv_bfloat16* sO = sQ + 2 * TILE;  // dO, [2][TILE]
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // [2][BQ] lse, log2 units
  float* sD = sL + 2 * BQ;                               // [2][BQ] delta

  const int L = a.L, Sq = a.Sq;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * D;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(a.dout) + b * a.o_bs + h * D;
  const float* lg = a.lse + ((long long)b * a.H + h) * Sq;
  const float* dg = a.delta + ((long long)b * a.H + h) * Sq;

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  if (k0 < L) {  // a tile with no live key has dK = dV = 0
    auto load_q = [&](int i) {
      const int buf = i & 1, q0 = i * BQ;
      load_tile_async(sQ + buf * TILE, qg, a.q_rs, q0, Sq);
      load_tile_async(sO + buf * TILE, og, a.o_rs, q0, Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        sL[buf * BQ + threadIdx.x] = r < Sq ? lg[r] * LOG2E : INFINITY;  // p = 0 past Sq
        sD[buf * BQ + threadIdx.x] = r < Sq ? dg[r] : 0.f;
      }
    };
    load_tile_async(sK, kg, a.k_rs, k0, L);
    load_tile_async(sV, vg, a.v_rs, k0, L);
    load_q(0);
    cp_async_commit();

    unsigned kf[D / 16][4], vf[D / 16][4];  // this warp's 16 keys as A fragments
    const int n_q = (Sq + BQ - 1) / BQ;
    for (int i = 0; i < n_q; ++i) {
      if (i + 1 < n_q) {
        load_q(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
          ldmatrix_x4(kf[kk], sK + off);
          ldmatrix_x4(vf[kk], sV + off);
        }
      }
      const __nv_bfloat16* qs = sQ + (i & 1) * TILE;
      const __nv_bfloat16* os = sO + (i & 1) * TILE;
      const float* ls = sL + (i & 1) * BQ;
      const float* ds = sD + (i & 1) * BQ;

      float st[BQ / 8][4], dpt[BQ / 8][4];  // s^T and dP^T: 16 keys x 64 queries
      zero(st);
      zero(dpt);
      mma_abt(st, kf, qs, lane);   // k . q^T
      mma_abt(dpt, vf, os, lane);  // v . dO^T
#pragma unroll
      for (int t = 0; t < BQ / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = t * 8 + tig * 2 + (e & 1);
          const int key = k0 + warp * 16 + g + (e >> 1) * 8;
          const float p = key < L ? exp2f(st[t][e] * a.scale_log2 - ls[qc]) : 0.f;
          st[t][e] = p;
          dpt[t][e] = p * (dpt[t][e] - ds[qc]);
        }
      }
      mma_ct(dv, st, os, lane);   // dV += p^T . dO
      mma_ct(dk, dpt, qs, lane);  // dK += dS^T . q
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }
  }
  const long long hd = (long long)a.H * D;
  const long long out_b = (long long)b * a.Sk * hd + h * D;
  store_rows(static_cast<__nv_bfloat16*>(a.dk) + out_b, hd, k0 + warp * 16, a.Sk, dk, a.scale,
             lane);
  store_rows(static_cast<__nv_bfloat16*>(a.dv) + out_b, hd, k0 + warp * 16, a.Sk, dv, 1.f, lane);
}

// dQ: one block per (64-row query tile, head, batch); each warp owns 16
// query rows. K and V tiles stream through double-buffered shared memory.
__global__ void __launch_bounds__(THREADS) dq_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + TILE;
  __nv_bfloat16* sK = sO + TILE;      // [2][TILE]
  __nv_bfloat16* sV = sK + 2 * TILE;  // [2][TILE]

  const int L = a.L, Sq = a.Sq;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * D;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(a.dout) + b * a.o_bs + h * D;
  const float* lg = a.lse + ((long long)b * a.H + h) * Sq;
  const float* dg = a.delta + ((long long)b * a.H + h) * Sq;
  const int n_kv = (L + BK - 1) / BK;  // tiles with at least one live key

  load_tile_async(sQ, qg, a.q_rs, q0, Sq);
  load_tile_async(sO, og, a.o_rs, q0, Sq);
  load_tile_async(sK, kg, a.k_rs, 0, L);
  load_tile_async(sV, vg, a.v_rs, 0, L);
  cp_async_commit();

  float lr[2], dr[2];  // lse (log2 units) and delta of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lr[r] = row < Sq ? lg[row] * LOG2E : 0.f;  // rows past Sq: dO = 0, so dS = 0
    dr[r] = row < Sq ? dg[row] : 0.f;
  }
  unsigned qf[D / 16][4], of[D / 16][4];  // this warp's q and dO rows as A fragments
  float dq[D / 8][4];
  zero(dq);

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      load_tile_async(sK + ((j + 1) & 1) * TILE, kg, a.k_rs, (j + 1) * BK, L);
      load_tile_async(sV + ((j + 1) & 1) * TILE, vg, a.v_rs, (j + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], sQ + off);
        ldmatrix_x4(of[kk], sO + off);
      }
    }
    const __nv_bfloat16* ks = sK + (j & 1) * TILE;
    const __nv_bfloat16* vs = sV + (j & 1) * TILE;

    float s[BK / 8][4], dp[BK / 8][4];  // 16 q rows x 64 keys
    zero(s);
    zero(dp);
    mma_abt(s, qf, ks, lane);   // q . k^T
    mma_abt(dp, of, vs, lane);  // dO . v^T
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BK + t * 8 + tig * 2 + (e & 1);
        const float p = key < L ? exp2f(s[t][e] * a.scale_log2 - lr[e >> 1]) : 0.f;
        s[t][e] = p * (dp[t][e] - dr[e >> 1]);  // dS
      }
    }
    mma_ct(dq, s, ks, lane);  // dQ += dS . k
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  const long long hd = (long long)a.H * D;
  store_rows(static_cast<__nv_bfloat16*>(a.dq) + (long long)b * Sq * hd + h * D, hd,
             q0 + warp * 16, Sq, dq, a.scale, lane);
}

// ---- f32: scalar FMAs, every tile in shared memory ----------------------------

// 64 rows of D f32 values from global rows r0.. into a padded shared tile;
// rows >= n are zero-filled.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long rs, int r0,
                                              int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LDF + c] = (r0 + r < n) ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

constexpr int RPT = BQ / (THREADS / 64);  // rows per thread: thread -> column c, rows rg + 2i
constexpr size_t F32_DKDV_SMEM = (6 * (size_t)BQ * LDF + 2 * BQ) * sizeof(float);
constexpr size_t F32_DQ_SMEM = (5 * (size_t)BQ * LDF + 2 * BQ) * sizeof(float);

__global__ void __launch_bounds__(THREADS) dkdv_f32_kernel(Args a) {
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

  float acc_dk[RPT], acc_dv[RPT];  // key rows rg + 2i, dim c
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  if (k0 < L) {
    load_tile_f32(sK, kg, a.k_rs, k0, L);
    load_tile_f32(sV, vg, a.v_rs, k0, L);
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's products are done with sQ, sO, sP, sS
      load_tile_f32(sQ, qg, a.q_rs, q0, Sq);
      load_tile_f32(sO, og, a.o_rs, q0, Sq);
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
      // thread -> dim column c, key rows rg + 2i
      for (int qq = 0; qq < BQ; ++qq) {
        const float ov = sO[qq * LDF + c], qv = sQ[qq * LDF + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc_dv[i] = fmaf(sP[(rg + 2 * i) * LDF + qq], ov, acc_dv[i]);
          acc_dk[i] = fmaf(sS[(rg + 2 * i) * LDF + qq], qv, acc_dk[i]);
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
    dkg[row * hd + c] = acc_dk[i] * a.scale;
    dvg[row * hd + c] = acc_dv[i];
  }
}

__global__ void __launch_bounds__(THREADS) dq_f32_kernel(Args a) {
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

  load_tile_f32(sQ, qg, a.q_rs, q0, Sq);
  load_tile_f32(sO, og, a.o_rs, q0, Sq);
  if (threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < Sq ? lg[r] * LOG2E : 0.f;
    sD[threadIdx.x] = r < Sq ? dg[r] : 0.f;
  }
  float acc[RPT];  // query rows rg + 2i, dim c
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's dS . k is done with sK, sS
    load_tile_f32(sK, kg, a.k_rs, k0, L);
    load_tile_f32(sV, vg, a.v_rs, k0, L);
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
      const float kv = sK[kk * LDF + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sS[(rg + 2 * i) * LDF + kk], kv, acc[i]);
    }
  }
  const long long hd = (long long)a.H * D;
  float* dqg = static_cast<float*>(a.dq) + (long long)b * Sq * hd + h * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 2 * i;
    if (row < Sq) dqg[row * hd + c] = acc[i] * a.scale;
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

int launch(bool bf16, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv, long long q_bs,
           long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
           long long o_bs, long long o_rs, int B, int Sq, int Sk, int L, int H, float scale_log2,
           float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || L < 1 || L > Sk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    dout, lse,  delta, dq, dk, dv, q_bs, q_rs, k_bs,
               k_rs, v_bs, v_rs, o_bs, o_rs, Sq,    Sk, L,  H,  scale_log2, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_kv((Sk + BK - 1) / BK, H, B), grid_q((Sq + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if (bf16) {
    err = launch_one(dkdv_bf16_kernel, grid_kv, BF16_SMEM, st, a);
    if (err == cudaSuccess) err = launch_one(dq_bf16_kernel, grid_q, BF16_SMEM, st, a);
  } else {
    err = launch_one(dkdv_f32_kernel, grid_kv, F32_DKDV_SMEM, st, a);
    if (err == cudaSuccess) err = launch_one(dq_f32_kernel, grid_q, F32_DQ_SMEM, st, a);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launches (0 on success).
int k5_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, long long o_bs, long long o_rs, int B,
                      int Sq, int Sk, int L, int H, float scale_log2, float scale, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, dq, dk, dv, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                o_bs, o_rs, B, Sq, Sk, L, H, scale_log2, scale, stream);
}

int k5_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv,
                     long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                     long long v_bs, long long v_rs, long long o_bs, long long o_rs, int B,
                     int Sq, int Sk, int L, int H, float scale_log2, float scale, void* stream) {
  return launch(false, q, k, v, dout, lse, delta, dq, dk, dv, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                o_bs, o_rs, B, Sq, Sk, L, H, scale_log2, scale, stream);
}

const char* k5_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
