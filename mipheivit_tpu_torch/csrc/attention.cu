// K1: whole-sequence softmax attention for ViT encoder blocks (S <= 512, D = 64),
// and K6: the same over [B, H, S, D] with the exact softmax of the short-
// sequence kernel (second entry point, k6_short_attention_*).
//
// K1 replaces the TPU kernel mipheivit_tpu/ops/attention.py::_bshd_kernel_staged,
// launched there by _qkv_forward (fused qkv buffer) and _bshd_forward (split
// q/k/v). Same math, per (batch, head):
//
//   logits = (q . k^T) * log2(e)/sqrt(D)      f32
//   p      = exp2(logits - rowmax)             f32, rowsum l taken in f32
//   out    = (cast(p, v.dtype) . v) / l        f32 accumulation, 1/l on [S, D]
//
// K6 replaces mipheivit_tpu/ops/attention.py::_short_kernel (:109), launched by
// _short_forward (:137) for dot_product_attention(impl="flash") at S <= 512.
// Its order of rounding differs from K1's: the probabilities are normalised
// in f32 first and then rounded to v's dtype,
//
//   p      = exp(logits - rowmax) / rowsum     f32 (exp2 of log2-scaled logits here)
//   out    = cast(p, v.dtype) . v              f32 accumulation, no 1/l after
//
// so K6 needs each row's max and sum before it forms any p: its bf16 kernel
// makes two passes over the keys (pass 1: the row max and the row sum,
// online; pass 2: the logits again, p normalised and rounded, p . v). The
// logits are recomputed rather than kept: a 64-row block of them at S = 512
// is 128 KB of f32, and q . k^T is a third of the work. The TPU kernel pads
// S to a multiple of 128 in device memory and masks keys past S to -1e30;
// here rows and keys past S are masked in the kernel and nothing is padded.
//
// Layout. q, k and v are read in place: each has a base pointer and a batch,
// a head and a row stride, with the head dim unit-stride. K1 passes the
// head stride D (the q | k | v sections of one fused [B, S, 3*H*D] buffer,
// row stride 3*H*D, or three separate [B, S, H*D] tensors) and writes
// [B, S, H*D]: no head transpose exists anywhere, the counterpart of the
// shifted BlockSpecs of _qkv_forward. K6 takes [B, H, S, D] with any of
// those strides (a head-major view of a [B, S, H*D] buffer included) and
// writes [B, H, S, D].
//
// What bounds them on the H100. At the flagship shape (S = 329, H = 24, B = 64)
// one call is 4*S^2*D*H*B = 42.6 GFLOP and, with q/k/v read once and the
// output written once, 0.26 GB: 164 FLOP/byte, under the card's ~295, so
// the floor is the memory time (0.08 ms at 3.35 TB/s; the products alone
// would take 0.04 ms at the dense bf16 peak). K and V are re-read by each of
// the 6 q tiles of a head, from L2 (K6 reads K twice). Per (batch, head) the
// work is small, so the design keeps many blocks resident (46 KB of shared
// memory, four blocks of 4 warps per SM), runs both products on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate), and keeps logits and
// probabilities in registers, out of shared and device memory. TMA, wgmma
// and warp specialisation are left for later.
//
// Ragged S (329) is masked inside the kernel: q/k/v rows >= S are loaded as
// zeros, keys >= S get p = 0, and rows >= S are not stored.
//
// Two paths for each:
//   bf16  the main path. K1: online softmax (see attn_bf16_kernel), so p is
//         rounded to bf16 relative to the running row max; against the plain
//         version (exact max, p / l rounded to bf16) that stays within a few
//         bf16 ulps of the output scale. K6: the two passes above, exact max.
//   f32   scalar FMAs, exact row max first, logits in shared memory (tests);
//         K6 divides p by l before p . v, K1 the output after.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per staged K/V chunk
constexpr int WARPS = 4;     // each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int MAX_S = 512;
constexpr int LDT = D + 8;   // bf16 tile row stride: conflict-free ldmatrix rows
constexpr int LDF = D + 1;   // f32 tile row stride of the scalar path: conflict-free column reads

static_assert(BQ == WARPS * 16, "one 16-row mma tile per warp");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // batch / head / row strides in elements
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs;
  int S, H;
  float scale;      // log2(e) / sqrt(D)
  bool norm_first;  // f32 kernel: p / l before p . v (K6), not 1 / l on the output (K1)
  void* stream;
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
// asynchronously; rows >= S are zero-filled.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long rs, int r0, int S) {
  constexpr int VPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDT + c, src + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// s = q . k^T over one chunk of 64 keys (ks, a padded shared tile): 8 tiles
// of 16 rows x 8 keys, scaled to log2 units; keys >= S (key0 the chunk's
// first) get -inf.
__device__ __forceinline__ void qk_chunk(float (&s)[BK / 8][4], const unsigned (&qf)[D / 16][4],
                                         const __nv_bfloat16* ks, int key0, int S, float scale) {
  const int lane = threadIdx.x % 32, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < BK / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      unsigned kb[4];  // keys np*16 + 0..7 and + 8..15, dims kk*16 + 0..15
      ldmatrix_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], qf[kk], kb);
      mma16816(s[2 * np + 1], qf[kk], kb + 2);
    }
  }
#pragma unroll
  for (int t = 0; t < BK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + t * 8 + tig * 2 + (e & 1);
      s[t][e] = key < S ? s[t][e] * scale : -INFINITY;
    }
}

// o += bf16(p) . v over one chunk of 64 keys, 16 keys at a time: the C
// fragments of p (as qk_chunk left them) are, pair by pair, the A fragments
__device__ __forceinline__ void pv_chunk(float (&o)[D / 8][4], const float (&p)[BK / 8][4],
                                         const __nv_bfloat16* vs) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned vb[4];  // keys kk*16 + 0..15, dims dp*16 + 0..7 and + 8..15
      ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LDT + dp * 16 + (lane >> 4) * 8);
      mma16816(o[2 * dp], pa, vb);
      mma16816(o[2 * dp + 1], pa, vb + 2);
    }
  }
}

// The row max of rows g and g + 8 over this chunk and m, across the 4
// threads of a row (the quad)
__device__ __forceinline__ void chunk_max(float (&mx)[2], const float (&s)[BK / 8][4],
                                          const float (&m)[2]) {
  mx[0] = m[0];
  mx[1] = m[1];
#pragma unroll
  for (int t = 0; t < BK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// Rows q0 + warp*16 + g (+8) of the output accumulator, each divided by its
// l, rounded to bf16 (rows >= S are not stored).
__device__ __forceinline__ void store_rows_bf16(const Args& a, const float (&o)[D / 8][4],
                                                const float (&l)[2], int q0, int b, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + b * a.o_bs + h * a.o_hs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      *reinterpret_cast<unsigned*>(og + row * a.o_rs + t * 8 + tig * 2) =
          pack_bf16(o[t][2 * r] / l[r], o[t][2 * r + 1] / l[r]);
    }
  }
}

// K1. One block per (64-row q tile, head, batch); each of the 4 warps owns 16 q
// rows. K and V stream through double-buffered shared tiles of 64 keys
// (cp.async). Logits, probabilities and the output accumulator stay in
// registers: the mma C fragment of q.k^T is, pair by pair, the A fragment of
// p.v. The softmax is online (running row max m and sum l, the accumulator
// rescaled by exp2(m_old - m_new)), so p is rounded to bf16 relative to the
// running max rather than the final one; l sums the f32 p.
__global__ void __launch_bounds__(THREADS, 4) attn_bf16_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 sQ[BQ * LDT];
  __shared__ __align__(128) __nv_bfloat16 sK[2][BK * LDT];
  __shared__ __align__(128) __nv_bfloat16 sV[2][BK * LDT];

  const int S = a.S;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * a.q_hs;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * a.k_hs;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * a.v_hs;
  const int n_kv = (S + BK - 1) / BK;

  load_tile_async(sQ, qg, a.q_rs, q0, S);
  load_tile_async(sK[0], kg, a.k_rs, 0, S);
  load_tile_async(sV[0], vg, a.v_rs, 0, S);
  cp_async_commit();

  unsigned qf[D / 16][4];  // this warp's 16 q rows as A fragments, one per 16 of D
  float o[D / 8][4];       // output accumulator: 8 tiles of 16 rows x 8 dims
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      load_tile_async(sK[(j + 1) & 1], kg, a.k_rs, (j + 1) * BK, S);
      load_tile_async(sV[(j + 1) & 1], vg, a.v_rs, (j + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
    }
    float s[BK / 8][4];
    qk_chunk(s, qf, sK[j & 1], j * BK, S, a.scale);

    // online softmax
    float mx[2], alpha[2];
    chunk_max(mx, s, m);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first chunk (m = -inf)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = exp2f(s[t][e] - m[e >> 1]);
        l[e >> 1] += s[t][e];
      }
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[t][0] *= alpha[0]; o[t][1] *= alpha[0];
      o[t][2] *= alpha[1]; o[t][3] *= alpha[1];
    }
    pv_chunk(o, s, sV[j & 1]);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  quad_sum(l);
  store_rows_bf16(a, o, l, q0, b, h);
}

// K6. The same blocks, tiles and fragments as K1, in two passes over the
// keys: steps j < n_kv (pass 1) load K alone and take each row's exact max
// m and its sum l = sum exp2(s - m) (online: l rescaled as m grows); steps
// j >= n_kv (pass 2) load K and V again, recompute s, form p = exp2(s - m) / l
// in f32, round it to bf16 and accumulate p . v in f32. The output is o
// itself, rounded once.
__global__ void __launch_bounds__(THREADS, 4) short_bf16_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 sQ[BQ * LDT];
  __shared__ __align__(128) __nv_bfloat16 sK[2][BK * LDT];
  __shared__ __align__(128) __nv_bfloat16 sV[2][BK * LDT];

  const int S = a.S;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * a.q_hs;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * a.k_hs;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * a.v_hs;
  const int n_kv = (S + BK - 1) / BK;

  auto load_step = [&](int j) {  // K (and V in pass 2) of step j into buffer j & 1
    const int key0 = (j % n_kv) * BK;
    load_tile_async(sK[j & 1], kg, a.k_rs, key0, S);
    if (j >= n_kv) load_tile_async(sV[j & 1], vg, a.v_rs, key0, S);
  };
  load_tile_async(sQ, qg, a.q_rs, q0, S);
  load_step(0);
  cp_async_commit();

  unsigned qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < 2 * n_kv; ++j) {
    if (j + 1 < 2 * n_kv) {
      load_step(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
    }
    float s[BK / 8][4];
    qk_chunk(s, qf, sK[j & 1], (j % n_kv) * BK, S, a.scale);
    if (j < n_kv) {
      float mx[2];
      chunk_max(mx, s, m);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] *= exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int t = 0; t < BK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[t][e] - m[e >> 1]);
    } else {
      if (j == n_kv) quad_sum(l);  // the rows' whole sums, once
#pragma unroll
      for (int t = 0; t < BK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = exp2f(s[t][e] - m[e >> 1]) / l[e >> 1];
      pv_chunk(o, s, sV[j & 1]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const float one[2] = {1.f, 1.f};
  store_rows_bf16(a, o, one, q0, b, h);
}

// ---- f32 (tests): scalar FMAs, exact row max first --------------------------

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// f32 row stride of the logits buffer
__host__ __device__ inline int logits_ld(int S) { return round16(S) + 4; }

__device__ inline void load_tile_f32(float* dst, const float* src, long long rs, int r0, int S) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LDF + c] = (r0 + r < S) ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

// Rows warp*16 .. warp*16+15 of the logits buffer become p in place (p / l
// with norm); sl[row] receives the f32 row sum l. Keys in [S, round16(S))
// get p = 0.
__device__ inline void softmax_rows(float* sS, float* sl, int S, int lds, float scale,
                                    bool norm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s16 = round16(S);
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float* row = sS + r * lds;
    float x[MAX_S / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_S / 32; ++i) {
      const int j = lane + 32 * i;
      x[i] = (j < S) ? row[j] * scale : -INFINITY;
      m = fmaxf(m, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_S / 32; ++i) {
      const int j = lane + 32 * i;
      x[i] = (j < S) ? exp2f(x[i] - m) : 0.f;
      l += x[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < MAX_S / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < s16) row[j] = norm ? x[i] / l : x[i];
    }
    if (lane == 0) sl[r] = l;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS) attn_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, s16 = round16(S), lds = logits_ld(S);
  float* sS = reinterpret_cast<float*>(smem);
  float* sQ = sS + BQ * lds;
  float* sKV = sQ + BQ * LDF;
  float* sl = sKV + BK * LDF;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * a.q_hs;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * a.k_hs;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * a.v_hs;
  // thread -> column c (a key in step 1, a head-dim lane in step 3) and rows rg + 2*i
  const int c = threadIdx.x % 64, rg = threadIdx.x / 64;
  constexpr int RPT = BQ / (THREADS / 64);  // rows per thread

  load_tile_f32(sQ, qg, a.q_rs, q0, S);
  for (int k0 = 0; k0 < s16; k0 += BK) {
    __syncthreads();
    load_tile_f32(sKV, kg, a.k_rs, k0, S);
    __syncthreads();
    if (c < min(BK, s16 - k0)) {
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = sKV[c * LDF + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sQ[(rg + 2 * i) * LDF + d], kv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) sS[(rg + 2 * i) * lds + k0 + c] = acc[i];
    }
  }
  __syncthreads();

  softmax_rows(sS, sl, S, lds, a.scale, a.norm_first);

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < s16; k0 += BK) {
    __syncthreads();
    load_tile_f32(sKV, vg, a.v_rs, k0, S);
    __syncthreads();
    const int n = min(BK, s16 - k0);
    for (int j = 0; j < n; ++j) {
      const float vv = sKV[j * LDF + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sS[(rg + 2 * i) * lds + k0 + j], vv, acc[i]);
    }
  }
  float* og = static_cast<float*>(a.out) + b * a.o_bs + h * a.o_hs;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 2 * i;
    if (row < S) og[row * a.o_rs + c] = a.norm_first ? acc[i] : acc[i] / sl[rg + 2 * i];
  }
}

// K1 (short = false) or K6 (short = true), bf16 or f32, grid (q tiles, H, B)
int launch(bool bf16, bool short_attn, const Args& a, int B) {
  if (B < 1 || a.H < 1 || a.S < 1 || a.S > MAX_S) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (bf16) {
    // static shared memory, 46 KB
    if (short_attn) short_bf16_kernel<<<grid, THREADS, 0, st>>>(a);
    else attn_bf16_kernel<<<grid, THREADS, 0, st>>>(a);
  } else {
    // logits of 64 rows + Q and K/V tiles + row sums: above 48 KB, so opt in
    const size_t smem =
        ((size_t)BQ * logits_ld(a.S) + (size_t)(BQ + BK) * LDF + BQ) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_f32_kernel<<<grid, THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// K1: q, k, v with batch and row strides, head h at column h*D; out [B, S, H*D]
int launch_k1(bool bf16, const void* q, const void* k, const void* v, void* out,
              long long q_bs, long long q_rs, long long k_bs, long long k_rs,
              long long v_bs, long long v_rs, int B, int S, int H, float scale, void* stream) {
  const long long hd = (long long)H * D;
  const Args a{q, k, v, out, q_bs, D, q_rs, k_bs, D, k_rs, v_bs, D, v_rs,
               (long long)S * hd, D, hd, S, H, scale, false, stream};
  return launch(bf16, false, a, B);
}

// K6: q, k, v [B, H, S, D] with batch, head and row strides; out [B, H, S, D]
int launch_k6(bool bf16, const void* q, const void* k, const void* v, void* out,
              long long q_bs, long long q_hs, long long q_rs, long long k_bs, long long k_hs,
              long long k_rs, long long v_bs, long long v_hs, long long v_rs, int B, int S,
              int H, float scale, void* stream) {
  const Args a{q, k, v, out, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs,
               (long long)H * S * D, (long long)S * D, D, S, H, scale, true, stream};
  return launch(bf16, true, a, B);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int k1_attention_bf16(const void* q, const void* k, const void* v, void* out,
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, int B, int S, int H, float scale,
                      void* stream) {
  return launch_k1(true, q, k, v, out, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, S, H, scale,
                   stream);
}

int k1_attention_f32(const void* q, const void* k, const void* v, void* out,
                     long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                     long long v_bs, long long v_rs, int B, int S, int H, float scale,
                     void* stream) {
  return launch_k1(false, q, k, v, out, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, S, H, scale,
                   stream);
}

int k6_short_attention_bf16(const void* q, const void* k, const void* v, void* out,
                            long long q_bs, long long q_hs, long long q_rs, long long k_bs,
                            long long k_hs, long long k_rs, long long v_bs, long long v_hs,
                            long long v_rs, int B, int S, int H, float scale, void* stream) {
  return launch_k6(true, q, k, v, out, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, B,
                   S, H, scale, stream);
}

int k6_short_attention_f32(const void* q, const void* k, const void* v, void* out,
                           long long q_bs, long long q_hs, long long q_rs, long long k_bs,
                           long long k_hs, long long k_rs, long long v_bs, long long v_hs,
                           long long v_rs, int B, int S, int H, float scale, void* stream) {
  return launch_k6(false, q, k, v, out, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, B,
                   S, H, scale, stream);
}

const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
