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
// Layout. q is [B, Sq, H*D], k and v are [B, Sk, H*D]; each has a base
// pointer, a batch stride and a row stride, so the q | k | v sections of one
// fused [B, S, 3*H*D] qkv buffer are read in place (no split copy, no head
// transpose, no padding copy). The head offset h*D lies in the unit-stride
// last dimension. out is written as [B, Sq, H*D], lse as [B, H, Sq] f32.
// Every offset is taken in 64-bit arithmetic: the fused buffer of a batch of
// 16 regions (S = 5334) holds 3.9e8 elements.
//
// What bounds it on the H100. A 1024 px region (S = 5334, H = 24) is
// 4*S^2*D*H = 1.75e11 FLOP per image and block, against 2*S*H*D*2 bytes of
// q/k/v and out per pass: thousands of FLOP per byte, so it is bound by the
// tensor cores and by how well the loop keeps them fed, not by memory. The
// design is the simple one: one block per (64-row q tile, head, batch) of
// four warps, each owning 16 q rows; K/V tiles of 64 keys stream through
// double-buffered shared memory (cp.async); both products run on mma.sync
// m16n8k16 (bf16 in, f32 accumulate); logits, probabilities and the output
// accumulator stay in registers. wgmma, TMA and warp specialisation are left
// for later.
//
// Masking. Keys at or past seq_len_k are a suffix: key tiles that hold none
// below seq_len_k are never visited, K/V rows at or past seq_len_k are
// zero-filled on load (so padding that holds NaN or Inf cannot reach
// p . v), and the remaining masked keys of the last tile get -inf before the
// row max. Every visited tile has at least one live key, so the running max
// is finite from the first tile on and exp2(m_old - m_new) never sees
// (-inf) - (-inf). Rows at or past Sq are zero-filled and not stored.
//
// Where p is rounded (bf16 path). The TPU kernel keeps p in f32 for p . v.
// Here p is rounded to bf16 for the second mma (relative to the running row
// max), as K1 does: about 2^-9 relative error per probability, averaged
// over the keys; the row sum l and the lse are taken from the f32 p. Against
// the plain version (f32 p) that stays within 2e-2 of unit-scale outputs
// and 1e-3 of the lse. The f32 path keeps p in f32 throughout.
//
// Two paths:
//   bf16  the serving path: mma.sync as above.
//   f32   scalar FMAs with logits and p in shared memory (tests, numerics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int WARPS = 4;     // bf16: each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDT = D + 8;   // bf16 tile row stride: conflict-free ldmatrix rows
constexpr int LDF = D + 1;   // f32 tile row stride: conflict-free column reads
constexpr float LN2 = 0.6931471805599453f;

static_assert(BQ == WARPS * 16, "one 16-row mma tile per warp");
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

// One block per (64-row q tile, head, batch). K and V stream through
// double-buffered shared tiles of 64 keys. The mma C fragment of q . k^T is,
// pair by pair, the A fragment of p . v, so p never leaves registers.
__global__ void __launch_bounds__(THREADS, 4) flash_bf16_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 sQ[BQ * LDT];
  __shared__ __align__(128) __nv_bfloat16 sK[2][BK * LDT];
  __shared__ __align__(128) __nv_bfloat16 sV[2][BK * LDT];

  const int L = a.L;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group / column pair
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * D;
  const int n_kv = (L + BK - 1) / BK;  // tiles with at least one live key

  load_tile_async(sQ, qg, a.q_rs, q0, a.Sq);
  load_tile_async(sK[0], kg, a.k_rs, 0, L);
  load_tile_async(sV[0], vg, a.v_rs, 0, L);
  cp_async_commit();

  unsigned qf[D / 16][4];  // this warp's 16 q rows as A fragments, one per 16 of D
  float o[D / 8][4];       // output accumulator: 8 tiles of 16 rows x 8 dims
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      load_tile_async(sK[(j + 1) & 1], kg, a.k_rs, (j + 1) * BK, L);
      load_tile_async(sV[(j + 1) & 1], vg, a.v_rs, (j + 1) * BK, L);
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
    const __nv_bfloat16* ks = sK[j & 1];
    const __nv_bfloat16* vs = sV[j & 1];

    // s = q . k^T over this tile's 64 keys: 8 tiles of 16 rows x 8 keys
    float s[BK / 8][4];
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

    // scale to log2 units, mask keys >= L, online softmax
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BK + t * 8 + tig * 2 + (e & 1);
        s[t][e] = key < L ? s[t][e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf, mx finite)
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

    // o += bf16(p) . v, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];  // keys kk*16 + 0..15, dims dp*16 + 0..7 and + 8..15
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LDT + dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pa, vb);
        mma16816(o[2 * dp + 1], pa, vb + 2);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long hd = (long long)a.H * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + (long long)b * a.Sq * hd + h * D;
  float* lg = a.lse + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      *reinterpret_cast<unsigned*>(og + row * hd + t * 8 + tig * 2) =
          pack_bf16(o[t][2 * r] / l[r], o[t][2 * r + 1] / l[r]);
    }
    if (tig == 0) lg[row] = m[r] * LN2 + logf(l[r]);
  }
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

int launch(bool bf16, const void* q, const void* k, const void* v, void* out, float* lse,
           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
           long long v_bs, long long v_rs, int B, int Sq, int Sk, int L, int H, float scale,
           void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || L < 1 || L > Sk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, Sq, L, H, scale};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    flash_bf16_kernel<<<grid, THREADS, 0, st>>>(a);  // static shared memory, 46 KB
  } else {
    // Q, K/V and logit tiles + row state: above 48 KB, so opt in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<<<grid, THREADS, F32_SMEM, st>>>(a);
  }
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
