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
// x is zero-filled on load, and rows wholly outside the image are skipped.
//
// What bounds it on the H100. At the flagship shape (64 x 256^2 pixels,
// C = 32, K = 16, C2 = 16) the bytes are x read once and the output written
// once, 0.40 GB: 0.12 ms at 3.35 TB/s; the products (gate 32x256, psi-conv2
// 256, taps 32x144 and the 144-term stencil per pixel, 26.4 kFLOP) are 111
// GFLOP, 0.11 ms at the dense bf16 peak. The two floors are about equal;
// the design keeps every intermediate (g1, gate, m, the tap products) out
// of device memory and the products on the tensor cores.
//
// Design (bf16). A warp owns a strip of 16 halo columns (14 output columns)
// and walks down TH + 2 halo rows for TH = 16 output rows, so a pixel's
// chain is recomputed only at strip edges (~1.2x). Per halo row, the warp's
// 16 pixels are the 16 rows of mma.sync (m16n8k16) tiles: g1 head by head
// (the C fragment of x.w1 is, pair by pair, the A fragment of g1.w2, as the
// logits become the probabilities in K1), psi-conv2 as one mma per head with
// the head's w2 column (block-diagonal: the other 15 columns are zeros, and
// are not multiplied), and the tap matrix m tap by tap. A thread then holds
// m and gate for the same (pixel, head) pairs, so the tap products m*gate
// are formed in registers and written to a per-warp f32 row of [16][9K].
// The stencil is separable in registers: each thread sums the three dx taps
// of each dy for its (column, head) pairs, and three running row
// accumulators take the dy sums, so an output row leaves as soon as the
// halo row below it is done. Weights sit in shared memory once per block;
// blocks are persistent (one per SM, 12 warps) and walk the strips.
// The JAX kernel's two stacked 8-row blocks (16 rows computed for 8) and
// its dense [K*C2, K] psi-conv2 are TPU layout work and are not carried over.
//
// Heads: the kernel is built for C = 32, C2 = 16 and 16 heads; fewer heads
// arrive zero-padded to 16 (zero weights give m = 0) and are not stored.
//
// Two paths:
//   bf16  the main path (mma.sync, f32 accumulation and elementwise);
//   f32   scalar FMAs on 8 x 8 output tiles with the tap products of the
//         10 x 10 halo in shared memory (tests and f32 numerics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // input channels (the decoder's last fusion width)
constexpr int C2 = 16;         // gate features per head
constexpr int KH = 16;         // heads, padded
constexpr int NG = KH * C2;    // 256 gate features
constexpr int NM = 9 * KH;     // 144 tap columns, t*KH + k

struct Args {
  const void* x;     // [B, H, W, C]
  const void* w1t;   // [NG, C]: psi-conv1 with BN folded, output-major
  const void* b1;    // [NG]
  const void* w2;    // [KH, C2]
  const void* b2;    // [KH]
  const void* wmt;   // [NM, C]: the tap matrix, output-major
  const void* bf;    // [KH]
  void* out;         // [B, H, W, K]
  int B, H, W, K;
  int act;           // 0 none, 1 tanh, 2 sigmoid
};

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float activate(float v, int act) {
  return act == 1 ? tanhf(v) : act == 2 ? sigmoid_f32(v) : v;
}

// ---- bf16: warp strips on mma.sync ------------------------------------------

constexpr int SW = 16;            // halo columns per strip
constexpr int OW = SW - 2;        // output columns per strip
constexpr int TH = 16;            // output rows per strip
constexpr int WARPS = 12;
constexpr int THREADS = WARPS * 32;
constexpr int LDW = C + 8;        // 40 bf16 = 80 bytes: conflict-free ldmatrix rows
constexpr int LDV = NM;           // 144 f32: the stencil reads hit 32 distinct banks
constexpr int PAIRS = OW * KH / 32;  // (output column, head) pairs per lane: 7

static_assert(OW * KH % 32 == 0, "whole pairs per lane");

constexpr size_t SMEM_W = (size_t)(NG + NM) * LDW * 2 + KH * C2 * 2 + (NG + 2 * KH) * 4;
constexpr size_t SMEM_WARP = (size_t)2 * SW * LDW * 2 + (size_t)SW * LDV * 4;
constexpr size_t SMEM_BF16 = SMEM_W + WARPS * SMEM_WARP;

static_assert(SMEM_W % 16 == 0 && SMEM_WARP % 16 == 0, "16-byte aligned sections");

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

// The 16 halo pixels (row y, columns xh0 .. xh0 + 15) of image b into a
// warp's [SW][LDW] buffer; pixels outside the image are zero-filled.
__device__ __forceinline__ void load_halo_row(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                              const Args& a, int b, int y, int xh0, int lane) {
#pragma unroll
  for (int j = 0; j < SW * (C / 8) / 32; ++j) {
    const int i = lane + 32 * j;
    const int px = i / (C / 8), c = (i % (C / 8)) * 8;
    const int col = xh0 + px;
    const bool ok = y >= 0 && y < a.H && col >= 0 && col < a.W;
    const long long off = ok ? (((long long)b * a.H + y) * a.W + col) * C + c : 0;
    cp_async16(dst + px * LDW + c, x + off, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1) heads_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);  // [NG][LDW]
  __nv_bfloat16* wms = w1s + NG * LDW;                            // [NM][LDW]
  __nv_bfloat16* w2s = wms + NM * LDW;                            // [KH][C2]
  float* b1s = reinterpret_cast<float*>(w2s + KH * C2);           // [NG]
  float* b2s = b1s + NG;                                          // [KH]
  float* bfs = b2s + KH;                                          // [KH]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group / column pair
  unsigned char* mine = smem + SMEM_W + warp * SMEM_WARP;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(mine);           // [2][SW][LDW]
  float* vs = reinterpret_cast<float*>(mine + 2 * SW * LDW * 2);        // [SW][LDV]

  // weights, once per block
  const __nv_bfloat16* w1t = static_cast<const __nv_bfloat16*>(a.w1t);
  const __nv_bfloat16* wmt = static_cast<const __nv_bfloat16*>(a.wmt);
  for (int i = threadIdx.x; i < (NG + NM) * (C / 8); i += THREADS) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const __nv_bfloat16* src = r < NG ? w1t + r * C + c : wmt + (r - NG) * C + c;
    *reinterpret_cast<uint4*>(w1s + r * LDW + c) = *reinterpret_cast<const uint4*>(src);
  }
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(a.w2);
  const __nv_bfloat16* b1 = static_cast<const __nv_bfloat16*>(a.b1);
  const __nv_bfloat16* b2 = static_cast<const __nv_bfloat16*>(a.b2);
  const __nv_bfloat16* bf = static_cast<const __nv_bfloat16*>(a.bf);
  for (int i = threadIdx.x; i < KH * C2; i += THREADS) w2s[i] = w2[i];
  for (int i = threadIdx.x; i < NG; i += THREADS) b1s[i] = __bfloat162float(b1[i]);
  for (int i = threadIdx.x; i < KH; i += THREADS) {
    b2s[i] = __bfloat162float(b2[i]);
    bfs[i] = __bfloat162float(bf[i]);
  }
  __syncthreads();

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int n_sx = (a.W + OW - 1) / OW, n_sy = (a.H + TH - 1) / TH;
  const long long n_strips = (long long)a.B * n_sy * n_sx;

  for (long long s = (long long)blockIdx.x * WARPS + warp; s < n_strips;
       s += (long long)gridDim.x * WARPS) {
    const int sx = (int)(s % n_sx), sy = (int)((s / n_sx) % n_sy), b = (int)(s / n_sx / n_sy);
    const int x0 = sx * OW, y0 = sy * TH;  // first output column / row of the strip

    // rows of the three output rows in flight: r - 1 (prev), r (cur), r + 1
    // (next) while halo row r is added; lane pair j is (column 1 + i / 16,
    // head i % 16) of the strip with i = lane + 32 j
    float acc_p[PAIRS], acc_c[PAIRS], acc_n[PAIRS];
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) acc_p[j] = acc_c[j] = acc_n[j] = 0.f;

    load_halo_row(xs, x, a, b, y0 - 1, x0 - 1, lane);
    cp_async_commit();
    for (int r = -1; r <= TH; ++r) {
      const __nv_bfloat16* xw = xs + ((r + 1) & 1) * SW * LDW;
      if (r < TH) load_halo_row(xs + ((r + 2) & 1) * SW * LDW, x, a, b, y0 + r + 1, x0 - 1, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();

      float h0[PAIRS], h1[PAIRS], h2[PAIRS];
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) h0[j] = h1[j] = h2[j] = 0.f;
      const int y = y0 + r;
      if (y >= 0 && y < a.H) {  // rows outside the image contribute exactly 0
        unsigned af[2][4];  // the 16 pixels x 32 channels as two A fragments
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          ldmatrix_x4(af[kk], xw + (lane & 15) * LDW + kk * 16 + (lane >> 4) * 8);

        // gate pre-activation [16 px][16 heads]: two n8 tiles
        float gp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          float c1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            unsigned kb[4];  // w1 rows h*16 + 0..7 and + 8..15, channels kk*16 + 0..15
            ldmatrix_x4(kb, w1s + (h * C2 + (lane & 7) + ((lane >> 4) << 3)) * LDW + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma16816(c1[0], af[kk], kb);
            mma16816(c1[1], af[kk], kb + 2);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c1[n][e] = fmaxf(c1[n][e] + b1s[h * C2 + n * 8 + tig * 2 + (e & 1)], 0.f);
          const unsigned pa[4] = {pack_bf16(c1[0][0], c1[0][1]), pack_bf16(c1[0][2], c1[0][3]),
                                  pack_bf16(c1[1][0], c1[1][1]), pack_bf16(c1[1][2], c1[1][3])};
          // head h's w2 as column h % 8 of the n8 tile h / 8; the rest zero
          unsigned wb[2] = {0u, 0u};
          if (g == (h & 7)) {
            wb[0] = *reinterpret_cast<const unsigned*>(w2s + h * C2 + tig * 2);
            wb[1] = *reinterpret_cast<const unsigned*>(w2s + h * C2 + tig * 2 + 8);
          }
          mma16816(gp[h >> 3], pa, wb);
        }
        float gate[2][4];  // head n*8 + tig*2 + (e & 1) of pixel g + 8*(e >> 1)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) gate[n][e] = sigmoid_f32(gp[n][e] + b2s[n * 8 + tig * 2 + (e & 1)]);

        // tap products m * gate, tap by tap, into the warp's [16][144] row
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float mm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            unsigned kb[4];
            ldmatrix_x4(kb, wms + (t * KH + (lane & 7) + ((lane >> 4) << 3)) * LDW + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma16816(mm[0], af[kk], kb);
            mma16816(mm[1], af[kk], kb + 2);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = t * KH + n * 8 + tig * 2;
            *reinterpret_cast<float2*>(vs + g * LDV + col) =
                make_float2(mm[n][0] * gate[n][0], mm[n][1] * gate[n][1]);
            *reinterpret_cast<float2*>(vs + (g + 8) * LDV + col) =
                make_float2(mm[n][2] * gate[n][2], mm[n][3] * gate[n][3]);
          }
        }
        __syncwarp();

        // the three dx taps of each dy, for this lane's (column, head) pairs
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int i = lane + 32 * j;
          const float* vp = vs + (i >> 4) * LDV + (i & 15);  // halo column (1 + i/16) - 1
          h0[j] = vp[0 * KH] + vp[LDV + 1 * KH] + vp[2 * LDV + 2 * KH];
          h1[j] = vp[3 * KH] + vp[LDV + 4 * KH] + vp[2 * LDV + 5 * KH];
          h2[j] = vp[6 * KH] + vp[LDV + 7 * KH] + vp[2 * LDV + 8 * KH];
        }
      }

      // halo row r feeds output row r + 1 through dy = 0, row r through
      // dy = 1 and row r - 1 through dy = 2, which is then complete
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        acc_p[j] += h2[j];
        acc_c[j] += h1[j];
        acc_n[j] = h0[j];
      }
      const int oy = y0 + r - 1;
      if (r >= 1 && oy < a.H) {
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int i = lane + 32 * j;
          const int col = x0 + (i >> 4), k = i & 15;
          if (col < a.W && k < a.K)
            out[(((long long)b * a.H + oy) * a.W + col) * a.K + k] =
                __float2bfloat16(activate(acc_p[j] + bfs[k], a.act));
        }
      }
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        acc_p[j] = acc_c[j];
        acc_c[j] = acc_n[j];
      }
      __syncwarp();  // the buffers of this row are free for the next loads
    }
    cp_async_wait<0>();
    __syncwarp();
  }
}

// ---- f32 (tests): scalar FMAs on 8 x 8 output tiles -------------------------

constexpr int FT = 8;                   // output tile side
constexpr int FH = FT + 2;              // halo tile side
constexpr int FTHREADS = 256;
constexpr int LDX = C + 1;              // f32 x row stride: conflict-free column reads

constexpr size_t SMEM_F32 =
    ((size_t)FH * FH * LDX + (size_t)(NG + NM) * C + KH * C2 + NG + 2 * KH + (size_t)FH * FH * NM) *
    sizeof(float);

__global__ void __launch_bounds__(FTHREADS) heads_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [FH*FH][LDX]
  float* w1s = xs + FH * FH * LDX;             // [NG][C]
  float* wms = w1s + NG * C;                   // [NM][C]
  float* w2s = wms + NM * C;                   // [KH][C2]
  float* b1s = w2s + KH * C2;                  // [NG]
  float* b2s = b1s + NG;
  float* bfs = b2s + KH;
  float* vs = bfs + KH;                        // [FH*FH][NM]

  const int n_tx = (a.W + FT - 1) / FT, n_ty = (a.H + FT - 1) / FT;
  const int tx = blockIdx.x % n_tx, ty = (blockIdx.x / n_tx) % n_ty, b = blockIdx.x / (n_tx * n_ty);
  const int x0 = tx * FT, y0 = ty * FT;
  const float* x = static_cast<const float*>(a.x);

  for (int i = threadIdx.x; i < NG * C; i += FTHREADS) w1s[i] = static_cast<const float*>(a.w1t)[i];
  for (int i = threadIdx.x; i < NM * C; i += FTHREADS) wms[i] = static_cast<const float*>(a.wmt)[i];
  for (int i = threadIdx.x; i < KH * C2; i += FTHREADS) w2s[i] = static_cast<const float*>(a.w2)[i];
  for (int i = threadIdx.x; i < NG; i += FTHREADS) b1s[i] = static_cast<const float*>(a.b1)[i];
  for (int i = threadIdx.x; i < KH; i += FTHREADS) {
    b2s[i] = static_cast<const float*>(a.b2)[i];
    bfs[i] = static_cast<const float*>(a.bf)[i];
  }
  for (int i = threadIdx.x; i < FH * FH * C; i += FTHREADS) {
    const int q = i / C, c = i % C;
    const int y = y0 - 1 + q / FH, col = x0 - 1 + q % FH;
    const bool ok = y >= 0 && y < a.H && col >= 0 && col < a.W;
    xs[q * LDX + c] = ok ? x[(((long long)b * a.H + y) * a.W + col) * C + c] : 0.f;
  }
  __syncthreads();

  // tap products of every (halo pixel, head)
  for (int i = threadIdx.x; i < FH * FH * KH; i += FTHREADS) {
    const int q = i % (FH * FH), h = i / (FH * FH);
    const int y = y0 - 1 + q / FH, col = x0 - 1 + q % FH;
    float* vq = vs + q * NM + h;
    if (y < 0 || y >= a.H || col < 0 || col >= a.W) {
#pragma unroll
      for (int t = 0; t < 9; ++t) vq[t * KH] = 0.f;
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
      const float* wr = wms + (t * KH + h) * C;
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) m = fmaf(xq[c], wr[c], m);
      vq[t * KH] = m * gate;
    }
  }
  __syncthreads();

  // the 9-tap stencil of every (output pixel, head)
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < FT * FT * KH; i += FTHREADS) {
    const int p = i % (FT * FT), h = i / (FT * FT);
    const int py = p / FT, px = p % FT;
    const int y = y0 + py, col = x0 + px;
    if (y >= a.H || col >= a.W || h >= a.K) continue;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int q = (py + t / 3) * FH + px + t % 3;
      acc += vs[q * NM + t * KH + h];
    }
    out[(((long long)b * a.H + y) * a.W + col) * a.K + h] = activate(acc + bfs[h], a.act);
  }
}

int launch(bool bf16, const void* x, const void* w1t, const void* b1, const void* w2,
           const void* b2, const void* wmt, const void* bf, void* out, int B, int H, int W,
           int K, int act, void* stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > KH || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w1t, b1, w2, b2, wmt, bf, out, B, H, W, K, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        heads_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    const long long strips = (long long)B * ((H + TH - 1) / TH) * ((W + OW - 1) / OW);
    const long long blocks = (strips + WARPS - 1) / WARPS;
    heads_bf16_kernel<<<(unsigned)(blocks < sms ? blocks : sms), THREADS, SMEM_BF16, st>>>(a);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        heads_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)B * ((H + FT - 1) / FT) * ((W + FT - 1) / FT);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    heads_f32_kernel<<<(unsigned)tiles, FTHREADS, SMEM_F32, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x [B, H, W, 32]
// and out [B, H, W, K] (K <= 16) are contiguous; the weights are the padded,
// output-major tensors of ops/seg_heads.py::_padded_weights.
int k3_seg_heads_bf16(const void* x, const void* w1t, const void* b1, const void* w2,
                      const void* b2, const void* wmt, const void* bf, void* out, int B, int H,
                      int W, int K, int act, void* stream) {
  return launch(true, x, w1t, b1, w2, b2, wmt, bf, out, B, H, W, K, act, stream);
}

int k3_seg_heads_f32(const void* x, const void* w1t, const void* b1, const void* w2,
                     const void* b2, const void* wmt, const void* bf, void* out, int B, int H,
                     int W, int K, int act, void* stream) {
  return launch(false, x, w1t, b1, w2, b2, wmt, bf, out, B, H, W, K, act, stream);
}

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
