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
// would take 0.04 ms at the dense bf16 peak).
//
// K1's bf16 design answers that bound (attn_bf16_kernel): one block per
// (head, batch item), 1536 blocks at 64 tiles, so each head's K and V are
// read once (a block per 64-row q tile read them six times over from L2).
// TMA brings them into shared memory, 86 KB at S = 329 in the 128-byte
// swizzled layout wgmma reads: TMA rather than cp.async because one thread
// issues a whole tile, rows past S arrive as zeros without a mask, and the
// swizzle costs no instruction; one mbarrier per key tile lets the first
// products start before the rest lands. Two warpgroups take the q tiles in
// turn; both products run on wgmma (bf16 in, f32 accumulate): s = q . k^T
// with both operands in shared memory, o += p . v with p in registers. The
// last key tile is cut to the live keys rounded up to 16 (336 key columns
// at S = 329, not 384). Two blocks fit on an SM at S = 329 (~101 KB each).
// K6's bf16 design is K1's (short_bf16_kernel): one block per (head, batch
// item), the head's K and V loaded once by TMA through rank-4 tensor maps
// over q, k and v's own (D, S, H, B) strides (a head-major view of a [B, S,
// H*D] buffer is read in place), two warpgroups taking the q tiles in turn,
// the logits on wgmma. Its rounding needs each row's max and sum before any
// p is formed, so a q tile makes two passes over the resident keys: pass 1
// takes s = q . k^T and the row max and sum (online, each key tile's max
// reduced over the row's quad), pass 2 takes s again, forms p = exp2(s - m)
// * (1/l) in f32, rounds it to bf16 and accumulates p . v on wgmma with p in
// registers. The K tiles land before the V tiles, each on a barrier of its
// own, so pass 1 starts on the first key tile. The output tile goes through
// the q tile's shared memory to a TMA store, which drops rows past S.

// Ragged S (329) is masked inside the kernel: q/k/v rows >= S are loaded as
// zeros (by TMA's out-of-bounds fill in K1), keys >= S get p = 0, and rows
// >= S are not stored.
//
// Two paths for each:
//   bf16  the main path. K1: online softmax (see attn_bf16_kernel), so p is
//         rounded to bf16 relative to the running row max; against the plain
//         version (exact max, p / l rounded to bf16) that stays within a few
//         bf16 ulps of the output scale. K6: the two passes above, exact max
//         (short_bf16_kernel).
//   f32   scalar FMAs, exact row max first, logits in shared memory (tests);
//         K6 divides p by l before p . v, K1 the output after.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::pack_bf16;

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // f32 path: query rows per block
constexpr int BK = 64;       // f32 path: keys per staged K/V chunk
constexpr int THREADS = 128;  // f32 path
constexpr int MAX_S = 512;
constexpr int LDF = D + 1;   // f32 tile row stride of the scalar path: conflict-free column reads

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

__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// ---- K1 bf16: wgmma over the head's K and V, resident in shared memory ------

constexpr int K1_WG = 2;                    // warpgroups; each runs one q tile at a time
constexpr int K1_THREADS = 128 * K1_WG;
constexpr int TILE_BYTES = 64 * D * 2;      // 64 rows of D bf16, 128-byte swizzled
constexpr int MAX_KT = MAX_S / 64;          // key tiles of 64

__host__ __device__ inline int key_tiles(int S) { return (S + 63) / 64; }
// keys of the last tile, rounded up to the 16 of one p . v step
__host__ __device__ inline int tail_keys(int S) { return (S - 64 * (key_tiles(S) - 1) + 15) / 16 * 16; }
// bytes of the head's K (or V) in shared memory: full tiles and the tail
__host__ __device__ inline int kv_bytes(int S) {
  return (key_tiles(S) - 1) * TILE_BYTES + tail_keys(S) * D * 2;
}
// the 1024-byte alignment, a q tile per warpgroup, K, V, the mbarriers
inline size_t k1_smem(int S) {
  return 1024 + (size_t)K1_WG * TILE_BYTES + 2 * (size_t)kv_bytes(S) + 8 * (MAX_KT + K1_WG);
}

// One tile of N keys (key0 the first) for the warpgroup's 64 q rows: the
// logits on wgmma, the online softmax in registers (running max m and sum
// l of rows g and g + 8, the accumulator rescaled by exp2(m_old - m_new)),
// then o += bf16(p) . v on wgmma with p as the register operand: the
// accumulator layout of s is, 16 keys at a time, the A fragment layout.
template <int N>
__device__ __forceinline__ void k1_tile(float (&o)[32], float (&m)[2], float (&l)[2],
                                        unsigned q_s, unsigned k_s, unsigned v_s, int key0,
                                        int S, float scale) {
  float s[N / 2];
  hopper::qk_tile<N>(s, q_s, k_s);
  const int tig = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + tig * 2 + (e & 1);
      s[4 * j + e] = key < S ? s[4 * j + e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  unsigned pa[N / 16][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - m[e >> 1]);
      l[e >> 1] += s[4 * j + e];
    }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  hopper::pv_tile<N>(o, pa, v_s);
}

// K1. One block per (head, batch item), two warpgroups. The head's K and V
// are loaded once, by TMA, into shared memory (a 64-row box per full tile
// and a box of the tail's live keys rounded up to 16; rows past S read as
// zeros), one mbarrier per tile, so the first products start when the
// first tile lands. Warpgroup w takes the q tiles w, w + 2, ...: its q tile
// arrives by TMA on its own mbarrier, runs over every key tile (k1_tile),
// and once the warpgroup is done with it the next q tile is requested
// while this one's rows are divided by l and stored. Each head's K and V
// cross from device memory to the SM once, not once per q tile, and the
// tail tile holds at most 15 dead keys.
__global__ void __launch_bounds__(K1_THREADS, 2)
    attn_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap ktail,
                     const __grid_constant__ CUtensorMap vtail, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int S = a.S, h = blockIdx.x, b = blockIdx.y;
  const int n_kt = key_tiles(S), tail = tail_keys(S);
  const unsigned k_s = base + K1_WG * TILE_BYTES, v_s = k_s + kv_bytes(S);
  const unsigned bars = v_s + kv_bytes(S);  // kv tiles' barriers, then the q tiles'
  const int tid = threadIdx.x, wg = hopper::warpgroup(), lt = tid % 128;
  const int warp = lt / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const unsigned q_s = base + wg * TILE_BYTES, q_bar = bars + 8 * (MAX_KT + wg);

  if (tid == 0) {
    for (int t = 0; t < n_kt; ++t) hopper::mbar_init(bars + 8 * t, 1);
    for (int w = 0; w < K1_WG; ++w) hopper::mbar_init(bars + 8 * (MAX_KT + w), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < K1_WG && w < n_kt; ++w) {
      hopper::mbar_expect_tx(bars + 8 * (MAX_KT + w), TILE_BYTES);
      hopper::tma_load_3d(base + w * TILE_BYTES, &qmap, bars + 8 * (MAX_KT + w), h * D, w * 64, b);
    }
    for (int t = 0; t < n_kt; ++t) {
      const bool last = t == n_kt - 1;
      hopper::mbar_expect_tx(bars + 8 * t, 2 * (last ? tail * D * 2 : TILE_BYTES));
      hopper::tma_load_3d(k_s + t * TILE_BYTES, last ? &ktail : &kmap, bars + 8 * t, h * D, t * 64,
                          b);
      hopper::tma_load_3d(v_s + t * TILE_BYTES, last ? &vtail : &vmap, bars + 8 * t, h * D, t * 64,
                          b);
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + b * a.o_bs + h * a.o_hs;
  unsigned phase = 0;
  for (int t = wg; t < n_kt; t += K1_WG, phase ^= 1) {
    hopper::mbar_wait(q_bar, phase);
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < n_kt - 1; ++c) {
      hopper::mbar_wait(bars + 8 * c, 0);
      k1_tile<64>(o, m, l, q_s, k_s + c * TILE_BYTES, v_s + c * TILE_BYTES, c * 64, S, a.scale);
    }
    {
      const int c = n_kt - 1;
      const unsigned kt = k_s + c * TILE_BYTES, vt = v_s + c * TILE_BYTES;
      hopper::mbar_wait(bars + 8 * c, 0);
      switch (tail) {
        case 16: k1_tile<16>(o, m, l, q_s, kt, vt, c * 64, S, a.scale); break;
        case 32: k1_tile<32>(o, m, l, q_s, kt, vt, c * 64, S, a.scale); break;
        case 48: k1_tile<48>(o, m, l, q_s, kt, vt, c * 64, S, a.scale); break;
        default: k1_tile<64>(o, m, l, q_s, kt, vt, c * 64, S, a.scale); break;
      }
    }
    // every warp of the warpgroup is done with its q tile: request the next
    hopper::named_sync(1 + wg, 128);
    if (lt == 0 && t + K1_WG < n_kt) {
      hopper::mbar_expect_tx(q_bar, TILE_BYTES);
      hopper::tma_load_3d(q_s, &qmap, q_bar, h * D, (t + K1_WG) * 64, b);
    }
    quad_sum(l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t * 64 + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<unsigned*>(og + row * a.o_rs + j * 8 + tig * 2) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---- K6 bf16: K1's blocks and tiles, two passes for the exact softmax ---------

constexpr int K6_THREADS = K1_THREADS;
// the 1024-byte alignment, a q tile per warpgroup, K, V, the mbarriers (a
// K and a V barrier per key tile, a q barrier per warpgroup)
inline size_t k6_smem(int S) {
  return 1024 + (size_t)K1_WG * TILE_BYTES + 2 * (size_t)kv_bytes(S) + 8 * (2 * MAX_KT + K1_WG);
}

// Where a rank-4 map keeps S, H and B: map dims 1..3, two bits each (the
// host orders each operand's dims by stride)
__device__ __forceinline__ void tma_bhsd(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int perm, int row, int h, int b) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? row : ph == 1 ? h : b;
  const int c2 = ps == 2 ? row : ph == 2 ? h : b;
  const int c3 = ps == 3 ? row : ph == 3 ? h : b;
  hopper::tma_load_4d(dst, map, bar, 0, c1, c2, c3);
}

// Pass 1 over one tile of N keys (key0 the first): s = q . k^T scaled to
// log2 units, keys >= S masked, the row max m (the quad's: every row sees
// key0) and the row sum l of exp2(s - m), l rescaled as m grows
template <int N>
__device__ __forceinline__ void k6_stats(float (&m)[2], float (&l)[2], unsigned q_s, unsigned k_s,
                                         int key0, int S, float scale) {
  float s[N / 2];
  hopper::qk_tile<N>(s, q_s, k_s);
  const int tig = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + tig * 2 + (e & 1);
      s[4 * j + e] = key < S ? s[4 * j + e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    l[r] *= exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[4 * j + e] - m[e >> 1]);
}

// Pass 2 over the same tile: s again, p = exp2(s - m) / l in f32, rounded
// to bf16, o += p . v
template <int N>
__device__ __forceinline__ void k6_pv(float (&o)[32], const float (&m)[2], const float (&inv)[2],
                                      unsigned q_s, unsigned k_s, unsigned v_s, int key0, int S,
                                      float scale) {
  float s[N / 2];
  hopper::qk_tile<N>(s, q_s, k_s);
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + tig * 2 + (e & 1);
      s[4 * j + e] = key < S ? exp2f(s[4 * j + e] * scale - m[e >> 1]) * inv[e >> 1] : 0.f;
    }
  unsigned pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  hopper::pv_tile<N>(o, pa, v_s);
}

// K6. One block per (head, batch item), two warpgroups, as K1: thread 0
// requests every K tile, then every V tile (a box of the tail's live keys
// rounded up to 16 last; rows past S read as zeros), each on its own
// mbarrier, and the first q tile of each warpgroup. Warpgroup w takes the q
// tiles w, w + 2, ...: pass 1 over the K tiles, pass 2 over K and V, then
// the output tile, rounded once, goes into the q tile's shared memory and
// out by a TMA store, and the next q tile is requested once the store has
// read it.
__global__ void __launch_bounds__(K6_THREADS, 2)
    short_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap ktail,
                      const __grid_constant__ CUtensorMap vtail,
                      const __grid_constant__ CUtensorMap omap, int perms, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int S = a.S, h = blockIdx.x, b = blockIdx.y;
  const int n_kt = key_tiles(S), tail = tail_keys(S);
  const int pq = perms & 63, pk = (perms >> 6) & 63, pv = (perms >> 12) & 63, po = perms >> 18;
  const unsigned k_s = base + K1_WG * TILE_BYTES, v_s = k_s + kv_bytes(S);
  const unsigned bars = v_s + kv_bytes(S);  // K tiles' barriers, V tiles', the q tiles'
  const int tid = threadIdx.x, wg = hopper::warpgroup(), lt = tid % 128;
  const int warp = lt / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const unsigned q_s = base + wg * TILE_BYTES, q_bar = bars + 8 * (2 * MAX_KT + wg);
  auto kbar = [&](int t) { return bars + 8 * t; };
  auto vbar = [&](int t) { return bars + 8 * (MAX_KT + t); };

  if (tid == 0) {
    for (int i = 0; i < 2 * MAX_KT + K1_WG; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < K1_WG && w < n_kt; ++w) {
      const unsigned bar = bars + 8 * (2 * MAX_KT + w);
      hopper::mbar_expect_tx(bar, TILE_BYTES);
      tma_bhsd(base + w * TILE_BYTES, &qmap, bar, pq, w * 64, h, b);
    }
    for (int t = 0; t < n_kt; ++t) {
      const bool last = t == n_kt - 1;
      hopper::mbar_expect_tx(kbar(t), last ? tail * D * 2 : TILE_BYTES);
      tma_bhsd(k_s + t * TILE_BYTES, last ? &ktail : &kmap, kbar(t), pk, t * 64, h, b);
    }
    for (int t = 0; t < n_kt; ++t) {
      const bool last = t == n_kt - 1;
      hopper::mbar_expect_tx(vbar(t), last ? tail * D * 2 : TILE_BYTES);
      tma_bhsd(v_s + t * TILE_BYTES, last ? &vtail : &vmap, vbar(t), pv, t * 64, h, b);
    }
  }

  const int c_last = n_kt - 1;
  const unsigned kt_last = k_s + c_last * TILE_BYTES, vt_last = v_s + c_last * TILE_BYTES;
  unsigned phase = 0;
  for (int t = wg; t < n_kt; t += K1_WG, phase ^= 1) {
    hopper::mbar_wait(q_bar, phase);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < c_last; ++c) {
      hopper::mbar_wait(kbar(c), 0);
      k6_stats<64>(m, l, q_s, k_s + c * TILE_BYTES, c * 64, S, a.scale);
    }
    hopper::mbar_wait(kbar(c_last), 0);
    switch (tail) {
      case 16: k6_stats<16>(m, l, q_s, kt_last, c_last * 64, S, a.scale); break;
      case 32: k6_stats<32>(m, l, q_s, kt_last, c_last * 64, S, a.scale); break;
      case 48: k6_stats<48>(m, l, q_s, kt_last, c_last * 64, S, a.scale); break;
      default: k6_stats<64>(m, l, q_s, kt_last, c_last * 64, S, a.scale); break;
    }
    quad_sum(l);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};

    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    for (int c = 0; c < c_last; ++c) {
      hopper::mbar_wait(vbar(c), 0);
      k6_pv<64>(o, m, inv, q_s, k_s + c * TILE_BYTES, v_s + c * TILE_BYTES, c * 64, S, a.scale);
    }
    hopper::mbar_wait(vbar(c_last), 0);
    switch (tail) {
      case 16: k6_pv<16>(o, m, inv, q_s, kt_last, vt_last, c_last * 64, S, a.scale); break;
      case 32: k6_pv<32>(o, m, inv, q_s, kt_last, vt_last, c_last * 64, S, a.scale); break;
      case 48: k6_pv<48>(o, m, inv, q_s, kt_last, vt_last, c_last * 64, S, a.scale); break;
      default: k6_pv<64>(o, m, inv, q_s, kt_last, vt_last, c_last * 64, S, a.scale); break;
    }

    // every warp is done reading its q tile: the output tile takes its place
    hopper::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        hopper::st_shared_u32(q_s + hopper::swz(warp * 16 + g + 8 * r, j) + tig * 4,
                              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]));
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (lt == 0) {
      const int ps = po & 3, ph = (po >> 2) & 3, row = t * 64;
      hopper::tma_store_4d(&omap, q_s, 0, ps == 1 ? row : ph == 1 ? h : b,
                           ps == 2 ? row : ph == 2 ? h : b, ps == 3 ? row : ph == 3 ? h : b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();
      if (t + K1_WG < n_kt) {
        hopper::mbar_expect_tx(q_bar, TILE_BYTES);
        tma_bhsd(q_s, &qmap, q_bar, pq, (t + K1_WG) * 64, h, b);
      }
    }
  }
  if (lt == 0) hopper::bulk_wait<0>();
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

// K1 bf16: the tensor maps of q, k and v (k and v twice: 64-row boxes and
// the tail's box), then one block per (head, batch item)
int launch_k1_bf16(const Args& a, int B) {
  const long long cols = (long long)a.H * D;
  CUtensorMap qm, km, vm, kt, vt;
  int err = hopper::encode_rows_bf16(&qm, a.q, cols, a.S, B, a.q_rs, a.q_bs, 64);
  if (!err) err = hopper::encode_rows_bf16(&km, a.k, cols, a.S, B, a.k_rs, a.k_bs, 64);
  if (!err) err = hopper::encode_rows_bf16(&vm, a.v, cols, a.S, B, a.v_rs, a.v_bs, 64);
  if (!err) err = hopper::encode_rows_bf16(&kt, a.k, cols, a.S, B, a.k_rs, a.k_bs, tail_keys(a.S));
  if (!err) err = hopper::encode_rows_bf16(&vt, a.v, cols, a.S, B, a.v_rs, a.v_bs, tail_keys(a.S));
  if (err) return err;
  const size_t smem = k1_smem(a.S);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bf16_kernel<<<dim3(a.H, B), K1_THREADS, smem, static_cast<cudaStream_t>(a.stream)>>>(
      qm, km, vm, kt, vt, a);
  return (int)cudaGetLastError();
}

// A rank-4 map of one [B, H, S, D] operand (D = 64, unit stride) with
// boxes of 64 values x ``box_rows`` rows of one head and batch item. Map
// dims 1..3 hold S, H and B in the order of their strides (strides of dims
// of size 1 do not matter: they are set to 64); ``perm`` receives where
// each went (two bits each: S, H, B).
int encode_bhsd(CUtensorMap* map, const void* base, int S, int H, int B, long long rs,
                long long hs, long long bs, int box_rows, int* perm) {
  const long long dm[3] = {S, H, B};
  long long st[3] = {rs, hs, bs};
  const int bx[3] = {box_rows, 1, 1};
  for (int i = 0; i < 3; ++i)
    if (dm[i] == 1) st[i] = D;
  int o[3] = {0, 1, 2};  // dims by stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && st[o[j]] < st[o[j - 1]]; --j) {
      const int t = o[j];
      o[j] = o[j - 1];
      o[j - 1] = t;
    }
  const long long dims[4] = {D, dm[o[0]], dm[o[1]], dm[o[2]]};
  const long long strides[3] = {st[o[0]], st[o[1]], st[o[2]]};
  const int box[4] = {D, bx[o[0]], bx[o[1]], bx[o[2]]};
  *perm = 0;
  for (int i = 0; i < 3; ++i) *perm |= (i + 1) << (2 * o[i]);
  return hopper::encode_4d_bf16(map, base, dims, strides, box);
}

// K6 bf16: the maps of q, k and v (k and v twice: 64-row boxes and the
// tail's box) and of the contiguous output, then one block per (head,
// batch item)
int launch_k6_bf16(const Args& a, int B) {
  const int tail = tail_keys(a.S);
  CUtensorMap qm, km, vm, kt, vt, om;
  int pq = 0, pk = 0, pv = 0, po = 0, unused = 0;
  int err = encode_bhsd(&qm, a.q, a.S, a.H, B, a.q_rs, a.q_hs, a.q_bs, 64, &pq);
  if (!err) err = encode_bhsd(&km, a.k, a.S, a.H, B, a.k_rs, a.k_hs, a.k_bs, 64, &pk);
  if (!err) err = encode_bhsd(&vm, a.v, a.S, a.H, B, a.v_rs, a.v_hs, a.v_bs, 64, &pv);
  if (!err) err = encode_bhsd(&kt, a.k, a.S, a.H, B, a.k_rs, a.k_hs, a.k_bs, tail, &unused);
  if (!err) err = encode_bhsd(&vt, a.v, a.S, a.H, B, a.v_rs, a.v_hs, a.v_bs, tail, &unused);
  if (!err) err = encode_bhsd(&om, a.out, a.S, a.H, B, a.o_rs, a.o_hs, a.o_bs, 64, &po);
  if (err) return err;
  const size_t smem = k6_smem(a.S);
  const cudaError_t e = cudaFuncSetAttribute(
      short_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  short_bf16_kernel<<<dim3(a.H, B), K6_THREADS, smem, static_cast<cudaStream_t>(a.stream)>>>(
      qm, km, vm, kt, vt, om, pq | pk << 6 | pv << 12 | po << 18, a);
  return (int)cudaGetLastError();
}

// K1 (short = false) or K6 (short = true), bf16 or f32; the f32 paths on
// grid (q tiles, H, B)
int launch(bool bf16, bool short_attn, const Args& a, int B) {
  if (B < 1 || a.H < 1 || a.S < 1 || a.S > MAX_S) return (int)cudaErrorInvalidValue;
  if (bf16) return short_attn ? launch_k6_bf16(a, B) : launch_k1_bf16(a, B);
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  // logits of 64 rows + Q and K/V tiles + row sums: above 48 KB, so opt in
  const size_t smem = ((size_t)BQ * logits_ld(a.S) + (size_t)(BQ + BK) * LDF + BQ) * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(a.stream)>>>(a);
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
