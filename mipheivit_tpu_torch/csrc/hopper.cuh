// Hopper (sm_90a) building blocks shared by the port's kernels: cp.async,
// the 128-byte swizzled shared-memory layout and wgmma's matrix
// descriptors, wgmma issue and synchronisation, mbarriers, TMA loads, named
// barriers, and on the host the encoding of TMA tensor maps. K1
// (attention.cu), K2 and K7 (swiglu.cu) and K5 (flash_attention_bwd.cu)
// include it.
//
// The tile layout. A tile of rows of 64 bf16 values (128 bytes) lives at a
// 1024-byte aligned base; 16-byte chunk c of row r sits at r*128 +
// ((c ^ (r & 7)) << 4), which is what TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B and what wgmma reads under the 128-byte
// swizzle. One descriptor (smem_desc: 8-row groups 1024 bytes apart) reads
// such a tile both ways:
//   K-major  (the product's depth runs along the row): the 16-deep slice k
//            starts 32*k bytes into the tile;
//   MN-major (the depth runs down the rows, transpose flag 1): the slice of
//            rows 16k .. 16k + 15 starts 2048*k bytes into the tile; the
//            64 values of a row are the M or N extent.
//
// Build: included by a .cu compiled with nvcc -gencode
// arch=compute_90a,code=sm_90a; libcuda's cuTensorMapEncodeTiled is looked
// up at run time (cudaGetDriverEntryPoint), so nothing links against it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- the 128-byte swizzled layout and wgmma --------------------------------------

// Byte offset of 16-byte chunk c (0..7) of row r in a tile of 128-byte rows.
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (unsigned)(r * 128 + ((c ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor of a tile in that layout: 128-byte
// swizzle, 8-row groups 1024 bytes apart (the stride byte offset); the
// leading byte offset is unused at a width of 64 values.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across an async wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) become
// visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 16] (+)= A[64 x 16] . B[16 x 16]^T, A and B in shared memory
// (descriptors; TA / TB = 1: that operand is MN-major, else K-major);
// acc = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], unsigned long long da,
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T, A and B in shared memory
// (descriptors; TA / TB = 1: that operand is MN-major, else K-major);
// acc = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], unsigned long long da,
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 48] (+)= A[64 x 16] . B[48 x 16]^T, A and B in shared memory
// (descriptors; TA / TB = 1: that operand is MN-major, else K-major);
// acc = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], unsigned long long da,
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B in shared memory
// (descriptors; TA / TB = 1: that operand is MN-major, else K-major);
// acc = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], unsigned long long da,
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 96] (+)= A[64 x 16] . B[96 x 16]^T, A and B in shared memory
// (descriptors; TA / TB = 1: that operand is MN-major, else K-major);
// acc = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], unsigned long long da,
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T with A in registers (four
// bf16x2 per thread, the accumulator layout of a 64 x 16 tile) and B in
// shared memory (TB = 1: MN-major); acc = 0 overwrites d
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4],
                                            unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// registers of every thread of the warpgroup, moved between warpgroups
// (the count a multiple of 8 in 24 .. 256; all four warps execute it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the warpgroup of this thread, taken from lane 0 so that the compiler
// sees it uniform across the warp: a branch on it is not divergent, and
// the wgmma inside is not serialized
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

// ---- mbarriers, TMA, named barriers ---------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// after every mbar_init of the block, before any thread uses a barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also expects ``bytes`` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits until the barrier's phase with parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box of a 3-D tensor map at coordinates (c0, c1, c2) into shared memory,
// completing on ``bar``
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) of contiguous
// memory into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a box of shared memory (the tensor map's box and swizzle) added, f32,
// into the tensor at coordinates (c0, c1, c2): rows out of bounds are
// dropped; in this thread's bulk group
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, unsigned src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier ``id`` (1 .. 15) among ``n`` threads of whole warps: wait for all,
// or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- host: TMA tensor maps --------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, looked up once (null where the
// installed libcuda lacks it)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over rows of ``type`` (``esize`` bytes a value): ``cols``
// values per row (unit stride), ``rows`` rows ``rs`` values apart,
// ``batches`` batch items ``bs`` values apart. Boxes of ``box_cols`` values
// (128 bytes) x ``box_rows`` rows of one batch item land in the 128-byte
// swizzled layout; rows at or past ``rows`` read as zeros (and are dropped
// by a reduction into the tensor). Returns a cudaError_t
// (cudaErrorInvalidValue where the driver refuses).
inline int encode_rows(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                       long long cols, long long rows, long long batches, long long rs,
                       long long bs, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * esize,
                                 (cuuint64_t)(batches > 1 ? bs : rs * rows) * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// bf16 rows, boxes of 64 values
inline int encode_rows_bf16(CUtensorMap* map, const void* base, long long cols, long long rows,
                            long long batches, long long rs, long long bs, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows, batches, rs, bs,
                     box_rows);
}

}  // namespace hopper
