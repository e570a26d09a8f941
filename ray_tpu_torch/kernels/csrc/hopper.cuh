// Hopper (sm_90a) building blocks shared by the port's attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu) and tools/wgmma_products.cu: TMA
// loads and mbarriers, wgmma products of bf16 tiles in 128-byte swizzled
// shared memory with float32 sums in registers, the accumulator layout,
// the host-side tensor maps, and cp.async copies. Everything sits in an
// anonymous namespace, so each source that includes this header gets its
// own copy.
//
// Layout conventions: a tile of R rows and D bf16 columns is D / 64 slabs
// of [R][64] (128-byte rows, 1024-byte aligned), as a TMA box of 64 columns
// with the 128-byte swizzle writes them. The products are wgmma m64n64k16,
// and m64n128k16 for P V-like products over a pair of slabs: a 64 x D
// output is D / 64 accumulators of 32 floats a thread either way.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlab = 64;         // bf16 columns in one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` more of asynchronous copies on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Thread-block clusters. A block's rank in its cluster; the address, in
// the cluster's shared window, of this block's `p` in the peer block
// `rank`; 16-byte stores into a peer whose bytes count on the peer's
// mbarrier `bar` (a cluster address) as they land, so the peer's wait on
// that barrier sees them; an arrival on a peer's mbarrier (release at CTA
// scope, as a consumer frees a slot of its own shared memory that a peer
// fills: it orders this thread's reads of the slot, and does not wait for
// its stores into peers to land); mbar_wait with acquire at cluster scope
// (for barriers whose phase peers' bytes complete); and a barrier over
// every thread of the cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_async16(uint32_t dst, uint32_t bar,
                                           float4 x) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(__float_as_uint(x.x)), "r"(__float_as_uint(x.y)),
         "r"(__float_as_uint(x.z)), "r"(__float_as_uint(x.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// A bulk copy of `bytes` (a multiple of 16) from this block's shared
// memory `src` to a peer's (cluster address `dst`), its bytes counted on
// the peer's mbarrier `bar` as they land; the copy engine moves them while
// the threads go on. Writes of the threads to `src` must be made visible
// to it first (fence_proxy_async, then a barrier over the writers).
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier over `threads` threads of the block (named barrier `id`, 1-15).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// TMA: the box at (column c, head h, row r, batch b) of a [B, S, H, D]
// tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int h, int r,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c), "r"(h), "r"(r), "r"(b)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows with the
// 128-byte swizzle, as TMA writes it: start address, leading byte offset,
// stride byte offset (from one group of 8 rows to the next: 1024 bytes),
// layout type 1 (128-byte swizzle). Slabs are 1024-byte aligned, so the
// base offset is 0. The leading offset is not read for the K-major
// operands; for the transposed (MN-major) B operand it is the distance from
// one 64-column slab to the next, which a product of N 64 never crosses
// (the default, the 8-row stride, is then never used).
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo = 1024) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WGMMA_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_D32_OUT(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64 x 64] (= or +=) A[64 x 16] B[16 x 64], A and B K-major in shared
// memory (A rows and B columns are rows of 128-byte swizzled slabs).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define WGMMA_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WGMMA_D64_OUT(d)                                                    \
  WGMMA_D32_OUT(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory: 16 rows of
// a 128-byte swizzled slab, read transposed.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (as in wgmma_rs),
// B MN-major in shared memory: 16 rows of two 128-byte swizzled slabs (64
// columns each), read transposed. The descriptor's leading byte offset is
// the distance between the two slabs (see gemm_ax_wide). The accumulator
// layout extends that of m64n64: element i lies at row acc_row(i), column
// acc_col(i) for i < 64, so elements 32 h .. 32 h + 31 hold columns
// 64 h .. 64 h + 63 in the m64n64 layout.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s[64 x 64] = A B^T over columns 16 K0 .. 16 K1 - 1 of D (s += A B^T when
// `add` is nonzero): A is 64 rows of the K-major tile `a` (slabs of
// `a_rows` rows, starting at row `a_row0`), B the 64 rows of the K-major
// tile `bt` (slabs of `b_rows` rows, starting at row `b_row0`).
template <int D, int K0 = 0, int K1 = D / 16>
__device__ __forceinline__ void gemm_abt(float (&s)[32], const uint8_t* a,
                                         int a_rows, int a_row0,
                                         const uint8_t* bt, int b_rows,
                                         int b_row0, int add = 0) {
#pragma unroll
  for (int ks = K0; ks < K1; ++ks) {
    const int slab = ks / 4, byte = (ks % 4) * 32;
    wgmma_ss(s,
             sw128_desc(a + (slab * a_rows + a_row0) * 128 + byte),
             sw128_desc(bt + (slab * b_rows + b_row0) * 128 + byte),
             ks > K0 || add);
  }
}

// acc[slab][64 x 64] += A[64 x 64] X[64 x D], A the register fragments of
// four 16-column k-steps, X the 64 rows of the tile `x` (slabs of `x_rows`
// rows, starting at row `x_row0`), read transposed.
template <int D>
__device__ __forceinline__ void gemm_ax(float (&acc)[D / 64][32],
                                        const uint32_t (&a)[4][4],
                                        const uint8_t* x, int x_rows,
                                        int x_row0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int slab = 0; slab < D / 64; ++slab)
      wgmma_rs(acc[slab], a[j],
               sw128_desc(x + (slab * x_rows + x_row0 + 16 * j) * 128));
}

// acc[D / 64][64 x 64] += A[64 x 64] X[64 x D], D a multiple of 128:
// gemm_ax with one m64n128k16 product per k-step and pair of slabs instead
// of two m64n64k16 (the two 64 x 64 accumulators of a pair together are the
// m64n128 accumulator). X is the 64 rows of the tile `x` (slabs of `x_rows`
// rows, starting at row `x_row0`); each descriptor starts at the pair's
// first slab, and its leading byte offset steps to the second.
template <int D>
__device__ __forceinline__ void gemm_ax_wide(float (&acc)[D / 64][32],
                                             const uint32_t (&a)[4][4],
                                             const uint8_t* x, int x_rows,
                                             int x_row0) {
  static_assert(D % 128 == 0, "the products cover pairs of 64-column slabs");
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int pr = 0; pr < D / 128; ++pr) {
      float(&d)[64] = *reinterpret_cast<float(*)[64]>(&acc[2 * pr][0]);
      wgmma_rs_n128(
          d, a[j],
          sw128_desc(x + (2 * pr * x_rows + x_row0 + 16 * j) * 128,
                     x_rows * 128));
    }
}

// Element i of a thread's 64 x 64 tile in the wgmma accumulator layout
// lies at row acc_row(i), column acc_col(i) (row0 = 16 warp + lane / 4).
__device__ __forceinline__ int acc_row(int i, int row0) {
  return row0 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// A 64 x 64 accumulator tile rounded to bf16 as the register A fragments
// of four 16-column k-steps: the accumulator layout of columns 16 j ..
// 16 j + 15 is the m16n8k16 A fragment of k-step j.
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&frag)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      frag[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
}

// Writes a warpgroup's 64 x D float32 sums (accumulator layout, one 64 x 64
// tile per slab) as bf16 rows row0.. of a contiguous [rows, H, D] output.
template <int D>
__device__ __forceinline__ void store_tile(bf16* out, int64_t row_stride,
                                           const float (&acc)[D / 64][32],
                                           int row0, int lane) {
#pragma unroll
  for (int slab = 0; slab < D / 64; ++slab)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = acc_row(i, row0);
      const int col = 64 * slab + acc_col(i, lane);
      *reinterpret_cast<uint32_t*>(out + row * row_stride + col) =
          pack_bf16(acc[slab][i], acc[slab][i + 1]);
    }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int slab = 0; slab < D / 64; ++slab)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[slab][i] = 0.f;
}

// cp.async: 16-byte copies from device memory into shared memory that run
// under later instructions, in groups a thread commits and waits for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t off = smem_addr(p);
  return p + ((1024 - (off & 1023)) & 1023);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 that the CUDA runtime loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
                                          dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a bf16 [B, S, H, D] tensor with (batch, seq, head) strides
// `st` (elements; the last dimension contiguous), read in boxes of
// [rows][64] of one (batch, head) with the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int D, const int64_t* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {kSlab, 1, cuuint32_t(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A kernel's dynamic shared-memory limit, raised with cudaFuncSetAttribute
// on the first launch on each card and not again: a launch function holds
// one as a function-local static per kernel instantiation. With
// `big_clusters`, clusters of up to 16 blocks are allowed too (8 is the
// portable limit).
struct SmemLimit {
  const void* kernel;
  int bytes;
  bool big_clusters = false;
  std::atomic<uint64_t> cards{0};   // bit n: set on device n (n < 64)

  cudaError_t apply() {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = uint64_t(1) << (dev & 63);
    if (dev < 64 && (cards.load(std::memory_order_acquire) & bit)) {
      return cudaSuccess;
    }
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && big_clusters)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 64) cards.fetch_or(bit);
    return err;
  }
};

}  // namespace
