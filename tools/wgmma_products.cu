// Test kernels for tools/wgmma_products.py: each wgmma product of the bf16
// attention kernels (the helpers of ray_tpu_torch/kernels/csrc/hopper.cuh,
// which this file includes) run alone on one 64-row tile, and the float32
// accumulation error of a chain of k-steps.
#include "../ray_tpu_torch/kernels/csrc/hopper.cuh"

namespace {

// Loads `rows` x D of each map's tensor (row offset blockIdx.x or .y times
// 64) into 128-byte swizzled slabs, one mbarrier.
template <int D>
__device__ void load_tiles(uint8_t* a, const CUtensorMap* ta, int ra,
                           uint8_t* b, const CUtensorMap* tb, int rb,
                           uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar, (tb != nullptr ? 2 : 1) * 64 * D * 2);
    for (int s = 0; s < D / 64; ++s) {
      tma_load(a + s * 64 * 128, ta, bar, s * kSlab, 0, ra, 0);
      if (tb != nullptr) tma_load(b + s * 64 * 128, tb, bar, s * kSlab, 0, rb, 0);
    }
  }
  mbar_wait(bar, 0);
}

// c[64 x 64] = A B^T (gemm_abt; A, B [64 x D], K-major), stored row-major.
template <int D>
__global__ void product_abt(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb,
                            float* c) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = align1024(raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 2 * 64 * D * 2);
  load_tiles<D>(sm, &ta, 0, sm + 64 * D * 2, &tb, 0, bar);
  const int lane = threadIdx.x % 32, row0 = 16 * (threadIdx.x / 32) + lane / 4;
  float acc[32];
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
  gemm_abt<D>(acc, sm, 64, 0, sm + 64 * D * 2, 64, 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  for (int i = 0; i < 32; ++i)
    c[acc_row(i, row0) * 64 + acc_col(i, lane)] = acc[i];
}

// c[64 x D] = round(P) X (gemm_ax, or gemm_ax_wide when N128; P [64 x 64]
// float32 read into the accumulator layout and packed as register A
// fragments, X [64 x D] read transposed), stored row-major.
template <int D, bool N128 = false>
__global__ void product_ax(const float* p, const __grid_constant__ CUtensorMap tx,
                           float* c) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = align1024(raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 64 * D * 2);
  load_tiles<D>(sm, &tx, 0, nullptr, nullptr, 0, bar);
  const int lane = threadIdx.x % 32, row0 = 16 * (threadIdx.x / 32) + lane / 4;
  float pv[32];
  for (int i = 0; i < 32; ++i) pv[i] = p[acc_row(i, row0) * 64 + acc_col(i, lane)];
  uint32_t frag[4][4];
  to_frags(pv, frag);
  float acc[D / 64][32];
  zero<D>(acc);
  wgmma_fence();
  if constexpr (N128) {
    gemm_ax_wide<D>(acc, frag, sm, 64, 0);
  } else {
    gemm_ax<D>(acc, frag, sm, 64, 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int s = 0; s < D / 64; ++s) reg_fence(acc[s]);
  for (int s = 0; s < D / 64; ++s)
    for (int i = 0; i < 32; ++i)
      c[acc_row(i, row0) * D + 64 * s + acc_col(i, lane)] = acc[s][i];
}

// c[1024 x 1024] = A B^T, each 64 x 64 tile summed as D / 16 / P chains of
// P k-steps, the chains added in float32.
template <int D, int P>
__global__ void chains_abt(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, float* c) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = align1024(raw);
  uint8_t* a = sm;
  uint8_t* b = sm + 64 * D * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 2 * 64 * D * 2);
  load_tiles<D>(a, &ta, 64 * blockIdx.x, b, &tb, 64 * blockIdx.y, bar);
  const int lane = threadIdx.x % 32, row0 = 16 * (threadIdx.x / 32) + lane / 4;
  float acc[32], part[32];
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
#pragma unroll
  for (int g = 0; g < D / 16 / P; ++g) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P; ++kk) {
      const int ks = g * P + kk;
      wgmma_ss(part, sw128_desc(a + (ks / 4) * 64 * 128 + (ks % 4) * 32),
               sw128_desc(b + (ks / 4) * 64 * 128 + (ks % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  for (int i = 0; i < 32; ++i)
    c[(64 * blockIdx.x + acc_row(i, row0)) * 1024 + 64 * blockIdx.y +
      acc_col(i, lane)] = acc[i];
}

template <typename K, typename... Args>
int run(K kernel, dim3 grid, int smem, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 128, smem>>>(args...);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : cudaDeviceSynchronize();
}

}  // namespace

extern "C" {

// a, b: [rows, D] bf16 contiguous, rows 64 (the products) or 1024 (chains).
int wgmma_abt(const void* a, const void* b, float* c, int D) {
  CUtensorMap ta, tb;
  const int64_t st[3] = {64LL * D, D, D};
  cudaError_t e;
  if ((e = make_map(&ta, a, 1, 64, 1, D, st, 64)) != cudaSuccess ||
      (e = make_map(&tb, b, 1, 64, 1, D, st, 64)) != cudaSuccess)
    return e;
  const int smem = 1024 + 2 * 64 * D * 2 + 16;
  if (D == 64) return run(product_abt<64>, 1, smem, ta, tb, c);
  if (D == 128) return run(product_abt<128>, 1, smem, ta, tb, c);
  if (D == 256) return run(product_abt<256>, 1, smem, ta, tb, c);
  return cudaErrorInvalidValue;
}

// gemm_ax_wide (m64n128k16 over pairs of slabs): D 128 and 256.
int wgmma_ax_wide(const float* p, const void* x, float* c, int D) {
  CUtensorMap tx;
  const int64_t st[3] = {64LL * D, D, D};
  cudaError_t e = make_map(&tx, x, 1, 64, 1, D, st, 64);
  if (e != cudaSuccess) return e;
  const int smem = 1024 + 64 * D * 2 + 16;
  if (D == 128) return run(product_ax<128, true>, 1, smem, p, tx, c);
  if (D == 256) return run(product_ax<256, true>, 1, smem, p, tx, c);
  return cudaErrorInvalidValue;
}

int wgmma_ax(const float* p, const void* x, float* c, int D) {
  CUtensorMap tx;
  const int64_t st[3] = {64LL * D, D, D};
  cudaError_t e = make_map(&tx, x, 1, 64, 1, D, st, 64);
  if (e != cudaSuccess) return e;
  const int smem = 1024 + 64 * D * 2 + 16;
  if (D == 64) return run(product_ax<64>, 1, smem, p, tx, c);
  if (D == 128) return run(product_ax<128>, 1, smem, p, tx, c);
  if (D == 256) return run(product_ax<256>, 1, smem, p, tx, c);
  return cudaErrorInvalidValue;
}

int wgmma_chains(const void* a, const void* b, float* c, int D, int P) {
  CUtensorMap ta, tb;
  const int64_t st[3] = {1024LL * D, D, D};
  cudaError_t e;
  if ((e = make_map(&ta, a, 1, 1024, 1, D, st, 64)) != cudaSuccess ||
      (e = make_map(&tb, b, 1, 1024, 1, D, st, 64)) != cudaSuccess)
    return e;
  const int smem = 1024 + 2 * 64 * D * 2 + 16;
  const dim3 grid(16, 16);
  if (D == 256 && P == 16) return run(chains_abt<256, 16>, grid, smem, ta, tb, c);
  if (D == 256 && P == 8) return run(chains_abt<256, 8>, grid, smem, ta, tb, c);
  if (D == 256 && P == 4) return run(chains_abt<256, 4>, grid, smem, ta, tb, c);
  if (D == 128 && P == 8) return run(chains_abt<128, 8>, grid, smem, ta, tb, c);
  if (D == 128 && P == 4) return run(chains_abt<128, 4>, grid, smem, ta, tb, c);
  if (D == 128 && P == 1) return run(chains_abt<128, 1>, grid, smem, ta, tb, c);
  if (D == 64 && P == 4) return run(chains_abt<64, 4>, grid, smem, ta, tb, c);
  if (D == 64 && P == 2) return run(chains_abt<64, 2>, grid, smem, ta, tb, c);
  if (D == 64 && P == 1) return run(chains_abt<64, 1>, grid, smem, ta, tb, c);
  return cudaErrorInvalidValue;
}

}  // extern "C"
