// Test kernels for tools/tf32x3_products.py: chains of float32 products on
// the tensor cores as 3xTF32 with mma.sync m16n8k8, in the fragment layouts
// a float32 attention backward would use (S = Q K^T from row-major tiles;
// P X with P an accumulator turned into the next A operand), one warp per
// tile, fragments read straight from device memory. mode 0: 3xTF32 (hi/lo
// split, three passes); mode 1: one TF32 pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 products on the tensor cores: 3xTF32 with mma.sync m16n8k8.
//
// The tensor cores take float32 only as TF32 (10 mantissa bits). Each
// operand x is split as hi + lo, hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (ties away), and a b is summed as lo_a hi_b + hi_a
// lo_b + hi_a hi_b in float32: only lo_a lo_b (about 2^-22 of |a b|) and
// the roundings of lo (2^-11 of lo, 2^-22 of x) are lost, within a small
// factor of float32 FMA's own rounding; one TF32 pass loses 2^-11.
//
// Fragments of one warp (lane = 4 g + t): the A operand [16 x 8] holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B [8 x 8] holds (k t,
// n g), (k t + 4, n g); the accumulator [16 x 8] holds (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1).

struct Tf32x2 {   // a float32 fragment split into TF32 hi and lo parts
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  Tf32x2 r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r.hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r.lo) : "f"(x - __uint_as_float(r.hi)));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b over one k-step of 8, the two small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const Tf32x2 (&a)[4],
                                           const Tf32x2 (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// One TF32 pass, for comparison.
__device__ __forceinline__ void mma_1xtf32(float (&d)[4],
                                           const Tf32x2 (&a)[4],
                                           const Tf32x2 (&b)[2]) {
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The A fragment of rows 0..15, columns 0..7 of a row-major float tile `x`
// (row stride ld floats), split.
__device__ __forceinline__ void frag_a(Tf32x2 (&a)[4], const float* x,
                                       int ld, int lane) {
  const int g = lane / 4, t = lane % 4;
  a[0] = split_tf32(x[g * ld + t]);
  a[1] = split_tf32(x[(g + 8) * ld + t]);
  a[2] = split_tf32(x[g * ld + t + 4]);
  a[3] = split_tf32(x[(g + 8) * ld + t + 4]);
}

// The B fragment of a product A X^T: X rows 0..7 are B's columns n and X
// columns 0..7 its k (x row-major, row stride ld floats), split.
__device__ __forceinline__ void frag_bt(Tf32x2 (&b)[2], const float* x,
                                        int ld, int lane) {
  const int g = lane / 4, t = lane % 4;
  b[0] = split_tf32(x[g * ld + t]);
  b[1] = split_tf32(x[g * ld + t + 4]);
}

// The B fragment of a product P X whose A operand is an accumulator (see
// frag_acc): X rows 0..7 are k in the permuted order (row 2t where B's k
// is t, row 2t + 1 where it is t + 4), columns 0..7 are n (x row-major,
// row stride ld floats), split. A sum does not care about the order of
// its terms.
__device__ __forceinline__ void frag_bx(Tf32x2 (&b)[2], const float* x,
                                        int ld, int lane) {
  const int g = lane / 4, t = lane % 4;
  b[0] = split_tf32(x[2 * t * ld + g]);
  b[1] = split_tf32(x[(2 * t + 1) * ld + g]);
}

// An accumulator tile [16 x 8] as the A fragment of the next product's
// k-step over its 8 columns, k permuted as frag_bx reads B: column 2t
// stands where A's k is t and 2t + 1 where it is t + 4. No shuffles.
__device__ __forceinline__ void frag_acc(Tf32x2 (&a)[4], const float (&c)[4]) {
  a[0] = split_tf32(c[0]);
  a[1] = split_tf32(c[2]);
  a[2] = split_tf32(c[1]);
  a[3] = split_tf32(c[3]);
}

__device__ __forceinline__ void mma_mode(float (&d)[4], const Tf32x2 (&a)[4],
                                         const Tf32x2 (&b)[2], int mode) {
  if (mode == 0) {
    mma_3xtf32(d, a, b);
  } else {
    mma_1xtf32(d, a, b);
  }
}

// c[16 x 64] = A[16 x D] B[64 x D]^T for tile blockIdx.x (S = Q K^T, S^T =
// K Q^T): a chain of D / 8 k-steps per 8-column n-tile.
template <int D>
__global__ void chain_abt(const float* a, const float* b, float* c,
                          int mode) {
  const int lane = threadIdx.x;
  a += int64_t(blockIdx.x) * 16 * D;
  b += int64_t(blockIdx.x) * 64 * D;
  c += int64_t(blockIdx.x) * 16 * 64;
  float acc[8][4] = {};
  for (int ks = 0; ks < D / 8; ++ks) {
    Tf32x2 af[4];
    frag_a(af, a + 8 * ks, D, lane);
    for (int j = 0; j < 8; ++j) {
      Tf32x2 bf[2];
      frag_bt(bf, b + 8 * j * D + 8 * ks, D, lane);
      mma_mode(acc[j], af, bf, mode);
    }
  }
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < 8; ++j) {
    c[g * 64 + 8 * j + 2 * t] = acc[j][0];
    c[g * 64 + 8 * j + 2 * t + 1] = acc[j][1];
    c[(g + 8) * 64 + 8 * j + 2 * t] = acc[j][2];
    c[(g + 8) * 64 + 8 * j + 2 * t + 1] = acc[j][3];
  }
}

// c[16 x D] = P[16 x 64] X[64 x D] for tile blockIdx.x (dV += P^T dO, dK
// += dS^T Q, dQ += dS K): P is read into the accumulator layout and used
// as the A operand with the permuted k, X through frag_bx; a chain of 8
// k-steps per n-tile.
template <int D>
__global__ void chain_ax(const float* p, const float* x, float* c,
                         int mode) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  p += int64_t(blockIdx.x) * 16 * 64;
  x += int64_t(blockIdx.x) * 64 * D;
  c += int64_t(blockIdx.x) * 16 * D;
  float acc[D / 8][4] = {};
  for (int j = 0; j < 8; ++j) {
    const float pc[4] = {p[g * 64 + 8 * j + 2 * t],
                         p[g * 64 + 8 * j + 2 * t + 1],
                         p[(g + 8) * 64 + 8 * j + 2 * t],
                         p[(g + 8) * 64 + 8 * j + 2 * t + 1]};
    Tf32x2 af[4];
    frag_acc(af, pc);
    for (int n = 0; n < D / 8; ++n) {
      Tf32x2 bf[2];
      frag_bx(bf, x + 8 * j * D + 8 * n, D, lane);
      mma_mode(acc[n], af, bf, mode);
    }
  }
  for (int n = 0; n < D / 8; ++n) {
    c[g * D + 8 * n + 2 * t] = acc[n][0];
    c[g * D + 8 * n + 2 * t + 1] = acc[n][1];
    c[(g + 8) * D + 8 * n + 2 * t] = acc[n][2];
    c[(g + 8) * D + 8 * n + 2 * t + 1] = acc[n][3];
  }
}

}  // namespace

extern "C" {

// `tiles` independent tiles; returns the launch's cudaError_t after a
// synchronize.
int tf32x3_abt(const float* a, const float* b, float* c, int tiles, int d,
               int mode) {
  if (d == 64) {
    chain_abt<64><<<tiles, 32>>>(a, b, c, mode);
  } else if (d == 128) {
    chain_abt<128><<<tiles, 32>>>(a, b, c, mode);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}

int tf32x3_ax(const float* p, const float* x, float* c, int tiles, int d,
              int mode) {
  if (d == 64) {
    chain_ax<64><<<tiles, 32>>>(p, x, c, mode);
  } else if (d == 128) {
    chain_ax<128><<<tiles, 32>>>(p, x, c, mode);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}

}  // extern "C"
