// What a hand-off through distributed shared memory costs on the card: the
// measurement behind the D-slice K1 kernels' design (flash_attn_fwd.cu,
// PERF.md). Clusters of n blocks (one block an SM); every round each block
// sends `bytes` to the next rank of a ring (modes 0, 1) or the last rank
// sends to every rank, itself included (modes 2, 3), into double-buffered
// slots under mbarriers, as the kernels hand partial sums and p on: the
// receiver frees a slot by arriving on the sender's mbarrier.
//   mode 0: st.async, 16 bytes a thread;
//   mode 1: the threads stage the bytes in their own shared memory, then
//           one cp.async.bulk copies them into the peer's;
//   modes 2, 3: the same from the last rank to every rank;
//   mode 4: mode 0 with the receiver's arrival at cluster scope
//           (mbarrier.arrive.release.cluster), which also waits for the
//           arriving thread's own stores into peers to land.
// Prints cycles a round (clock64, the mean over blocks) and bytes a clock
// out of a sending SM, for one cluster alone and for the card full of
// clusters. Built and run by tools/dsmem_bench.py.
#include <cstdio>
#include <cstdlib>
#include "hopper.cuh"

__global__ void dsm_bench(int mode, int rounds, int bytes, int n,
                          unsigned long long* out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* stage = sm;           // [2][32 KB]: a round's bytes (mode 1, 3)
  uint8_t* slot = sm + 65536;    // [2][32 KB]: what lands from the peer
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + 131072);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r = cluster_rank();
  const bool bcast = mode == 2 || mode == 3;
  const int nvec = bytes / 16 / 256;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, bcast ? 8 * n : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int next = (r + 1) % n, prev = (r + n - 1) % n;
  const int src_rank = bcast ? n - 1 : prev;
  float sink = 0.f;
  const long long t0 = clock64();
  for (int i = 0; i < rounds; ++i) {
    const int s = i % 2, use = i / 2;
    const bool sender = !bcast || r == n - 1;
    if (sender) {
      if (use > 0) mbar_wait(empty + s, (use - 1) % 2);
      const int n_dst = bcast ? n : 1;
      if (mode == 0 || mode == 2 || mode == 4) {
        for (int d = 0; d < n_dst; ++d) {
          const int dr = bcast ? d : next;
          const uint32_t dst = peer_addr(slot + s * 32768 + tid * 16, dr);
          const uint32_t bar = peer_addr(full + s, dr);
          for (int v = 0; v < nvec; ++v)
            st_async16(dst + v * 4096, bar,
                       make_float4(float(i), float(v), 1.f, 2.f));
        }
      } else {
        // Stage s is free: round i - 2's copy out of it landed (empty).
        uint8_t* stg = stage + s * 32768;
        for (int v = 0; v < nvec; ++v)
          reinterpret_cast<float4*>(stg)[v * 256 + tid] =
              make_float4(float(i), float(v), 1.f, 2.f);
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          for (int d = 0; d < n_dst; ++d) {
            const int dr = bcast ? d : next;
            bulk_to_peer(peer_addr(slot + s * 32768, dr), stg, bytes,
                         peer_addr(full + s, dr));
          }
        }
      }
    }
    if (tid == 0) mbar_expect(full + s, bytes);
    mbar_wait_cluster(full + s, use % 2);
    for (int v = 0; v < nvec; ++v)
      sink += reinterpret_cast<const float4*>(slot + s * 32768)[v * 256 + tid].y;
    __syncwarp();
    if (lane == 0 && mode == 4)
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
          :: "r"(peer_addr(empty + s, src_rank)) : "memory");
    else if (lane == 0)
      mbar_arrive_peer(peer_addr(empty + s, src_rank));
  }
  const long long t1 = clock64();
  cluster_sync();
  if (tid == 0) out[blockIdx.x] = (unsigned long long)(t1 - t0);
  if (sink == -1.f) out[0] = 0;
}

int main() {
  const int smem = 136 * 1024;   // one block an SM
  cudaFuncSetAttribute(dsm_bench, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(dsm_bench,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  unsigned long long* out;
  cudaMalloc(&out, 8 * 4096);
  unsigned long long host[4096];
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[] = {"st.async ring", "bulk ring", "st.async bcast",
                         "bulk bcast", "ring, cluster"};
  for (int mode = 0; mode < 5; ++mode)
    for (int n : {2, 3, 4, 8})
      for (int bytes : {32768, 8192}) {
        for (int grid_clusters : {1, 132 / n}) {
          const int rounds = 400;
          cudaLaunchConfig_t cfg = {};
          cfg.gridDim = dim3(n * grid_clusters);
          cfg.blockDim = dim3(256);
          cfg.dynamicSmemBytes = smem;
          cudaLaunchAttribute attr[1];
          attr[0].id = cudaLaunchAttributeClusterDimension;
          attr[0].val.clusterDim.x = n;
          attr[0].val.clusterDim.y = 1;
          attr[0].val.clusterDim.z = 1;
          cfg.attrs = attr;
          cfg.numAttrs = 1;
          cudaLaunchKernelEx(&cfg, dsm_bench, mode, 20, bytes, n, out);
          cudaEventRecord(e0);
          cudaLaunchKernelEx(&cfg, dsm_bench, mode, rounds, bytes, n, out);
          cudaEventRecord(e1);
          cudaError_t err = cudaDeviceSynchronize();
          if (err != cudaSuccess) {
            printf("mode %d n %d: %s\n", mode, n, cudaGetErrorString(err));
            return 1;
          }
          float ms;
          cudaEventElapsedTime(&ms, e0, e1);
          cudaMemcpy(host, out, 8 * n * grid_clusters, cudaMemcpyDeviceToHost);
          double cyc = 0;
          for (int i = 0; i < n * grid_clusters; ++i) cyc += host[i];
          cyc /= n * grid_clusters;
          // bytes sent per sending SM and per round
          const double per_round_us = ms * 1e3 / rounds;
          const int n_dst = mode == 2 || mode == 3 ? n : 1;
          printf("%-15s n %d bytes %5d clusters %3d: %.3f us/round, "
                 "%.0f cycles/round, %.1f GB/s out of a sending SM, "
                 "%.1f B/clk\n",
                 names[mode], n, bytes, grid_clusters, per_round_us,
                 cyc / rounds, double(bytes) * n_dst / per_round_us / 1e3,
                 double(bytes) * n_dst / (cyc / rounds));
        }
      }
  return 0;
}
