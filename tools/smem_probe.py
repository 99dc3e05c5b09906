"""Shared-memory cost of a warp's 128-bit load on the card, by address
pattern: SM clocks per warp-wide ``ld.shared.v4`` at full throughput.

    python3 tools/smem_probe.py

Builds a small CUDA program with ``nvcc`` (``sm_90a``) into
``build/smem_probe/`` and runs one block of 8 warps an SM, each warp
issuing volatile 128-bit shared loads in a loop, for each pattern of
addresses a quarter-warp reads.  The f32 attention tiles of
``src/repro_torch/kernels/csrc/flash_f32_tile.cuh`` are laid out on what
it shows.  Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (name, float4 index a lane reads, from its lane id)
PATTERNS = [
    ("one address a warp", "0"),
    ("one address a quarter-warp", "(lane / 8) * 33"),
    ("two addresses a quarter-warp", "(lane & 1) + 2 * (lane / 8)"),
    ("four addresses a quarter-warp", "(lane & 3) + 4 * (lane / 8)"),
    ("eight addresses a quarter-warp, the same in each", "lane % 8"),
    ("32 distinct addresses", "lane"),
]

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256, 1)
probe(float* out, int mode, int iters, long long* cyc) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += 256)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int idx = 0;
  switch (mode) {
%(cases)s
  }
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(buf)) + idx * 16;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%%0,%%1,%%2,%%3}, [%%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                   : "r"(base + u * 1024));
      acc[u] += x + w;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float t = 0.f;
  for (int u = 0; u < 8; ++u) t += acc[u];
  out[blockIdx.x * 256 + threadIdx.x] = t;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* cyc;
  cudaMalloc(&out, sms * 256 * 4);
  cudaMalloc(&cyc, sms * 8);
  const int iters = 4096;
  for (int m = 0; m < %(n)d; ++m) {
    probe<<<sms, 256>>>(out, m, iters, cyc);
    long long c = 0;
    if (cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost) != cudaSuccess)
      return 1;
    printf("%%d %%.3f\n", m, (double)c / (iters * 8.0 * 8));
  }
  return 0;
}
"""


def main() -> int:
    from repro_torch.kernels import build
    out = ROOT / "build" / "smem_probe"
    out.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(f"    case {i}: idx = {expr}; break;"
                      for i, (_, expr) in enumerate(PATTERNS))
    (out / "probe.cu").write_text(SOURCE % {"cases": cases,
                                            "n": len(PATTERNS)})
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(out / "probe"), str(out / "probe.cu")],
                   check=True)
    res = subprocess.run([str(out / "probe")], check=True,
                         capture_output=True, text=True).stdout.split("\n")
    for line in res:
        if line.strip():
            m, clocks = line.split()
            print(f"{PATTERNS[int(m)][0]}: {clocks} SM clocks a warp load")
    return 0


if __name__ == "__main__":
    sys.exit(main())
