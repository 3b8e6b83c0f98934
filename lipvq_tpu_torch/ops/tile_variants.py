"""Time the lookup's tile configurations on the card, outside PyTorch.

    python3 -m lipvq_tpu_torch.ops.tile_variants [--out FILE]

Builds one standalone CUDA program from ``csrc/vq_nearest_tile.cuh`` with
nvcc: for each tile configuration (warps, outputs per thread, stages, BK)
it runs the tile kernel (and the split reduction) at the served, train and
corpus shapes on seeded uniform data, checks that every configuration gives
the ids of the first, and prints the median of CUDA-event times. A second
build of the header with every FMA of the tile loop doubled (the "2x FMA"
probe; its ids are wrong and not checked) shows how far the FMA issue alone
bounds a configuration. It needs nvcc and one CUDA device; the code splits
follow ``plan_lookup``'s rule (about two CTAs per SM).
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time
from pathlib import Path

from lipvq_tpu_torch.ops import _build

SHAPES = {"served": (160, 1024, 791), "train": (500, 1024, 791),
          "corpus": (1 << 20, 1024, 208)}
# (label, TileCfg arguments, shapes); the first of each shape is the id reference
VARIANTS = [
    ("SMALL 32x32 4x4 st4 bk64", "2, 1, 4, 4, 4, 64", ("served", "train")),
    ("MEDIUM 32x64 4x4 st4 bk64", "2, 2, 4, 4, 4, 64", ("served", "train")),
    ("16x64 4x4 st4 bk16", "1, 2, 4, 4, 4, 16", ("served", "train")),
    ("32x64 4x4 st8 bk16", "2, 2, 4, 4, 8, 16", ("served", "train")),
    ("32x64 4x4 st6 bk32", "2, 2, 4, 4, 6, 32", ("served", "train")),
    ("LARGE 128x256 8x16 st3 bk16", "4, 2, 8, 16, 3", ("corpus",)),
    ("128x128 8x8 st3 bk16 2 CTAs/SM", "4, 2, 8, 8, 3, 16, 2", ("corpus",)),
    ("128x128 8x8 st3 bk16", "4, 2, 8, 8, 3, 16, 1", ("corpus",)),
    ("128x128 8x8 st4 bk16 2 CTAs/SM", "4, 2, 8, 8, 4, 16, 2", ("corpus",)),
    ("128x128 8x16 st3 bk16 2 CTAs/SM", "4, 1, 8, 16, 3, 16, 2", ("corpus",)),
]
PROBED = ("LARGE 128x256 8x16 st3 bk16", "128x128 8x8 st3 bk16 2 CTAs/SM")
FMA_LINE = "acc[i][j] = fmaf(a[i], b[j], acc[i][j]);"

MAIN = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "vq_nearest_tile.cuh"
using namespace vq;

static float *dz, *dc, *dcn, *dpd;
static int *dids, *dpi, *dref;
static int sms;

template <class C>
void run(const char* label, const char* shape, int B, int N, int D, int reps, bool ref) {
  int row_tiles = (B + C::BM - 1) / C::BM, code_tiles = (N + C::BN - 1) / C::BN;
  int splits = std::min(code_tiles, std::max(1, (2 * sms + row_tiles - 1) / row_tiles));
  int tps = (code_tiles + splits - 1) / splits;
  splits = (code_tiles + tps - 1) / tps;
  auto go = [&]() {
    cudaError_t e = launch_tile<C>(dz, dc, dcn, dids, dpd, dpi, B, N, D, tps * C::BN, splits, 0);
    if (e != cudaSuccess) { printf("%s: %s\n", label, cudaGetErrorString(e)); exit(1); }
    if (splits > 1) reduce_splits_kernel<<<(B + 255) / 256, 256>>>(dpd, dpi, B, splits, dids);
  };
  go();
  if (cudaDeviceSynchronize() != cudaSuccess) { printf("%s: fault\n", label); exit(1); }
  if (ref) cudaMemcpy(dref, dids, B * 4, cudaMemcpyDeviceToDevice);
  std::vector<int> a(B), b(B);
  cudaMemcpy(a.data(), dids, B * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(b.data(), dref, B * 4, cudaMemcpyDeviceToHost);
  int diff = 0;
  for (int i = 0; i < B; ++i) diff += a[i] != b[i];
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> t;
  for (int r = 0; r < reps; ++r) {
    cudaEventRecord(e0); go(); cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1); t.push_back(ms);
  }
  std::sort(t.begin(), t.end());
  cudaFuncAttributes at;
  cudaFuncGetAttributes(&at, nearest_tile_kernel<C>);
  printf("%-34s %-7s %7dx%dx%d  ctas %5d  regs %3d  smem %6zu  median %.4f ms  ids differing %d\n",
         label, shape, B, N, D, row_tiles * splits, at.numRegs, C::SMEM, t[t.size() / 2], diff);
}

void setup(int B, int N, int D) {
  std::vector<float> hz((size_t)B * D), hc((size_t)N * D);
  unsigned x = 12345;
  auto rnd = [&]() { x = x * 1664525u + 1013904223u; return (x >> 8) * (2.0f / 16777216.0f) - 1.f; };
  for (auto& v : hz) v = rnd();
  for (auto& v : hc) v = rnd();
  cudaMalloc(&dz, hz.size() * 4); cudaMalloc(&dc, hc.size() * 4);
  cudaMemcpy(dz, hz.data(), hz.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dc, hc.data(), hc.size() * 4, cudaMemcpyHostToDevice);
  cudaMalloc(&dcn, N * 4); cudaMalloc(&dids, B * 4); cudaMalloc(&dref, B * 4);
  cudaMalloc(&dpd, (size_t)64 * B * 4); cudaMalloc(&dpi, (size_t)64 * B * 4);
  code_norms_kernel<<<(N + 7) / 8, 256>>>(dc, N, D, dcn);
}

void teardown() {
  cudaFree(dz); cudaFree(dc); cudaFree(dcn); cudaFree(dids); cudaFree(dref);
  cudaFree(dpd); cudaFree(dpi);
}

int main() {
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
BODY
  return 0;
}
"""


def program(probe: bool) -> str:
    lines = []
    for shape, (b, n, d) in SHAPES.items():
        runs = [(label, args) for label, args, shapes in VARIANTS if shape in shapes
                and (not probe or label in PROBED)]
        if not runs:
            continue
        lines.append(f"  setup({b}, {n}, {d});")
        reps = 5 if shape == "corpus" else 50
        for k, (label, args) in enumerate(runs):
            tag = label + (" (2x FMA)" if probe else "")
            lines.append(f'  run<TileCfg<{args}>>("{tag}", "{shape}", {b}, {n}, {d}, {reps}, '
                         f'{"true" if k == 0 else "false"});')
        lines.append("  teardown();")
    return MAIN.replace("BODY", "\n".join(lines))


def build_and_run(workdir: Path, probe: bool) -> str:
    header = (_build.CSRC_DIR / "vq_nearest_tile.cuh").read_text()
    if probe:
        assert FMA_LINE in header
        header = header.replace(FMA_LINE, "acc[i][j] = fmaf(a[i], b[j], fmaf(a[i], b[j], "
                                          "acc[i][j]));")
    src = workdir / ("probe" if probe else "plain")
    src.mkdir()
    (src / "vq_nearest_tile.cuh").write_text(header)
    (src / "main.cu").write_text(program(probe))
    exe = src / "tile_variants"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", str(exe), str(src / "main.cu")], check=True)
    return subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, help="also write the table here")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        text = build_and_run(Path(tmp), False) + build_and_run(Path(tmp), True)
    text += f"card: {card}; {time.perf_counter() - t0:.1f} s with the builds\n"
    print(text, end="")
    if args.out:
        args.out.write_text(text)


if __name__ == "__main__":
    main()
