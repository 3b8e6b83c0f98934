// K1: fused nearest-code lookup for the LipVQ-VAE quantizer.
//
// Replaces the Pallas kernel lipvq_tpu/ops/vq_lookup.py::_make_vq_kernel
// (launched by vq_nearest_pallas, precision="highest"). The lookup itself,
// its numerics, its bound and its design are in vq_nearest_tile.cuh, which
// K2 (vq_stats.cu) shares; config 3 is the tensor-core path of
// vq_nearest_tc.cuh, whose ids are the tile kernel's bit for bit. This file
// is K1's plain C entry point.

#include "vq_nearest_tc.cuh"

extern "C" {

// The tensor-core path's tile (rows, codes), its largest D and N, which the
// wrapper's plan must agree with.
int vq_tc_tile_rows() { return vqtc::BM; }
int vq_tc_tile_codes() { return vqtc::BN; }
int vq_tc_max_d() { return vqtc::MAX_D; }
int vq_tc_max_n() { return vqtc::MAX_N; }

// 4-byte elements of scratch that vq_nearest_launch needs for a plan.
size_t vq_nearest_scratch_elems(int B, int N, int D, int config, int splits) {
  return config == 3 ? vqtc::scratch_elems(B, N, D) : vq::lookup_scratch_elems(B, N, splits);
}

// z [B, D], c [N, D] fp32, ids [B] int32 and scratch (see above), all
// contiguous on the current device; config and codes_per_split as in
// vq::launch_nearest, or config 3 (vqtc::launch: one code split), which adds
// its re-scored rows to counters [2] int64 on the device. Enqueues everything
// on `stream`, allocates nothing, and returns the first cudaError_t (0 on
// success).
int vq_nearest_launch(const float* z, const float* c, int* ids, void* scratch,
                      unsigned long long* counters, int B, int N, int D, int config,
                      int codes_per_split, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (config == 3)
    return static_cast<int>(splits == 1 ? vqtc::launch(z, c, ids, scratch, counters, B, N, D, s)
                                        : cudaErrorInvalidValue);
  return static_cast<int>(
      vq::launch_nearest(z, c, ids, scratch, B, N, D, config, codes_per_split, splits, s));
}

}  // extern "C"
