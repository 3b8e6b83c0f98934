// K1: fused nearest-code lookup for the LipVQ-VAE quantizer.
//
// Replaces the Pallas kernel lipvq_tpu/ops/vq_lookup.py::_make_vq_kernel
// (launched by vq_nearest_pallas, precision="highest"). The lookup itself,
// its numerics, its bound and its design are in vq_nearest_tile.cuh, which
// K2 (vq_stats.cu) shares; this file is K1's plain C entry point.

#include "vq_nearest_tile.cuh"

extern "C" {

// 4-byte elements of scratch that vq_nearest_launch needs.
size_t vq_nearest_scratch_elems(int B, int N, int splits) {
  return vq::lookup_scratch_elems(B, N, splits);
}

// z [B, D], c [N, D] fp32, ids [B] int32 and scratch (see above), all
// contiguous on the current device; config and codes_per_split as in
// vq::launch_nearest. Enqueues everything on `stream`, allocates nothing,
// and returns the first cudaError_t (0 on success).
int vq_nearest_launch(const float* z, const float* c, int* ids, void* scratch, int B, int N,
                      int D, int config, int codes_per_split, int splits, void* stream) {
  return static_cast<int>(vq::launch_nearest(z, c, ids, scratch, B, N, D, config,
                                             codes_per_split, splits,
                                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
