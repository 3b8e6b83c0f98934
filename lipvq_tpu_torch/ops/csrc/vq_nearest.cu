// K1: fused nearest-code lookup for the LipVQ-VAE quantizer.
//
// Replaces the Pallas kernel lipvq_tpu/ops/vq_lookup.py::_make_vq_kernel
// (launched by vq_nearest_pallas, precision="highest"). The lookup itself,
// its numerics, its bound and its design are in vq_nearest_tile.cuh, which
// K2 (vq_stats.cu) shares; this file is K1's plain C entry point.

#include "vq_nearest_tile.cuh"

extern "C" {

// z [B, D], c [N, D], cn [N] fp32 and ids [B] int32, all contiguous on the
// current device. codes_per_split is a multiple of BN; with splits > 1,
// part_d [splits, B] fp32 and part_i [splits, B] int32 are scratch.
// Returns the cudaError_t of the launches (0 on success).
int vq_nearest_launch(const float* z, const float* c, const float* cn, int* ids,
                      float* part_d, int* part_i, int B, int N, int D,
                      int codes_per_split, int splits, void* stream) {
  return static_cast<int>(vq::launch_nearest(z, c, cn, ids, part_d, part_i, B, N,
                                             D, codes_per_split, splits,
                                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
