// The BCJR meet instance at the CTA widths the port does not ship, for
// benches/torch_bcjr_sweep.py. The port's csrc/bcjr.cu launches 16 columns a
// CTA (8 for long spans); this file compiles that source with one more C
// entry, bcjr_rsc8_sweep_launch, which takes any of 8, 16, 24 and 32 columns
// a CTA and is otherwise bcjr_rsc8_launch.
//
// Build: nvcc <the port's flags> -I aether_primitives_tpu_torch/csrc
//        -o <lib>.so benches/torch_bcjr_sweep.cu

#include "bcjr.cu"

extern "C" int bcjr_rsc8_sweep_launch(const void* ls, const void* lp, void* llr, int lw,
                                      long long ncols, int cols, int vec, const float* cls,
                                      int device, void* stream) {
  if (lw < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(ls);
  const float* b = static_cast<const float*>(lp);
  float* o = static_cast<float*>(llr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (cols) {
      case 8: return launch_meet<8>(a, b, o, lw, ncols, vec, cls, s);
      case 16: return launch_meet<16>(a, b, o, lw, ncols, vec, cls, s);
      case 24: return launch_meet<24>(a, b, o, lw, ncols, vec, cls, s);
      case 32: return launch_meet<32>(a, b, o, lw, ncols, vec, cls, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
