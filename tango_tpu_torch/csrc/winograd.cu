// Winograd F(2x2, 3x3) convolution, 3x3 stride-1 SAME: the C entry points
// tt_wino_conv3x3 and tt_wino_weight. Both types run the tensor-core bodies
// of winograd_tc.cu (bf16 wgmma; f32 3xTF32 wgmma), which replace
// tango_tpu/ops/winograd.py: _wino_kernel (through winograd_conv3x3_pallas);
// the entry point reports the launch by returning kTcLaunched. There is no
// CUDA-core body: every type the entry point takes has a tensor-core one.

#include "common.cuh"

namespace tt {

cudaError_t wino_conv3x3_tc(const void* x, const void* u, void* y, void* v, void* part,
                            int splits, int B, int Ci, int H, int W, int Co, int dtype,
                            cudaStream_t st);
cudaError_t wino_weight_tc(const void* w, void* u, int Co, int Ci, int dtype, cudaStream_t st);

// wino_tc_body(dtype): the rule by which tt_wino_conv3x3 takes the
// tensor-core body: f32 and bf16, every type it takes (wino_tc_body in
// ops/winograd.py is the same rule; its counter reads the kTcLaunched report).
bool wino_tc_body(int dtype) { return dtype == kF32 || dtype == kBF16; }

}  // namespace tt

extern "C" {

// U (16, Co, Cs) in dtype (f32 or bf16) from an f32 OIHW weight (Co, Ci, 3,
// 3), Cs = Ci rounded up to 16.
int tt_wino_weight(const void* w, void* u, int Co, int Ci, int dtype, void* stream) {
  if (Co <= 0 || Ci <= 0) return (int)cudaErrorInvalidValue;
  return (int)tt::wino_weight_tc(w, u, Co, Ci, dtype, static_cast<cudaStream_t>(stream));
}

// v and part are the body's scratch: V (16, B*(H/2)*(W/2), Ci rounded up to
// 16) in dtype and, for splits > 1, the partial sums (splits, B, Co, H, W)
// f32 (null for one split).
int tt_wino_conv3x3(const void* x, const void* u, void* y, void* v, void* part, int splits,
                    int B, int Ci, int H, int W, int Co, int dtype, void* stream) {
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || v == nullptr ||
      !tt::wino_tc_body(dtype))
    return (int)cudaErrorInvalidValue;
  return tt::tc_result(tt::wino_conv3x3_tc(x, u, y, v, part, splits, B, Ci, H, W, Co, dtype,
                                           static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
