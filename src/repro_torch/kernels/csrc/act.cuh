// Element-wise activations shared by the flex_gemm epilogue and the SFU
// activation kernel.  Codes match ACT_CODE in repro_torch/kernels/_build.py.
// Numerics follow NonLinear.apply (repro_torch/core/graph.py): GELU is the
// tanh form, SiLU is x / (1 + exp(-x)).  expf/tanhf are the accurate
// library functions (no --use_fast_math), so results stay within a few
// ulp of the fp32 reference.
#pragma once

enum Act : int { ACT_NONE = 0, ACT_GELU = 1, ACT_RELU = 2, ACT_RELU2 = 3,
                 ACT_SILU = 4 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * x *
             (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case ACT_RELU:
      return fmaxf(x, 0.0f);
    case ACT_RELU2: {
      const float r = fmaxf(x, 0.0f);
      return r * r;
    }
    case ACT_SILU:
      return x / (1.0f + expf(-x));
    default:
      return x;
  }
}
