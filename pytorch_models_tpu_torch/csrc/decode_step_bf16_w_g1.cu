// The fused decode step in bf16, weights in the compute dtype, one row group (B <= 8): one instantiation
// per source, so that the eight compile in parallel (decode_step.cuh).
#include "decode_step_kernel.cuh"

namespace pmt_k7 {

template int plan<__nv_bfloat16, __nv_bfloat16, 1>(const Args& a, Plan& p);
template int launch_groups<__nv_bfloat16, __nv_bfloat16, 1>(const Args& a);

}  // namespace pmt_k7
