// The fused decode step in fp32, weights in the compute dtype, up to four row groups (B <= 32): one instantiation
// per source, so that the eight compile in parallel (decode_step.cuh).
#include "decode_step_kernel.cuh"

namespace pmt_k7 {

template int plan<float, float, 4>(const Args& a, Plan& p);
template int launch_groups<float, float, 4>(const Args& a);

}  // namespace pmt_k7
