// The fused decode step in fp32, int8 weights, up to four row groups (B <= 32): one instantiation
// per source, so that the eight compile in parallel (decode_step.cuh).
#include "decode_step_kernel.cuh"

namespace pmt_k7 {

template int plan<float, int8_t, 4>(const Args& a, Plan& p);
template int launch_groups<float, int8_t, 4>(const Args& a);

}  // namespace pmt_k7
