// The fused decode step's C interface (ops/decode_step.py): each call goes to
// the instantiation of its compute dtype, weight element and row groups,
// compiled in its own source (decode_step.cuh).
#include <cstdint>

#include "common.cuh"
#include "decode_step.cuh"

namespace {

using pmt_k7::Args;
using pmt_k7::GR;
using pmt_k7::MB;
using pmt_k7::N_MATS;
using pmt_k7::Plan;
using pmt_k7::launch_groups;
using pmt_k7::plan;

static_assert(MB / GR == 4, "decode_step_*_g4.cu instantiate four row groups");

// the one-group instantiation up to GR rows, the multi-group one above
template <typename T, typename W>
int launch(const Args& a) {
    return a.b > GR ? launch_groups<T, W, MB / GR>(a) : launch_groups<T, W, 1>(a);
}

template <typename T, typename W>
int plan_rows(const Args& a, Plan& p) {
    return a.b > GR ? plan<T, W, MB / GR>(a, p) : plan<T, W, 1>(a, p);
}

template <typename T>
int plan_for(const Args& a, Plan& p) {
    p = Plan{};
    return a.wt_int8 ? plan_rows<T, int8_t>(a, p) : plan_rows<T, T>(a, p);
}

}  // namespace

// Workspace bytes the step needs (<= 0: a CUDA error code, negated), and the
// grid it will run as (written to grid_out).
extern "C" int pmt_decode_step_workspace(const void* args, void* grid_out) {
    const Args& a = *static_cast<const Args*>(args);
    Plan p;
    const int rc = a.dtype == pmt::DT_F32 ? plan_for<float>(a, p) : plan_for<__nv_bfloat16>(a, p);
    if (rc != 0) return -rc;
    *static_cast<int*>(grid_out) = p.grid;
    return static_cast<int>(p.ws_bytes);
}

// The launch plan (the tests and chip_smoke.py read it): out[0] the grid, [1] the columns per matvec pass,
// [2] the ring's bytes, then for each matrix shape (qkv, o and o_c, q_c, fc1, fc2) its K rows per ring slot,
// slots and the most steps a block takes (a share streams, with refills, where steps > slots). Returns a CUDA
// error code.
extern "C" int pmt_decode_step_plan(const void* args, void* out) {
    const Args& a = *static_cast<const Args*>(args);
    Plan p;
    const int rc = a.dtype == pmt::DT_F32 ? plan_for<float>(a, p) : plan_for<__nv_bfloat16>(a, p);
    if (rc != 0) return rc;
    int* o = static_cast<int*>(out);
    o[0] = p.grid, o[1] = p.pass_cols, o[2] = static_cast<int>(p.ring_bytes);
    for (int i = 0; i < N_MATS; ++i) o[3 + 3 * i] = p.m[i].kc, o[4 + 3 * i] = p.m[i].slots, o[5 + 3 * i] = p.m[i].steps;
    return 0;
}

extern "C" int pmt_decode_step(const void* args) {
    const Args& a = *static_cast<const Args*>(args);
    if (a.dtype == pmt::DT_F32) return a.wt_int8 ? launch<float, int8_t>(a) : launch<float, float>(a);
    return a.wt_int8 ? launch<__nv_bfloat16, int8_t>(a) : launch<__nv_bfloat16, __nv_bfloat16>(a);
}
