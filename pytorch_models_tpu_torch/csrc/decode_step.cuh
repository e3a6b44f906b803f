// Fused greedy decode step: the whole decoder layer stack for one token
// [+ a cross-attention phase] [+ the final norm and the greedy head] in ONE
// kernel launch.
//
// Replaces pytorch_models_tpu/ops/decode_step.py `fused_decode_step` and
// `fused_cross_decode_step` (both reaching the Pallas call of `_call_fused`)
// in their base variant (pre-norm LayerNorm, biased projections, the MLP's
// activation of the JAX kernel's KERNEL_ACT_FNS: GELU exact or tanh, relu,
// silu or identity, `act_fn`), the cross-attention phase over (L, B, Lx,
// H*D) caches with per-row lengths, T5's variant (`norm="rms"`: RMSNorm without mean
// subtraction; `gated`: GEGLU over fc1 = [wi_0 | wi_1]; `sbias`: a key-major
// (Lp, H) fp32 rel-pos bias added to the self-attention scores), and the
// greedy head over a (V, d) table (tied, or an untied classifier the caller
// transposed once). Its int8 serving variants:
//   - w8a16 (`wt_int8`): int8 weight matrices with per-output-column fp32
//     scales; an int8 tile widens exactly to fp32, the sum is fp32, then
//     `acc * s_col + bias`, rounded once (the JAX kernel's `stream` and its
//     scale lines);
//   - w8a8 (`a8`, int8 weights): each phase quantizes its input per row
//     (absmax over the whole row: d for QKV, H*D for O, dff for fc2), sums
//     int8 x int8 in int32 (exact), then `(f32(acc) * r_scale) * s_col +
//     bias`; every block reads the whole input row already, so each forms
//     the row absmax itself, with no extra barrier;
//   - a8 head (`head_a8`): a per-vocab-row int8 table with fp32 row scales;
//     the normed hidden state quantized per row (its scale, constant in a
//     row, is never applied); score `f32(dot_i32) * emb_s[v]`, not rounded;
//   - int8 self-KV (`kv_int8`) and cross-KV (`kvx_int8`): attention over
//     int8 caches with per-key fp32 scales, csrc/int8_attn.cuh's arithmetic
//     (shared with the per-op kernel csrc/int8_kv.cu), one unit per (row,
//     head) walking its 128-key blocks in order (the probabilities are
//     quantized per block against the running max, so the keys are not split
//     across blocks). Self: the QKV phase writes this step's K/V to scratch;
//     after the barrier, each unit sees the whole row, forms the row absmax,
//     scores the current key from the quantized K (and the unquantized V),
//     and writes the quantized K/V head slice and (head 0) the row scales at
//     `pos`. T5's self bias is added after dequantization, at cached keys
//     and at `pos`. Cross: keys [0, len_b), no current position, an empty row
//     gives zeros;
//   - the embed phase (`embed`): layer 0 reads `tok_emb[id] + pos_emb[p]`
//     (fp32 sum, one rounding; ids clamped to the tables) instead of `x`.
// The JAX kernel's `eager` flag only orders the TPU's DMA requests; its
// counterpart here is the weight staging below.
//
// What bounds it on the H100: bytes, in principle. At any batch it serves
// (1-32) a step reads every layer weight once (GPT-2 small bf16: 170 MB + a
// 77 MB head) and does 2*B FLOPs per weight element, below the ~295
// FLOP/byte ridge;
// the self-KV prefix and Whisper's 1,500-key cross cache (197 MB bf16 at
// B=8) are read once too. In practice latency: a step is 62-98 phases, each
// ended by a grid barrier, and a phase costs its slowest block's chain of
// round trips. The eager per-op step it replaces is bound by the host
// instead: ~600 launches per step.
//
// The design: one persistent kernel, launched cooperatively with one block
// per SM, whose phases are separated by grid-wide barriers. The TPU kernel's
// sequential (layers [+ head]) grid with a VMEM weight ring becomes a loop
// over layers inside every block. Per layer:
//   (a) every block recomputes LN1 of the (B, d) residual into shared memory
//       (tiny; saves a barrier), then blocks split the 3*H*D columns of wqkv:
//       each takes a balanced run of column units (a lane's vector: 16 bytes,
//       8 for int8; floor or ceil of units / grid), reads it from its shared-memory ring (staged, below),
//       and sums it in passes of 4 column vectors x 8 batch rows on a warp's
//       lanes, the warps splitting the rows; the (warp, row subgroup)
//       partials are added in one fixed order (deterministic), then the fp32
//       bias, one rounding. q goes to scratch, k/v into the cache at `pos`.
//   (b) attention, one unit per (row, head, key split): an fp32 online
//       softmax over [min(pad_b, pos), pos] (self) or [0, len_b) (cross);
//       eight lanes hold a key's 64 values, so a warp scores four keys per
//       load. Units write (max, sum, acc) partials; the next phase merges
//       them while it loads its input, so splitting the key range across
//       blocks costs no extra barrier.
//   (c) O projection + bias + residual, by column run.
//   (d) cross only: LN_c + q_c projection | cross attention | O_c + residual.
//   (e) LN2 + fc1 + bias + activation into (B, dff) scratch | fc2 + bias +
//       residual. GEGLU: fc1 writes the raw (B, 2*dff) pair (a + bias | g),
//       and the fc2 phase applies round(act(a)) * g while it loads its input,
//       as (b)'s partials are merged by (c): no extra barrier.
// Head: final LN; each block scores a contiguous vocab chunk (rounded to
// bf16 in bf16, as the logits of a bf16 head matmul would be) and keeps the
// best (value, lowest index) per row | block 0 reduces the blocks' bests with
// the same total order as csrc/greedy_head.cu.
//
// Staging. No weight, bias, column scale or norm parameter depends on the
// step's data, and `plan` fixes from the shapes alone which column run each
// block reads. So a block copies the next matvec phase's share of the
// weights (unit-major, ops/decode_step.py `_unit_major`: a run of units is
// contiguous), its bias and int8 scales and the next norm's parameters into
// shared memory with cp.async.bulk (the SM's copy engine: one instruction
// per contiguous run, completing on an mbarrier) while it waits at the grid
// barrier before that phase: it arrives, a producer warp issues the copies,
// then it waits. The matvec reads weights only from shared memory; the input
// load and the epilogue read only the data they depend on (the residual, q,
// the attention partials, the MLP hidden) from L2. A share larger than the
// ring streams through it in chunks of rows, each slot refilled as soon as
// it is read. The producer is not warp 0: thread 0 takes the grid barrier,
// and its memory fence would wait for copies it had issued. The L2 prefetch
// of earlier versions is gone: with the staging it cost time (PERF.md).
// All products run on CUDA cores with fp32 accumulation; tensor cores and
// fewer barriers (phases fused within clusters) are later work. Measured on
// an H100 80GB HBM3 (700 W; kernel_ab.py --k7, PERF.md), a matvec phase now
// costs 7-9 us (a 3-5 us input load and epilogue, 2-5 us of FMAs), down
// from 12-14, and a step still runs at ~8x its byte bound.
//
// Row groups (1 to 32 rows in one launch). A matvec pass puts 8 batch rows
// on a warp's lanes, and the phase input of 8 rows already fills ~100 KB of
// shared memory at GPT-2's K = dff = 3072 in fp32 (32 rows would need 394
// KB). So each matvec phase loops over groups of <= 8 rows: the group's
// input in xs, the pass over the block's staged share, the group's outputs.
// The share is staged once per phase and stays in the ring across the
// groups: above 8 rows the planner takes a plan only where every matrix's
// share fits the ring whole (it does at GPT-2 small, Whisper-base and
// T5-base in every dtype and weight variant), so the weights leave HBM once
// per step at any B and only the FMAs, the input loads and the epilogues
// scale with the groups. A share that would stream in K-chunks is refused
// above 8 rows (that batch decodes per-op) rather than re-read per group:
// chunks outer and groups inner would need every group's input or
// accumulators at once, which is later work. Where the batch's rows of a
// phase input fit xs at once (the norm inputs and the attention context, d
// and H*D wide; not the MLP hidden), they are loaded together, one chain of
// L2 round trips instead of one per group. The head keeps all B normed rows
// in xs and scores each vocab row against every row in registers (one
// instantiation per group count), so the head is read once too; lane l of a
// key group keeps the best (value, lowest index) of rows l, l + 8, ... A
// row's summation order does not depend on B or on its group: its lanes,
// the (warp, subgroup) partial order and the K split come from the block's
// share alone, and a norm row is one warp's. Its bits do depend on B through
// the attention split (split = grid / (B * H), 1 for GPT-2 small from B = 11
// on). A batch of one group runs its own instantiation, compiled without
// the multi-group paths, which keeps its register allocation (and its
// time, within 2-9%, PERF.md) that of the kernel before row groups.
//
// Data written inside the kernel (residual, q, partials, the MLP hidden, the
// cache slot at `pos`) is read back with ld.global.cg (L2, never a stale L1
// line); the cross cache takes the read-only path.
// This header is the kernel's interface: its constants, the launch arguments
// and the launch plan, and the two host entry points of each instantiation
// (T: compute dtype; W: weight element; MAXG: row groups served). Their
// definitions are in decode_step_kernel.cuh; each decode_step_<dtype>_<w>_g<MAXG>.cu
// compiles ONE instantiation, so `nvcc` builds the eight in parallel, and
// decode_step.cu dispatches to them.
#pragma once

#include <cstddef>

namespace pmt_k7 {

constexpr int NT = 512;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int GR = 8;        // rows per group: the batch rows of a matvec pass
constexpr int MB = 32;       // largest batch served (groups of GR rows)
constexpr int HEAD_D = 64;   // head dim served
constexpr int MAX_SPLIT = 16;
constexpr int MAX_SLOTS = 8;  // ring slots: cp.async groups of weights in flight per block
constexpr int N_MATS = 5;     // matrix shapes: qkv, o (and o_c), q_c, fc1, fc2
constexpr int BAR_BYTES = (MAX_SLOTS + 2) * 8;  // the ring's mbarriers and the two parameter barriers
// the warp that issues the copies: not warp 0, whose thread 0 takes the grid barrier (its memory fence would
// wait for the copies that thread had issued)
constexpr int PRODUCER = NW - 1;

// Must match ops/decode_step.py `_Args` field for field.
struct Args {
    const void* x;
    void* x_out;
    const void *wqkv, *bqkv, *wo, *bo, *w1, *b1, *w2, *b2;
    const void *ln1_s, *ln1_b, *ln2_s, *ln2_b;
    const void *wqc, *bqc, *woc, *boc, *lnc_s, *lnc_b;
    void *k_cache, *v_cache;
    const void* pads;
    const void *xk, *xv, *xlens;
    const void* sbias;  // key-major (l_max, n_heads) fp32 self bias, or null
    const void *emb, *fn_s, *fn_b;
    void* tok;
    void* workspace;
    void* stream;
    // int8 serving: per-output-column fp32 weight scales (L, N) of wqkv, wo, w1, w2, wqc, woc; the self and
    // cross caches' per-key fp32 scales (L, B, Lp|Lx); the a8 head's per-row scales (V); the embed phase's
    // tables (rows, d) and (B,) int32 ids
    const void *s_qkv, *s_o, *s_1, *s_2, *s_qc, *s_oc;
    void *ks, *vs;
    const void *xks, *xvs;
    const void* emb_s;
    const void *tok_emb, *pos_emb, *tok_ids, *pos_ids;
    int n_layers, b, d, hd, dff, n_heads, l_max, lx, pos, vocab, act, dtype, has_cross, has_head;
    int norm, gated;  // norm 0: LayerNorm, 1: RMSNorm; gated: GEGLU MLP
    int wt_int8, a8, kv_int8, kvx_int8, head_a8, embed, tok_rows, pos_rows;
    float eps, scale;
    // appended last, so every earlier field keeps its offset: null, or (phases, grid, 4) int64 %globaltimer
    // readings of each block at four points of every phase (after the barrier, after the input load, after the
    // matvec or attention, before arriving at the next barrier)
    long long* stamps;
};

// One matrix shape's staging: a block's share (a run of column units, WVec) goes through the shared-memory
// ring in steps of `kc` K rows by one pass of at most Plan::pass_cols columns; step i sits in slot i % slots.
struct MatPlan {
    int kc, slots, nchunk, slot_bytes;
    int steps;                                 // the most steps a block takes (passes x chunks)
};

struct Plan {
    int grid, split, pass_cols, par_cols;
    MatPlan m[N_MATS];
    size_t off_q, off_h, off_pm, off_pl, off_pacc, off_hv, off_hi, off_kn, off_vn, ws_bytes;
    // shared memory: xs (xs_floats) | red (red_bytes) | rsc (MB) | par (2 x (bias, scales), par_cols each) |
    // mbarriers (BAR_BYTES) | ring
    size_t smem, xs_floats, red_bytes, ring_bytes;
    int xs_stride;  // floats between xs rows: kmax + 4, so the rows of one column lie in different banks
    int hs_stride;  // the head's rows (all B of them): xs_stride up to GR rows, else d + 4
    int pln_off;    // the staged norm's scale and shift (2 d floats) in xs: past every normed row's d values
};

// The launch plan of one instantiation (0, or a CUDA error code) and its launch.
template <typename T, typename W, int MAXG>
int plan(const Args& a, Plan& p);
template <typename T, typename W, int MAXG>
int launch_groups(const Args& a);

}  // namespace pmt_k7
