"""K5's share of its roofline: the least time the card could take for the
obj_interact encoder in training (two layers forward and backward on
each microbatch, ``work.py``) over the device time of K5's kernels per
traced step. The kernels are found by name: K5's GEMM, LayerNorm and
column-sum kernels (csrc/encoder_layer_train.cu) and the attention
kernels it launches (csrc/attention_tf32x3.cu, attention_mma.cu,
attention_train.cu), which nothing else launches in a train step."""

from benchmark.work import k5_work, least_seconds

K5_KERNELS = ("gemm_f32_kernel", "gemm_tc_kernel", "ln_fwd_kernel",
              "ln_bwd_kernel", "colsum_partial_kernel", "colsum_final_kernel",
              "splitk_sum_kernel", "fwd_kernel", "bwd_kv_kernel",
              "bwd_q_kernel", "bwd_dq_kernel", "delta_kernel", "pack_kernel")


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ns = sum(b - a for name, a, b in t.kernels if name in K5_KERNELS)
    if not ns:
        return None
    flops, n_bytes = k5_work(run.cell.model, run.work["batch"],
                             run.work["microbatches"], run.work["dtype"])
    least = least_seconds(flops, n_bytes, run.work["dtype"])
    return 100.0 * least / (ns / 1e9 / t.units)
