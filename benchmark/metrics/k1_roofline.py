"""K1's share of its roofline: the least time the card could take for
the obj_interact encoder at inference (two layers on (B, R, rnn), its
operations at the dtype's peak or its bytes at the memory's, ``work.py``)
over the device time of K1's kernels per traced batch. The kernels are
found by name: K1's GEMM, LayerNorm and attention kernels
(csrc/encoder_layer.cu, and the attention forward it launches from
csrc/attention_tf32x3.cu or csrc/attention_mma.cu, which no other kernel
of the serving path launches)."""

from benchmark.work import k1_work, least_seconds

K1_KERNELS = ("gemm_tf32x3_kernel", "gemm_bf16_mma_kernel",
              "residual_ln_kernel", "attention_simt_kernel", "fwd_kernel",
              "pack_kernel")


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ns = sum(b - a for name, a, b in t.kernels if name in K1_KERNELS)
    if not ns:
        return None
    flops, n_bytes = k1_work(run.cell.model, run.work["batch"],
                             run.work["dtype"])
    least = least_seconds(flops, n_bytes, run.work["dtype"])
    return 100.0 * least / (ns / 1e9 / t.units)
