"""The MoE layers' share of their roofline: the least time the card could
take for the experts' work of the traced stretch over the device time of
its ``moe`` spans. A span's work (``work_lm.py``) is the router, its
``routed_rows`` token-expert pairs through a routed SwiGLU and every
token through the shared one at the bf16 peak, or the weights of its
``experts_active`` experts, the shared experts' and the tokens in and out
at the memory's rate, whichever is longer: the prefill's spans are
bound by the operations, the decode's by the bytes."""

from benchmark.spans import records
from benchmark.work_lm import count, least, moe_work


def read(run):
    b, dtype = run.cell.config["lm"], run.work["dtype"]
    k = b["num_experts_per_tok"]
    total_s = busy_ms = 0.0
    recs = records(run, "moe")
    for r in recs:
        routed, active = count(r, "routed_rows"), count(r, "experts_active")
        if routed is None or active is None or r.device_ms is None:
            return None
        total_s += least(*moe_work(b, routed // k, routed, active, dtype),
                         dtype)
        busy_ms += r.device_ms
    return 100.0 * total_s / (busy_ms / 1e3) if recs and busy_ms else None
