"""The latent attention's share of its roofline: the least time the card
could take for the attention of the traced stretch over the device time
of its ``mla`` spans. A span's work (``work_lm.py``) is, in the prefill
(``lm_prefill``'s spans), the projections, the expanded keys and values
and the causal scores and sums over its ``key_rows``; in the decode
(``lm_decode``'s), the projections, the absorbed halves of W_kvb and the
scores and context over the latent cache; its bytes the layer's
attention weights, the tokens in and out and the cache written
(prefill) or read (decode); operations at the bf16 peak or bytes at the
memory's rate, whichever is longer."""

from benchmark.spans import records
from benchmark.work_lm import count, least, mla_work


def _phase(r):
    while r is not None and r.name not in ("lm_prefill", "lm_decode"):
        r = r.parent
    return None if r is None else r.name


def read(run):
    b, dtype = run.cell.config["lm"], run.work["dtype"]
    total_s = busy_ms = 0.0
    recs = records(run, "mla")
    for r in recs:
        rows, keys, phase = count(r, "rows"), count(r, "key_rows"), _phase(r)
        if rows is None or keys is None or phase is None \
                or r.device_ms is None:
            return None
        total_s += least(*mla_work(b, rows, keys, phase == "lm_decode",
                                   dtype), dtype)
        busy_ms += r.device_ms
    return 100.0 * total_s / (busy_ms / 1e3) if recs and busy_ms else None
