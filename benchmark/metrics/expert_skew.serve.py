"""How unevenly the router spreads the tokens: over the traced stretch's
``moe`` spans, the mean of each span's ``max_expert_rows`` (the rows of
its busiest expert) over its ``routed_rows`` / the experts (the rows of
each, were they spread evenly). 1 is even; the grouped GEMMs wait on the
busiest expert."""

from benchmark.spans import records
from benchmark.work_lm import count


def read(run):
    E = run.cell.config["lm"]["n_routed_experts"]
    ratios = []
    for r in records(run, "moe"):
        top, routed = count(r, "max_expert_rows"), count(r, "routed_rows")
        if top is None or not routed:
            return None
        ratios.append(top / (routed / E))
    return sum(ratios) / len(ratios) if ratios else None
