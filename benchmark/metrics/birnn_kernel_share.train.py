"""The share of a traced step's BiGRU layers that K2's training route ran:
100 x the sum of the ``kernel`` counts of the stretch's ``birnn`` spans (1
where the route ran the layer's recurrence, 0 where the plain twin ran it
under autograd) over their number, in %. None where the program keeps no
such spans or they carry no ``kernel`` count (a program without the
route)."""

from benchmark.spans import records


def read(run):
    recs = records(run, "birnn")
    counts = [getattr(r, "counts", {}).get("kernel") for r in recs]
    if not recs or None in counts:
        return None
    return 100.0 * sum(counts) / len(counts)
