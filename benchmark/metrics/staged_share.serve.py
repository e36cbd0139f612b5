"""The share of a traced batch's copies that went through the program's
pinned staging ring: the ``staged_nbytes`` of the stretch's ``h2d`` and
``d2h`` spans over their ``nbytes``, in %. None where the program's spans
carry no ``staged_nbytes`` (a program without the ring)."""

from benchmark.spans import records


def read(run):
    recs = records(run, "h2d") + records(run, "d2h")
    staged = [getattr(r, "staged_nbytes", None) for r in recs]
    if not recs or None in staged or any(r.nbytes is None for r in recs):
        return None
    total = sum(r.nbytes for r in recs)
    return 100.0 * sum(staged) / total if total else None
