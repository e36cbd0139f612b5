"""The 90th percentile of the window's batch latencies (call to host
arrays back), in a cell where it swings too much from run to run (with
two pageable copies a batch) to stand as an end-to-end metric under a
bound."""


def read(run):
    return run.window.get("p90_ms")
