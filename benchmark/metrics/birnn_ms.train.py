"""Device ms per traced step inside the ``birnn`` spans (each BiGRU layer's
recurrence in the forward) and the ``birnn_bwd`` spans (the training
route's backward of it: the reverse-time kernel, dW_hh's product and
db_hh's sum). None without ``birnn`` spans (a program without them); a
step whose recurrence ran as the twin under autograd has no
``birnn_bwd`` span, and its backward is not counted."""

from benchmark.spans import device_ms


def read(run):
    forward = device_ms(run, "birnn")
    if forward is None:
        return None
    backward = device_ms(run, "birnn_bwd")
    return forward + (backward or 0.0)
