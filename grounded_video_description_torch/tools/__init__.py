"""Tools of the port that run on the card: an overfit checkpoint at
flagship width (``overfit``) and the bf16 agreement of each inference
kernel at its weights (``kernel_delta``)."""
