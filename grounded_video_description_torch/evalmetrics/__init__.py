from grounded_video_description_torch.evalmetrics.cider import compute_cider  # noqa: F401
from grounded_video_description_torch.evalmetrics.bleu import compute_bleu  # noqa: F401
from grounded_video_description_torch.evalmetrics.meteor import compute_meteor  # noqa: F401
from grounded_video_description_torch.evalmetrics.densecap import DensecapEvaluator  # noqa: F401
from grounded_video_description_torch.evalmetrics.grounding import GroundingEvaluator  # noqa: F401
