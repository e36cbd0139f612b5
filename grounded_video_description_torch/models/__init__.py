from grounded_video_description_torch.models.gvd import (  # noqa: F401
    CoreState,
    GVDModel,
    batch_to_tensors,
)
