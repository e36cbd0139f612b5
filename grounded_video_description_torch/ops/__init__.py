MIN_VALUE = -1e8

from grounded_video_description_torch.ops.attention import (  # noqa: E402,F401
    grounder,
    region_attention,
    region_attention_beam,
    temporal_attention,
    temporal_attention_beam,
)
