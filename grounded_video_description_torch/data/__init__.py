from grounded_video_description_torch.data.synthetic import synthetic_batch  # noqa: F401
