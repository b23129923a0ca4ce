from repro_torch.optim.adamw import AdamW, AdamWConfig, AdamWState, cosine_schedule

__all__ = ["AdamW", "AdamWConfig", "AdamWState", "cosine_schedule"]
