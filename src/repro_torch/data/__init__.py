from repro_torch.data.pipeline import DataLoader, input_specs, make_batch

__all__ = ["DataLoader", "input_specs", "make_batch"]
