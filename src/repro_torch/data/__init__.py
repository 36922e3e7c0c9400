from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: F401
