from .pipeline import SyntheticLMData, TensorSpec, batch_specs  # noqa: F401
