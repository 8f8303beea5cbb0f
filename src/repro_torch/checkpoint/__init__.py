from .io import load_checkpoint, save_checkpoint  # noqa: F401
