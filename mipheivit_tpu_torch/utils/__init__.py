from .logging import MetricsLogger, save_image_grid

__all__ = ["MetricsLogger", "save_image_grid"]
