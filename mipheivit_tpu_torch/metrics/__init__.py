from .cell import CellMetrics, LogRegHead, find_best_threshold
from .pixel import PixelMetrics, psnr, ssim, ssim_per_image

__all__ = ["CellMetrics", "LogRegHead", "PixelMetrics", "find_best_threshold", "psnr", "ssim",
           "ssim_per_image"]
