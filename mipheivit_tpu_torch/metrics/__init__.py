from .pixel import PixelMetrics, psnr, ssim, ssim_per_image

__all__ = ["PixelMetrics", "psnr", "ssim", "ssim_per_image"]
