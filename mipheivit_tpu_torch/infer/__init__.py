from .loading import cast_params, load_generator, merge_lora, to_fast_heads
from .serve import MicroBatcher, TileServer, build_serving_fn
from .tiles import (inference_model, load_serving_model, predict_tiles, predictions_to_uint8,
                    resolve_device)
from .wsi import ArraySlide, wsi_inference

__all__ = ["ArraySlide", "MicroBatcher", "TileServer", "build_serving_fn", "cast_params",
           "inference_model", "load_generator", "load_serving_model", "merge_lora",
           "predict_tiles", "predictions_to_uint8", "resolve_device", "to_fast_heads",
           "wsi_inference"]
