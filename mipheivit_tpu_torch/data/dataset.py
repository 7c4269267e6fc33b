"""Datasets + DataModule (reference: src/dataset.py:21-455).

The port's copy of ``mipheivit_tpu/data/dataset.py``, on ``data.table.Table``
dataframes (no pandas) and the port's ``slideio``. Four dataset classes
with the reference's data contract:

  * ``TileDataset`` -- input-only tile files (+ optional nuclei) for
    inference (reference ``TileSlideDataset:139``),
  * ``TileImg2ImgDataset`` -- (image_path, target_path[, nuclei_path]) tile
    files (reference ``TileImg2ImgSlideDataset:218``),
  * ``SlideDataset`` -- input-only windows of an H&E WSI,
  * ``SlideImg2ImgDataset`` -- windows cut straight from pyramidal WSIs via
    the native slidetiff engine, with per-worker lazy handle caches and
    retry-on-fetch (reference ``Img2ImgNucleiSlideDataset:320``).

``__getitem__`` returns numpy HWC dicts; batching, prefetch and the
transfer to the card live in ``pipeline.py``. A ``preprocess_*_fn``
normalizes on the host, as the reference does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from ..slideio import SlideReader, read_image
from .augment import ColorAugment, SpatialAugment, get_augmentations
from .sampler import BalancedPositiveSampler
from .table import Table


def _prep(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype not in (np.uint8, np.float32):
        arr = np.float32(arr)
    return arr


class _Base:
    def __len__(self):
        return len(self.df)

    def reset(self):
        pass


class TileDataset(_Base):
    def __init__(self, dataframe: Table, channel_idxs=None,
                 preprocess_input_fn: Optional[Callable] = None,
                 spatial_augmentations: Optional[SpatialAugment] = None,
                 color_augmentations: Optional[ColorAugment] = None,
                 return_nuclei: bool = False):
        self.df = dataframe
        self.channel_idxs = channel_idxs
        self.preprocess_input_fn = preprocess_input_fn
        self.spatial = spatial_augmentations
        self.color = color_augmentations
        self.return_nuclei = return_nuclei

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        row = self.df.row(idx)
        image = _prep(read_image(row["image_path"], self.channel_idxs))
        out: Dict = {"tile_name": Path(row["image_path"]).stem}
        arrays = {"image": image}
        if self.return_nuclei:
            arrays["nuclei"] = read_image(row["nuclei_path"])[..., 0]
        if self.spatial:
            arrays = self.spatial(arrays, rng)
        if self.color:
            arrays["image"] = np.clip(
                self.color(arrays["image"], rng), 0, 255)
        if self.preprocess_input_fn:
            arrays["image"] = self.preprocess_input_fn(arrays["image"])
        out.update(arrays)
        if "in_slide_name" in row:
            out["slide_name"] = row["in_slide_name"]
        return out


class TileImg2ImgDataset(_Base):
    def __init__(self, dataframe: Table, in_channel_idxs=None, targ_channel_idxs=None,
                 preprocess_input_fn: Optional[Callable] = None,
                 preprocess_target_fn: Optional[Callable] = None,
                 spatial_augmentations: Optional[SpatialAugment] = None,
                 color_augmentations: Optional[ColorAugment] = None,
                 return_nuclei: bool = False):
        self.df = dataframe
        self.in_channel_idxs = in_channel_idxs
        self.targ_channel_idxs = targ_channel_idxs
        self.preprocess_input_fn = preprocess_input_fn
        self.preprocess_target_fn = preprocess_target_fn
        self.spatial = spatial_augmentations
        self.color = color_augmentations
        self.return_nuclei = return_nuclei

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        row = self.df.row(idx)
        image = _prep(read_image(row["image_path"], self.in_channel_idxs))
        target = _prep(read_image(row["target_path"], self.targ_channel_idxs))
        arrays = {"image": image, "image_target": target}
        if self.return_nuclei:
            arrays["nuclei"] = np.int32(read_image(row["nuclei_path"])[..., 0])
        if self.spatial:
            arrays = self.spatial(arrays, rng)
        if self.color:
            arrays["image"] = np.clip(self.color(arrays["image"], rng), 0, 255)
        if self.preprocess_input_fn:
            arrays["image"] = self.preprocess_input_fn(arrays["image"])
        if self.preprocess_target_fn:
            arrays["image_target"] = self.preprocess_target_fn(
                arrays["image_target"])
        out = {
            "image": arrays["image"],
            "target": arrays["image_target"],
            "tile_name": Path(row["image_path"]).stem,
        }
        if self.return_nuclei:
            out["nuclei"] = arrays["nuclei"]
        if "in_slide_name" in row:
            out["slide_name"] = row["in_slide_name"]
        return out


class SlideDataset(_Base):
    """Input-only windows straight from an H&E WSI (reference:
    slidevips-python/slidevips/torch_datasets.py:12-81 ``SlideDataset``,
    incl. the ``from_one_slide`` constructor for ad-hoc WSI inference)."""

    def __init__(self, slide_dataframe, dataframe,
                 in_channel_idxs=None, mode_in: str = "RGB",
                 preprocess_input_fn: Optional[Callable] = None,
                 spatial_augmentations: Optional[SpatialAugment] = None,
                 reiter_fetch: bool = False):
        self.df = dataframe
        self.in_paths = slide_dataframe.mapping("in_slide_name", "in_slide_path")
        self.in_channel_idxs = in_channel_idxs
        self.mode_in = mode_in
        self.preprocess_input_fn = preprocess_input_fn
        self.spatial = spatial_augmentations
        self.reiter_fetch = reiter_fetch
        self._in: Dict[str, SlideReader] = {}

    @classmethod
    def from_one_slide(cls, slide_path: str, tile_positions, tile_size: int,
                       level: int = 0, **kwargs):
        name = Path(slide_path).stem
        slide_df = Table.from_records([{"in_slide_name": name,
                                        "in_slide_path": slide_path}])
        tile_df = Table.from_records([
            {"in_slide_name": name, "x": int(x), "y": int(y), "level": level,
             "tile_size_x": tile_size, "tile_size_y": tile_size}
            for x, y in tile_positions])
        return cls(slide_df, tile_df, **kwargs)

    def reset(self):
        self._in.clear()

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        row = self.df.row(idx)
        name = row["in_slide_name"]
        location = (int(row["x"]), int(row["y"]))
        level = int(row["level"])
        size = (int(row["tile_size_x"]), int(row["tile_size_y"]))
        reader = self._in.get(name)
        if reader is None:
            reader = SlideReader(self.in_paths[name], self.in_channel_idxs,
                                 self.mode_in, self.reiter_fetch)
            self._in[name] = reader
        image = _prep(reader.read_region(location, level, size))
        if self.spatial:
            image = self.spatial({"image": image}, rng)["image"]
        if self.preprocess_input_fn:
            image = self.preprocess_input_fn(image)
        return {"image": image, "slide_name": name,
                "tile_name": "_".join(map(str, [name, *location, level, *size]))}


class SlideImg2ImgDataset(_Base):
    """Windows read directly from registered H&E/mIF/nuclei WSIs
    (reference ``Img2ImgNucleiSlideDataset``; tile rows carry
    x, y, level, tile_size_x, tile_size_y)."""

    def __init__(self, slide_dataframe, dataframe,
                 in_channel_idxs=None, targ_channel_idxs=None,
                 mode_in: str = "RGB", mode_targ: str = "IF",
                 preprocess_input_fn: Optional[Callable] = None,
                 preprocess_target_fn: Optional[Callable] = None,
                 spatial_augmentations: Optional[SpatialAugment] = None,
                 color_augmentations: Optional[ColorAugment] = None,
                 return_nuclei: bool = False, reiter_fetch: bool = False):
        missing = set(dataframe.unique("in_slide_name")) - set(
            slide_dataframe.unique("in_slide_name"))
        if missing:
            raise ValueError(f"tiles of slides missing from the slide dataframe: "
                             f"{sorted(missing)}")
        slide_dataframe = slide_dataframe.filter(np.isin(
            slide_dataframe["in_slide_name"], dataframe.unique("in_slide_name")))
        self.df = dataframe
        self.in_paths = slide_dataframe.mapping("in_slide_name", "in_slide_path")
        self.targ_paths = slide_dataframe.mapping("in_slide_name", "targ_slide_path")
        self.return_nuclei = return_nuclei
        if return_nuclei:
            self.nuclei_paths = slide_dataframe.mapping("in_slide_name", "nuclei_slide_path")
        self.in_channel_idxs = in_channel_idxs
        self.targ_channel_idxs = targ_channel_idxs
        self.mode_in = mode_in
        self.mode_targ = mode_targ
        self.preprocess_input_fn = preprocess_input_fn
        self.preprocess_target_fn = preprocess_target_fn
        self.spatial = spatial_augmentations
        self.color = color_augmentations
        self.reiter_fetch = reiter_fetch
        self._in: Dict[str, SlideReader] = {}
        self._targ: Dict[str, SlideReader] = {}
        self._nuclei: Dict[str, SlideReader] = {}

    def reset(self):
        self._in.clear()
        self._targ.clear()
        self._nuclei.clear()

    def _get(self, cache, paths, name, channel_idxs, mode):
        reader = cache.get(name)
        if reader is None:
            reader = SlideReader(paths[name], channel_idxs, mode,
                                 self.reiter_fetch)
            cache[name] = reader
        return reader

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        row = self.df.row(idx)
        name = row["in_slide_name"]
        location = (int(row["x"]), int(row["y"]))
        level = int(row["level"])
        size = (int(row["tile_size_x"]), int(row["tile_size_y"]))
        tile_name = "_".join(map(str, [name, *location, level, *size]))

        image = _prep(self._get(self._in, self.in_paths, name,
                                self.in_channel_idxs, self.mode_in)
                      .read_region(location, level, size))
        target = _prep(self._get(self._targ, self.targ_paths, name,
                                 self.targ_channel_idxs, self.mode_targ)
                       .read_region(location, level, size))
        arrays = {"image": image, "image_target": target}
        if self.return_nuclei:
            nuc = self._get(self._nuclei, self.nuclei_paths, name, [0], "IF") \
                .read_region(location, level, size)
            arrays["nuclei"] = np.int32(nuc[..., 0])
        if self.spatial:
            arrays = self.spatial(arrays, rng)
        if self.color:
            arrays["image"] = np.clip(self.color(arrays["image"], rng), 0, 255)
        if self.preprocess_input_fn:
            arrays["image"] = self.preprocess_input_fn(arrays["image"])
        if self.preprocess_target_fn:
            arrays["image_target"] = self.preprocess_target_fn(
                arrays["image_target"])
        out = {"image": arrays["image"], "target": arrays["image_target"],
               "tile_name": tile_name}
        if self.return_nuclei:
            out["slide_name"] = name
            out["nuclei"] = arrays["nuclei"]
            out["location"] = location
        return out


class DataModule:
    """Builds train/val/test datasets + loaders (reference: dataset.py:21-136).

    ``from_slide`` is inferred the reference way: the tile dataframe has no
    ``image_path`` column (src/train.py:47).
    """

    def __init__(self, slide_dataframe, train_dataframe, val_dataframe,
                 test_dataframe, targ_channel_idxs, batch_size: int,
                 input_shape, from_slide: bool = False,
                 return_nuclei: bool = False,
                 train_sampler: Optional[BalancedPositiveSampler] = None,
                 preprocess_input_fn=None, preprocess_target_fn=None,
                 num_workers: int = 4, seed: int = 0):
        self.slide_dataframe = slide_dataframe
        self.frames = {"train": train_dataframe, "val": val_dataframe,
                       "test": test_dataframe}
        self.targ_channel_idxs = targ_channel_idxs
        self.batch_size = batch_size
        self.input_shape = input_shape
        self.from_slide = from_slide
        self.return_nuclei = return_nuclei
        self.train_sampler = train_sampler
        self.preprocess_input_fn = preprocess_input_fn
        self.preprocess_target_fn = preprocess_target_fn
        self.num_workers = num_workers
        self.seed = seed
        self.datasets: Dict[str, _Base] = {}

    def setup(self):
        width, height = self.input_shape
        train_spatial, train_color = get_augmentations(width, height, True)
        eval_spatial, _ = get_augmentations(width, height, False)
        for split, df in self.frames.items():
            if df is None:
                continue
            training = split == "train"
            kwargs = dict(
                targ_channel_idxs=self.targ_channel_idxs,
                preprocess_input_fn=self.preprocess_input_fn,
                preprocess_target_fn=self.preprocess_target_fn,
                spatial_augmentations=train_spatial if training else eval_spatial,
                color_augmentations=train_color if training else None,
                return_nuclei=self.return_nuclei,
            )
            if self.from_slide:
                self.datasets[split] = SlideImg2ImgDataset(
                    self.slide_dataframe, df, mode_in="RGB", mode_targ="IF",
                    reiter_fetch=True, **kwargs)
            else:
                self.datasets[split] = TileImg2ImgDataset(df, **kwargs)

    def loader(self, split: str, shuffle: Optional[bool] = None,
               drop_last: Optional[bool] = None, epoch: int = 0):
        from .pipeline import Loader

        ds = self.datasets[split]
        training = split == "train"
        if shuffle is None:
            shuffle = training and self.train_sampler is None
        if drop_last is None:
            drop_last = training
        sampler = self.train_sampler if training else None
        return Loader(ds, self.batch_size, shuffle=shuffle,
                      drop_last=drop_last, sampler=sampler,
                      num_workers=self.num_workers,
                      seed=self.seed + epoch)
