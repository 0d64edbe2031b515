"""Dataset + loader dispatch (port of mapfree_tpu/data/datamodule.py;
reference lib/datasets/datamodules.py:11-70). ``device`` is where the
loaders' batches decode: nvJPEG on a CUDA device, cv2 or PIL on the CPU."""

from __future__ import annotations

import numpy as np

from mapfree_tpu_torch.data.loader import DataLoader
from mapfree_tpu_torch.data.mapfree import MapFreeDataset
from mapfree_tpu_torch.data.sampler import RandomConcatSampler
from mapfree_tpu_torch.data.scannet import ScanNetDataset
from mapfree_tpu_torch.data.sevenscenes import SevenScenesDataset
from mapfree_tpu_torch.data.io import color_jitter, grayscale3
from mapfree_tpu_torch.models.builder import resolve_device

DATASETS = {
    "ScanNet": ScanNetDataset,
    "7Scenes": SevenScenesDataset,
    "MapFree": MapFreeDataset,
}


class DataModule:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        assert cfg.DATASET.DATA_SOURCE in DATASETS, (
            "invalid DATA_SOURCE, this dataset is not implemented"
        )
        self.dataset_type = DATASETS[cfg.DATASET.DATA_SOURCE]

    def get_sampler(self, dataset, reset_epoch=False):
        if self.cfg.TRAINING.SAMPLER == "scene_balance":
            return RandomConcatSampler(
                dataset,
                self.cfg.TRAINING.N_SAMPLES_SCENE,
                self.cfg.TRAINING.SAMPLE_WITH_REPLACEMENT,
                shuffle=True,
                reset_on_iter=reset_epoch,
            )
        return None

    def _transforms(self):
        if bool(self.cfg.TPU.DEVICE_AUGMENT):
            # augmentation runs in the train step on the device
            # (data/augment.py), so the loader keeps the uint8 batch-decode
            # path (4x cheaper H2D)
            return None
        if self.cfg.DATASET.BLACK_WHITE:
            return grayscale3
        if self.cfg.DATASET.AUGMENTATION_TYPE == "colorjitter":
            return color_jitter(np.random.default_rng(0))
        return None

    def train_dataloader(self) -> DataLoader:
        dataset = self.dataset_type(self.cfg, "train", transforms=self._transforms(),
                                    device=self.device)
        if (bool(self.cfg.TPU.DEVICE_AUGMENT)
                and hasattr(dataset, "yuv420_getitems")):
            # the train step unpacks YUV on the device (augment/_to_float01), so
            # the loader can ship half the bytes; the source JPEGs are
            # already 4:2:0-subsampled so the extra loss is the resize
            # round trip only
            dataset.yuv420_getitems = bool(self.cfg.TPU.YUV420_TRANSFER)
        sampler = self.get_sampler(dataset)
        return DataLoader(
            dataset,
            batch_size=self.cfg.TRAINING.BATCH_SIZE,
            num_workers=self.cfg.TRAINING.NUM_WORKERS or 1,
            sampler=sampler,
            shuffle=sampler is None,
        )

    def val_dataloader(self) -> DataLoader:
        dataset = self.dataset_type(self.cfg, "val", device=self.device)
        # ScanNet uses a per-epoch-reset scene-balance sampler for val
        sampler = (
            self.get_sampler(dataset, reset_epoch=True)
            if isinstance(dataset, ScanNetDataset)
            else None
        )
        return DataLoader(
            dataset,
            batch_size=self.cfg.TRAINING.BATCH_SIZE,
            num_workers=self.cfg.TRAINING.NUM_WORKERS or 1,
            sampler=sampler,
            drop_last=True,
        )

    def test_dataloader(self, batch_size: int = 1,
                        unique_refs: bool = False) -> DataLoader:
        dataset = self.dataset_type(self.cfg, "test", device=self.device)
        return DataLoader(dataset, batch_size=batch_size, num_workers=1,
                          shuffle=False, unique_refs=unique_refs)
