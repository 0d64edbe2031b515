from mapfree_tpu_torch.data.datamodule import DataModule
from mapfree_tpu_torch.data.loader import DataLoader, collate
from mapfree_tpu_torch.data.mapfree import ConcatDataset, MapFreeDataset, MapFreeScene
from mapfree_tpu_torch.data.sampler import RandomConcatSampler
from mapfree_tpu_torch.data.scannet import ScanNetDataset
from mapfree_tpu_torch.data.sevenscenes import SevenScenesDataset
