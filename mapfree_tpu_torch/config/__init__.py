from mapfree_tpu_torch.config.node import CfgNode, config_merge_from_file
from mapfree_tpu_torch.config.default import cfg

__all__ = ["CfgNode", "cfg", "config_merge_from_file"]
