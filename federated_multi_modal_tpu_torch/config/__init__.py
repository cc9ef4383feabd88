from federated_multi_modal_tpu_torch.config.cfgnode import CfgNode
from federated_multi_modal_tpu_torch.config.defaults import get_cfg_default

__all__ = ["CfgNode", "get_cfg_default"]
