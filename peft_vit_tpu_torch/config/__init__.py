from .node import CfgNode
from .default import get_default_config, update_config

__all__ = ["CfgNode", "get_default_config", "update_config"]
