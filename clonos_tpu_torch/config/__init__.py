"""Typed configuration (port of ``clonos_tpu/config``): option
descriptors, the ``Configuration`` map and the default keys that
``ClusterRunner.from_config`` reads."""

from clonos_tpu_torch.config.options import ConfigOption, Configuration
from clonos_tpu_torch.config import defaults

__all__ = ["ConfigOption", "Configuration", "defaults"]
