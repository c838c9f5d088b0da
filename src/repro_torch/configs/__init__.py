from .registry import ARCH_IDS, PORT_ARCH_IDS, all_configs, get_config
from .shapes import SHAPES, ShapeSuite, applicable
