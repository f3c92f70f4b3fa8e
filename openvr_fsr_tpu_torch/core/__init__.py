from .config import Config, load_config
from . import constants
from . import projection

__all__ = ["Config", "load_config", "constants", "projection"]
