from . import frames
from . import timing
from . import log

__all__ = ["frames", "timing", "log"]
