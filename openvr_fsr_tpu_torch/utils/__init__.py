from . import frames
from . import timing
from . import log
from . import trace

__all__ = ["frames", "timing", "log", "trace"]
