from .container import FMIndex  # noqa: F401
from .builder import build_index, load_index, save_index  # noqa: F401
