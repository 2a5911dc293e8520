from .config import Config, InferParams, no_default
from .model import Model
from .cache import Cache, CacheSpec
