from .common import ModelConfig
from . import linear, transformer, attention, moe, mamba, rglru, layers
