from .base import HydraModel, ModelConfig, register_conv
from .create import create_model, model_config_from
