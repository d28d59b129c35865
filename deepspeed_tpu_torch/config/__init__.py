from .config import Config, ConfigError

__all__ = ["Config", "ConfigError"]
