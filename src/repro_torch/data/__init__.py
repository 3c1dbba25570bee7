from .pipeline import DataConfig, SyntheticLM, for_arch
