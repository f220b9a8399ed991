from dorado_tpu_torch.modbase.config import ModBaseModelConfig, load_modbase_config
from dorado_tpu_torch.modbase.motif import MotifMatcher

__all__ = ["ModBaseModelConfig", "load_modbase_config", "MotifMatcher"]
