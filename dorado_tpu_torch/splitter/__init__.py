from dorado_tpu_torch.splitter.duplex_splitter import DuplexReadSplitter, DuplexSplitSettings
from dorado_tpu_torch.splitter.utils import Subread, detect_pore_signal

__all__ = ["DuplexReadSplitter", "DuplexSplitSettings", "Subread", "detect_pore_signal"]
