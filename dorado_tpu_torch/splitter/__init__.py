from dorado_tpu_torch.splitter.duplex_splitter import DuplexReadSplitter, DuplexSplitSettings
from dorado_tpu_torch.splitter.rna_splitter import RNAReadSplitter, RNASplitSettings
from dorado_tpu_torch.splitter.utils import Subread, detect_pore_signal

__all__ = ["DuplexReadSplitter", "DuplexSplitSettings", "RNAReadSplitter", "RNASplitSettings",
           "Subread", "detect_pore_signal"]
