"""Isolated TorchScript entry points (port of
``dorado_tpu/utils/torchscript.py``).

The reference ships opaque TorchScript blobs for polish models named
``model.pt`` (dorado/secondary/architectures/model_torch_script.h, loaded by
model_factory.cpp:186-201). Reading them requires ``torch.jit.load``; newer
torch releases deprecate the ``torch.jit`` namespace, so this module is the
one place in the package that touches it: it silences the deprecation
warnings and turns a future removal into one actionable error.
"""

from __future__ import annotations

import warnings


def load_torchscript(path, device="cpu"):
    """Load a TorchScript module from ``path`` onto ``device`` in eval mode.

    Raises RuntimeError if the installed torch has removed ``torch.jit.load``.
    """
    import torch

    jit = getattr(torch, "jit", None)
    load = getattr(jit, "load", None) if jit is not None else None
    if load is None:  # pragma: no cover - future torch versions
        raise RuntimeError(
            f"this torch build ({torch.__version__}) no longer provides "
            "torch.jit.load, which is required to read TorchScript model "
            f"blobs like {path!s}. Re-export the model weights as a state "
            "dict (weights.pt) for the port's GRUModel or LatentSpaceLSTM."
        )
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        warnings.filterwarnings("ignore", category=FutureWarning)
        module = load(str(path), map_location=device)
    module.eval()
    return module


def script_and_save(module, path):
    """Script ``module`` and save it to ``path`` (the tests' model.pt
    fixtures; the package itself never writes TorchScript)."""
    import torch

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        warnings.filterwarnings("ignore", category=FutureWarning)
        scripted = torch.jit.script(module)
        scripted.save(str(path))
    return scripted
