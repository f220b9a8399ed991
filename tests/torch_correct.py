"""Seeded read-correction inputs and a HERRO-contract TorchScript module
(``chip_smoke.py`` uses them too): reads of a random genome from both
strands with substitutions, deletions and insertions (``correct_reads``,
through ``torch_polish.polish_inputs``), and ``HerroContract``, a module
with the input and output contract of ONT's HERRO TorchScript models around
the port's ``CorrectionModel``."""

from __future__ import annotations

from typing import List

import torch

from tests.torch_polish import polish_inputs


def correct_reads(seed: int, genome_len: int, n_reads: int, read_len: tuple[int, int],
                  error: float = 0.08) -> list[tuple[str, str, str]]:
    """``n_reads`` reads (name, sequence, phred string) of ``read_len`` (low,
    high) bases of a seeded genome of ``genome_len`` bases at ``error``,
    each on a random strand."""
    return polish_inputs(seed, genome_len, n_reads, read_len, error=error)[2]


class HerroContract(torch.nn.Module):
    """(bases int32 [B, R, L], quals float32 [B, R, L], lengths int32 [B],
    indices: a list of B int32 tensors of supported columns) -> (the logits
    [B, L, 5], the logits at each window's supported columns, windows in
    order, [sum S, 5]): CorrectionInferenceNode.cpp:247-283's contract."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, bases: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor,
                indices: List[torch.Tensor]):
        logits = self.model.logits(bases, quals)
        picked = [logits[i][indices[i].long()] for i in range(len(indices))]
        return logits, torch.cat(picked, 0)
