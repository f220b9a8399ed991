"""Read records of a POD5 file: the run info and the per-read fields the
basecaller consumes. The POD5 reader itself (Arrow tables, VBZ signal) is not
part of this package yet, so callers build ``Pod5Read`` objects themselves.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RunInfo:
    acquisition_id: str = ""
    sample_rate: int = 0
    flow_cell_id: str = ""
    flow_cell_product_code: str = ""
    sequencing_kit: str = ""
    experiment_name: str = ""
    sample_id: str = ""
    protocol_run_id: str = ""
    acquisition_start_time_ms: int = 0
    sequencer_position: str = ""
    sequencer_position_type: str = ""
    system_name: str = ""
    software: str = ""
    context_tags: dict = field(default_factory=dict)
    tracking_id: dict = field(default_factory=dict)


@dataclass
class Pod5Read:
    read_id: str
    signal: np.ndarray  # int16
    read_number: int
    start_sample: int
    median_before: float
    channel: int
    well: int
    pore_type: str
    calibration_offset: float
    calibration_scale: float
    end_reason: str
    end_reason_forced: bool
    open_pore_level: float
    num_reads_since_mux_change: int
    time_since_mux_change: float
    num_minknow_events: int
    tracked_scaling_scale: float
    tracked_scaling_shift: float
    predicted_scaling_scale: float
    predicted_scaling_shift: float
    run_info: RunInfo
    filename: str = ""
